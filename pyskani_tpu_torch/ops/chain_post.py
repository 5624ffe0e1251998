"""The packed post-DP on the card: the per-chain stage and the per-pair
tail, each a CUDA kernel with its wrapper, its plain version and its
launch count.

For the [P*NF, PF] grid of a ``chain_block`` or ``chain_triangle`` call
(row p*NF + f = pair p, query fragment f) and the chain DP's roots, the
per-chain stage (:func:`chain_post`) gives what the per-pair tail reads:

* per row: ``numer`` (anchors of kept chains), ``span_lo`` / ``span_hi``
  (extended query span of the kept chains; ``POS_BIG`` / ``NEG_BIG``
  without one);
* per pair: ``n_chains`` (kept chains), ``ref_over`` (a kept anchor lies
  in a reference fragment >= NF), and the kept chain ends compacted in
  (row, root) order and cut at CE, as [P, CE] ``row_sel``,
  ``end_valid`` and the end words ``end_qmn``, ``end_qmx``, ``end_rmn``,
  ``end_rmx``, ``end_rcid``;
* ``numer_r`` [P, NF]: kept anchors counted by reference fragment (zero
  when ``cfg.est_side`` is ``"chunk"``).

A chain is the set of a row's anchors that share a root; it is kept if
it has ``min_anchors_chain`` anchors and (with ``min_chain_score`` > 0)
a best score of at least ``min_chain_score``, or (with ``keep_long_span``
> 0) at least two anchors spanning ``keep_long_span`` query bases.

The per-pair tail (:func:`chain_tail`) turns those into the pair's
estimates: span denominators on both genomes' fragment grids (the
reference spans cut into ``_REF_SPAN_PIECES`` pieces), fragment ANIs,
the pooled mean / 10-90% trimmed mean / median, and the aligned
fractions from the unions of the kept chain ends.  It reads each side's
per-genome tables (:class:`GenomeTables`), built once per call.

Neither kernel (``csrc/chain_post.cu``) replaces a TPU kernel: the JAX
package computes both stages with XLA ops.  The per-chain kernel's bound
is bytes: 24 B per valid grid cell (``w1``, ``w2`` int64, score f32,
root int32) read once, plus the [P, NF] and [P, CE] outputs; it runs one
block per pair, one warp per row, with the row's chain bins in shared
memory.  The tail kernel runs one block per pair over the stage's [P, NF]
and [P, CE] outputs, with its sorts in shared memory; the source says
how each meets its bound.  :func:`chain_post_plain` and
:func:`chain_tail_plain` are the stages in PyTorch, the CPU path and the
kernels' parity oracles.  The per-chain stage is integer, so its kernel
is bit-equal to the plain version; so are the tail's counts, flags and
aligned fractions, while its f32 means sum in another order.  Both
wrappers take the plain version for CPU tensors; for CUDA tensors
:func:`chain_post` launches its kernel or raises, and :func:`chain_tail`
launches its kernel where the pair's values fit its shared memory
(:func:`tail_fits`) and takes the plain version on the card otherwise.
"""

from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING, NamedTuple, Optional

import torch

from ..utils import profiling
from . import _build

if TYPE_CHECKING:
    from .chain import ChainConfig

# the most anchors per fragment row the kernel takes: one warp's chain
# bins (24 B per column) fill most of an H100 block's shared memory
MAX_PF = 8192

# the most values a pair pools (NF, or 2 NF with est_side "both") and the
# most kept chain ends (max_chains_per_pair) the tail kernel takes: its
# sorts and the reference spans live in shared memory (80 KB at the limit)
MAX_TAIL = 4096

KEYS = ("numer", "span_lo", "span_hi", "n_chains", "row_sel", "end_valid",
        "end_qmn", "end_qmx", "end_rmn", "end_rmx", "end_rcid", "numer_r",
        "ref_over")


def chain_post_plain(w1g, w2g, scores, roots, tail_r, r_frag_offs,
                     cfg: ChainConfig, *, NF: int, CE: int,
                     rcid_bits: int) -> dict:
    """The stage in PyTorch: per-chain statistics by scatter-reduce into
    [R, PF] bins keyed by chain root (the bins with anchors are the chain
    ends of the JAX per-row sort, in the same (row, root) order).  A cell
    is valid where bit 0 of ``w1g`` is set.  Returns the dict of
    :data:`KEYS`."""
    from .chain import _U32, NEG_BIG, POS_BIG, _bin_reduce
    from .sketch import I32_SENTINEL

    fl = cfg.fragment_length
    R, PF = w1g.shape
    P = R // NF
    dev = w1g.device
    i64 = torch.int64
    ext_l, ext_r = cfg.extend_left, cfg.extend_right
    rmask = (1 << rcid_bits) - 1
    Cr = r_frag_offs.shape[1] - 1

    # ---- per-chain statistics in [R, PF] bins keyed by chain root ----
    valid2 = (w1g & 1) == 1
    root2 = roots.to(i64).clamp(0, PF - 1)
    rows = torch.arange(R, device=dev, dtype=i64)[:, None]
    flat_bin = (rows * (PF + 1) + torch.where(valid2, root2, PF)).reshape(-1)
    nb = R * (PF + 1)

    def per_chain(values, reduce, init):
        return _bin_reduce(values, flat_bin, nb, reduce, init).view(
            R, PF + 1)[:, :PF]

    c_count = per_chain(valid2.to(i64), "sum", 0)
    c_qmn_w = per_chain(w1g, "amin", _U32)
    c_qmx_w = per_chain(w1g, "amax", 0)
    c_rmn_w = per_chain(w2g, "amin", _U32)
    c_rmx_w = per_chain(w2g, "amax", 0)
    c_score = per_chain(scores, "amax", float("-inf"))
    chain_end = c_count > 0
    c_qmn = c_qmn_w >> 2
    c_qmx = c_qmx_w >> 2
    keep = chain_end & (c_count >= cfg.min_anchors_chain)
    if cfg.min_chain_score > 0:
        keep &= c_score >= cfg.min_chain_score
    if cfg.keep_long_span > 0:
        keep |= chain_end & (c_count >= 2) & \
            ((c_qmx - c_qmn) >= cfg.keep_long_span)

    # ---- row-level aggregates ----
    numer = torch.where(keep, c_count, 0).sum(1)                   # [R]
    span_lo = torch.where(keep, c_qmn - ext_l, POS_BIG).amin(1)
    span_hi = torch.where(keep, c_qmx + ext_r, NEG_BIG).amax(1)

    # ---- kept chain ends, compacted per pair in (row, root) order ----
    keep_p = keep.view(P, NF * PF)
    n_chains = keep_p.sum(1, dtype=torch.int32)
    rank = torch.cumsum(keep_p.to(i64), 1) - keep_p.to(i64)
    p_idx, flat = torch.nonzero(keep_p & (rank < CE), as_tuple=True)
    slot = rank[p_idx, flat]
    row_sel = torch.zeros((P, CE), dtype=i64, device=dev)
    row_sel[p_idx, slot] = flat // PF
    end_valid = torch.zeros((P, CE), dtype=torch.bool, device=dev)
    end_valid[p_idx, slot] = True

    def ends(plane, fill):
        out = torch.full((P, CE), fill, dtype=plane.dtype, device=dev)
        out[p_idx, slot] = plane.reshape(P, NF * PF)[p_idx, flat]
        return out

    end_qmn = torch.where(end_valid, ends(c_qmn_w, 0) >> 2, I32_SENTINEL)
    end_qmx = torch.where(end_valid, ends(c_qmx_w, 0) >> 2, I32_SENTINEL)
    rmn_w = ends(c_rmn_w, 0)
    end_rmn = torch.where(end_valid, rmn_w >> rcid_bits, I32_SENTINEL)
    end_rmx = torch.where(end_valid, ends(c_rmx_w, 0) >> rcid_bits,
                          I32_SENTINEL)
    end_rcid = torch.where(end_valid, rmn_w & rmask, 0)

    pair_of_row = torch.arange(R, device=dev, dtype=i64) // NF
    if cfg.est_side == "both":
        # ---- ref-fragment numerators: kept anchors binned by ref frag ----
        keep_elem = keep.gather(1, root2) & valid2
        rcid_el = (w2g & rmask).clamp(0, Cr - 1)
        g_of = tail_r[pair_of_row]
        refrag = r_frag_offs[g_of[:, None], rcid_el] + (w2g >> rcid_bits) // fl
        ok_el = keep_elem & (refrag < NF)
        ref_over = (keep_elem & ~ok_el).view(P, NF * PF).any(1)
        tgt = torch.where(ok_el, pair_of_row[:, None] * NF + refrag, P * NF)
        numer_r = torch.zeros(P * NF + 1, dtype=i64, device=dev).index_add_(
            0, tgt.reshape(-1), ok_el.to(i64).reshape(-1))[:P * NF].view(P, NF)
    else:
        numer_r = torch.zeros((P, NF), dtype=i64, device=dev)
        ref_over = torch.zeros(P, dtype=torch.bool, device=dev)
    return dict(numer=numer, span_lo=span_lo, span_hi=span_hi,
                n_chains=n_chains, row_sel=row_sel, end_valid=end_valid,
                end_qmn=end_qmn, end_qmx=end_qmx, end_rmn=end_rmn,
                end_rmx=end_rmx, end_rcid=end_rcid, numer_r=numer_r,
                ref_over=ref_over)


def _lib() -> ctypes.CDLL:
    lib = _build.load("chain_post")
    if not getattr(lib, "_argtypes_set", False):
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        lib.chain_post_launch.argtypes = (
            [p] * 7 + [i] * 6 + [ll] * 5 + [i, f, i] + [p] * 13 + [p])
        lib.chain_post_launch.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def _check(w1g, w2g, scores, roots, row_bounds, tail_r, r_frag_offs,
           NF: int, CE: int, rcid_bits: int) -> None:
    if w1g.dim() != 2:
        raise ValueError("chain_post: grids must be [R, PF] tensors")
    R, PF = w1g.shape
    grid = dict(w1g=torch.int64, w2g=torch.int64, scores=torch.float32,
                roots=torch.int32)
    for (name, dtype), t in zip(grid.items(), (w1g, w2g, scores, roots)):
        if t.dtype != dtype or t.shape != (R, PF):
            raise ValueError(f"chain_post: {name} must be a {dtype} "
                             f"[{R}, {PF}] tensor, got {t.dtype} "
                             f"{list(t.shape)}")
    if not (NF > 0 and R % NF == 0):
        raise ValueError(f"chain_post: {R} grid rows are not whole pairs "
                         f"of NF = {NF} fragments")
    P = R // NF
    small = dict(row_bounds=(row_bounds, (R + 1,)), tail_r=(tail_r, (P,)))
    for name, (t, shape) in small.items():
        if t.dtype != torch.int64 or tuple(t.shape) != shape:
            raise ValueError(f"chain_post: {name} must be an int64 "
                             f"{list(shape)} tensor, got {t.dtype} "
                             f"{list(t.shape)}")
    if r_frag_offs.dtype != torch.int64 or r_frag_offs.dim() != 2 or \
            r_frag_offs.shape[1] < 2:
        raise ValueError("chain_post: r_frag_offs must be an int64 "
                         "[G_r, C+1] tensor")
    if PF > MAX_PF:
        raise ValueError(f"chain_post: max_anchors_per_fragment = {PF} "
                         f"exceeds the kernel's limit of {MAX_PF}")
    if CE < 0 or not 1 <= rcid_bits <= 31:
        raise ValueError(f"chain_post: max_chains_per_pair = {CE}, "
                         f"rcid_bits = {rcid_bits} out of range")


def chain_post(w1g, w2g, scores, roots, row_bounds, tail_r, r_frag_offs,
               cfg: ChainConfig, *, NF: int, CE: int,
               rcid_bits: int) -> dict:
    """The per-chain stage over a [P*NF, PF] grid -> the dict of
    :data:`KEYS`.

    ``w1g`` / ``w2g`` (int64) are the packed grid words, ``scores`` /
    ``roots`` the DP's outputs, ``row_bounds`` [R+1] the rows' anchor
    stream bounds (row r holds its first min(count, PF) anchors in its
    first columns, which are the valid ones), ``tail_r`` [P] each pair's
    reference index into ``r_frag_offs`` [G_r, Cr+1].  A valid anchor's
    root is a column at or before it in its row, as the DP gives.  CPU
    tensors take :func:`chain_post_plain`; CUDA tensors launch the kernel
    on their device's current stream (``chain_post.launches`` counts the
    launches; with profiling on, the ``post_kernel_pairs`` counter the
    pairs)."""
    ins = (w1g, w2g, scores, roots, row_bounds, tail_r, r_frag_offs)
    _check(*ins, NF, CE, rcid_bits)
    if all(t.device.type == "cpu" for t in ins):
        return chain_post_plain(w1g, w2g, scores, roots, tail_r,
                                r_frag_offs, cfg, NF=NF, CE=CE,
                                rcid_bits=rcid_bits)
    dev = w1g.device
    if dev.type != "cuda" or any(t.device != dev for t in ins):
        raise ValueError(f"chain_post: inputs must share one CUDA device "
                         f"or all lie on the CPU, got "
                         f"{[str(t.device) for t in ins]}")
    ins = [t.contiguous() for t in ins]
    R, PF = w1g.shape
    P = R // NF
    i64 = torch.int64
    pc = (P, CE)

    def empty(shape, dtype=i64):
        return torch.empty(shape, dtype=dtype, device=dev)

    # in KEYS order, the launcher's order of the output pointers
    out = dict(
        numer=empty(R), span_lo=empty(R), span_hi=empty(R),
        n_chains=empty(P, torch.int32), row_sel=empty(pc),
        end_valid=empty(pc, torch.bool), end_qmn=empty(pc),
        end_qmx=empty(pc), end_rmn=empty(pc), end_rmx=empty(pc),
        end_rcid=empty(pc),
        # zeroed: where its [NF] bins do not fit in shared memory, the
        # kernel adds into it
        numer_r=torch.zeros((P, NF), dtype=i64, device=dev),
        ref_over=empty(P, torch.bool))
    if P == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().chain_post_launch(
            *(t.data_ptr() for t in ins),
            P, NF, PF, CE, r_frag_offs.shape[1] - 1, rcid_bits,
            int(cfg.fragment_length), int(cfg.extend_left),
            int(cfg.extend_right), int(cfg.min_anchors_chain),
            int(cfg.keep_long_span), int(cfg.min_chain_score > 0),
            float(cfg.min_chain_score), int(cfg.est_side == "both"),
            *(t.data_ptr() for t in out.values()), stream)
    if err != 0:
        raise RuntimeError(f"chain_post kernel launch failed: CUDA error "
                           f"{err}")
    chain_post.launches += 1
    if profiling.enabled():
        profiling.stats().add("post_kernel_pairs", P)
    return out


chain_post.launches = 0


# ---------------------------------------------------------------- tail


class GenomeTables(NamedTuple):
    """One side's per-genome tables for the per-pair tail (row g = genome
    g of the side's stack), built once per call.  ``pos`` and ``pref`` may
    be None on the reference side when ``est_side`` is ``"chunk"``: only
    the aligned fraction reads that side then.  A fragment's contig is the
    last one whose fragment offset is at or before it (``_frag_contig``)."""

    starts: torch.Tensor                # int64 [G, C+1] contig starts
    frag_offs: torch.Tensor             # int64 [G, C+1] fragment offsets
    clens: torch.Tensor                 # int32 [G, C] contig lengths
    pos: Optional[torch.Tensor]         # int64 [G, S] sorted seed positions
    pref: Optional[torch.Tensor]        # int64 [G, S] eligible seeds up to
                                        # and including each
    total: torch.Tensor                 # int64 [G] genome length


def tail_fits(NF: int, CE: int, est_side: str) -> bool:
    """Whether a call's pairs fit the tail kernel's shared memory: the
    pooled values (NF, or 2 NF with ``est_side`` "both") and the kept
    chain ends, each at most :data:`MAX_TAIL`."""
    M = 2 * NF if est_side == "both" else NF
    return M <= MAX_TAIL and CE <= MAX_TAIL


def chain_tail_plain(st: dict, tail_r, tail_q, q: GenomeTables,
                     r: GenomeTables, cfg: ChainConfig, *, NF: int,
                     CE: int) -> dict:
    """The tail in PyTorch over the per-chain stage's outputs ``st`` (the
    dict of :data:`KEYS`): query-fragment denominators by a searchsorted
    into the query genome's seed positions, the reference spans and
    denominators, the pooled estimators, and the aligned fractions.
    Returns the estimator dict of ``ops/chain.py::_post_dp_block``."""
    from .chain import (_frag_ani, _frag_contig, _pooled_estimators,
                        _ref_spans, _searchsorted_rows, _union_length)

    fl = cfg.fragment_length
    P = tail_r.shape[0]
    dev = tail_r.device
    i64 = torch.int64
    ext_l, ext_r = cfg.extend_left, cfg.extend_right
    Cr = r.clens.shape[1]
    end_valid = st["end_valid"]
    frag_cid_g = _frag_contig(q.frag_offs, NF, q.clens.shape[1])

    frag_ids = torch.arange(NF, device=dev, dtype=i64)
    frag_base_g = (frag_ids[None, :] - q.frag_offs.gather(1, frag_cid_g)) * fl
    frag_clen_g = q.clens.to(i64).gather(1, frag_cid_g)
    frag_end_g = torch.minimum(frag_base_g + fl - 1, frag_clen_g - 1)
    qst_frag_g = q.starts.gather(1, frag_cid_g)

    lo = torch.maximum(st["span_lo"].view(P, NF), frag_base_g[tail_q])
    hi = torch.minimum(st["span_hi"].view(P, NF), frag_end_g[tail_q])
    g_lo = qst_frag_g[tail_q] + lo
    g_hi = qst_frag_g[tail_q] + hi
    # eligible seeds before each index: [G, S+1]
    before = lambda pref: torch.nn.functional.pad(pref, (1, 0))
    q_pref_p = before(q.pref)[tail_q]
    q_denom = (
        q_pref_p.gather(1, _searchsorted_rows(q.pos, tail_q, g_hi + 1)) -
        q_pref_p.gather(1, _searchsorted_rows(q.pos, tail_q, g_lo)))
    frag_ani_q, covered_q = _frag_ani(st["numer"].view(P, NF), q_denom, cfg)

    rcid_e = st["end_rcid"].clamp(0, Cr - 1)
    qcid_e = frag_cid_g[tail_q[:, None], st["row_sel"]]
    frag_overflow = st["ref_over"]
    if cfg.est_side == "both":
        span_lo_r, span_hi_r, span_over = _ref_spans(
            r.clens.to(i64)[tail_r], r.frag_offs[tail_r], end_valid,
            st["end_rmn"], st["end_rmx"], rcid_e, cfg, NF)
        frag_overflow = frag_overflow | span_over
        frag_cid_r = _frag_contig(r.frag_offs, NF, Cr)          # [G_r, NF]
        rst_frag_g = r.starts.gather(1, frag_cid_r)
        g_lo_r = rst_frag_g[tail_r] + span_lo_r
        g_hi_r = rst_frag_g[tail_r] + span_hi_r
        r_pref_p = before(r.pref)[tail_r]
        r_denom = (
            r_pref_p.gather(1, _searchsorted_rows(r.pos, tail_r, g_hi_r + 1)) -
            r_pref_p.gather(1, _searchsorted_rows(r.pos, tail_r, g_lo_r)))
        fa_r, covered_r = _frag_ani(st["numer_r"], r_denom, cfg)
        fa_all = torch.cat([frag_ani_q, fa_r], 1)
        cov_all = torch.cat([covered_q, covered_r], 1)
    else:
        fa_all, cov_all = frag_ani_q, covered_q
    out = _pooled_estimators(fa_all, cov_all, cfg)

    q_st = q.starts[tail_q]
    q_clens = q.clens.to(i64)[tail_q]
    r_st = r.starts[tail_r]
    r_clens = r.clens.to(i64)[tail_r]
    q_base = q_st.gather(1, qcid_e)
    q_lo = q_base + torch.clamp(st["end_qmn"] - ext_l, min=0)
    q_hi = q_base + torch.minimum(st["end_qmx"] + ext_r,
                                  q_clens.gather(1, qcid_e) - 1)
    r_base = r_st.gather(1, rcid_e)
    r_lo = r_base + torch.clamp(st["end_rmn"] - ext_l, min=0)
    r_hi = r_base + torch.minimum(st["end_rmx"] + ext_r,
                                  r_clens.gather(1, rcid_e) - 1)
    f32 = torch.float32
    out["af_query"] = _union_length(q_lo, q_hi, end_valid).to(f32) / \
        torch.clamp(q.total[tail_q].to(f32), min=1.0)
    out["af_ref"] = _union_length(r_lo, r_hi, end_valid).to(f32) / \
        torch.clamp(r.total[tail_r].to(f32), min=1.0)
    out["n_chains"] = st["n_chains"]
    out["frag_overflow"] = frag_overflow
    return out


def _check_tail(st: dict, tail_r, tail_q, q: GenomeTables,
                r: GenomeTables, cfg: ChainConfig, NF: int, CE: int) -> list:
    """Raise on what the tail kernel does not take; returns every input
    tensor."""
    def want(name, t, dtype, shape):
        if t is None or t.dtype != dtype or tuple(t.shape) != tuple(shape):
            got = "None" if t is None else f"{t.dtype} {list(t.shape)}"
            raise ValueError(f"chain_tail: {name} must be a {dtype} "
                             f"{list(shape)} tensor, got {got}")
        return t

    if tail_r.dim() != 1 or NF <= 0 or CE < 0:
        raise ValueError(f"chain_tail: tail_r must be a [P] tensor, NF > 0, "
                         f"CE >= 0; got {list(tail_r.shape)}, NF = {NF}, "
                         f"CE = {CE}")
    P = tail_r.shape[0]
    i64, b = torch.int64, torch.bool
    ins = [want("tail_r", tail_r, i64, (P,)), want("tail_q", tail_q, i64, (P,))]
    for k in ("numer", "span_lo", "span_hi"):
        ins.append(want(k, st[k], i64, (P * NF,)))
    ins.append(want("n_chains", st["n_chains"], torch.int32, (P,)))
    for k in ("row_sel", "end_qmn", "end_qmx", "end_rmn", "end_rmx",
              "end_rcid"):
        ins.append(want(k, st[k], i64, (P, CE)))
    ins.append(want("end_valid", st["end_valid"], b, (P, CE)))
    ins.append(want("numer_r", st["numer_r"], i64, (P, NF)))
    ins.append(want("ref_over", st["ref_over"], b, (P,)))
    denom_r = cfg.est_side == "both"
    for side, t in (("q", q), ("r", r)):
        G, C = t.clens.shape if t.clens.dim() == 2 else (-1, -1)
        ins.append(want(f"{side}.clens", t.clens, torch.int32, (G, C)))
        for k in ("starts", "frag_offs"):
            ins.append(want(f"{side}.{k}", getattr(t, k), i64, (G, C + 1)))
        ins.append(want(f"{side}.total", t.total, i64, (G,)))
        if side == "q" or denom_r:
            S = t.pos.shape[-1] if t.pos is not None else -1
            ins.append(want(f"{side}.pos", t.pos, i64, (G, S)))
            ins.append(want(f"{side}.pref", t.pref, i64, (G, S)))
    return ins


def _tail_lib() -> ctypes.CDLL:
    lib = _lib()
    if not getattr(lib, "_tail_argtypes_set", False):
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        side = [p] * 6 + [i, i]
        lib.chain_tail_launch.argtypes = (
            [p] * 15 + side + side + [i] * 4 + [ll] * 4 + [f] + [p] * 8 +
            [p])
        lib.chain_tail_launch.restype = ctypes.c_int
        lib._tail_argtypes_set = True
    return lib


def chain_tail(st: dict, tail_r, tail_q, q: GenomeTables, r: GenomeTables,
               cfg: ChainConfig, *, NF: int, CE: int) -> dict:
    """The per-pair tail of P pairs -> ``ani_mean``, ``ani_robust``,
    ``ani_median``, ``n_fragments`` (with ``cfg.est_ci`` also
    ``ani_ci_low`` / ``ani_ci_high``), ``af_query``, ``af_ref``,
    ``n_chains`` and ``frag_overflow`` (the stage's ``ref_over`` or a
    reference span piece past NF), each [P].

    ``st`` is :func:`chain_post`'s dict (its kept ends are the first
    min(n_chains, CE) slots of each pair), ``tail_r`` / ``tail_q`` [P]
    each pair's rows of ``r`` / ``q``.  CPU tensors take
    :func:`chain_tail_plain`, and so do CUDA tensors past
    :func:`tail_fits`; the others launch the kernel on their device's
    current stream (``chain_tail.launches`` counts the launches; with
    profiling on, the ``post_tail_pairs`` counter the pairs).  With
    ``cfg.est_ci`` the kernel also writes each pair's sorted values, and
    ``_bootstrap_ci`` draws on them as on the plain version's."""
    ins = _check_tail(st, tail_r, tail_q, q, r, cfg, NF, CE)
    P = tail_r.shape[0]
    args = (st, tail_r, tail_q, q, r, cfg)
    if all(t.device.type == "cpu" for t in ins):
        return chain_tail_plain(*args, NF=NF, CE=CE)
    dev = tail_r.device
    if dev.type != "cuda" or any(t.device != dev for t in ins):
        raise ValueError(f"chain_tail: inputs must share one CUDA device or "
                         f"all lie on the CPU, got "
                         f"{sorted({str(t.device) for t in ins})}")
    if P == 0 or not tail_fits(NF, CE, cfg.est_side):
        return chain_tail_plain(*args, NF=NF, CE=CE)
    from .chain import _bootstrap_ci

    both = cfg.est_side == "both"
    M = 2 * NF if both else NF
    f32 = torch.float32

    def empty(shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = dict(ani_mean=empty(P), ani_robust=empty(P), ani_median=empty(P),
               n_fragments=empty(P, torch.int32))
    held = []   # contiguous copies stay alive until the launch is queued

    def ptr(t):
        if t is None:
            return None
        held.append(t.contiguous())
        return held[-1].data_ptr()

    def side(t: GenomeTables):
        return [ptr(t.starts), ptr(t.frag_offs), ptr(t.clens), ptr(t.pos),
                ptr(t.pref), ptr(t.total), t.clens.shape[1],
                0 if t.pos is None else t.pos.shape[1]]

    af_query, af_ref = empty(P), empty(P)
    frag_overflow = empty(P, torch.bool)
    ranked = empty((P, M)) if cfg.est_ci else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _tail_lib().chain_tail_launch(
            *(ptr(st[k]) for k in ("numer", "span_lo", "span_hi",
                                   "n_chains", "row_sel", "end_valid",
                                   "end_qmn", "end_qmx", "end_rmn",
                                   "end_rmx", "end_rcid", "numer_r",
                                   "ref_over")),
            ptr(tail_r), ptr(tail_q), *side(q), *side(r),
            P, NF, CE, int(both), max(1, int(cfg.min_frag_anchors)),
            int(cfg.fragment_length), int(cfg.extend_left),
            int(cfg.extend_right), float(1.0 / float(cfg.k)),
            *(ptr(t) for t in (*out.values(), af_query, af_ref,
                               frag_overflow, ranked)), stream)
    if err != 0:
        raise RuntimeError(f"chain_tail kernel launch failed: CUDA error "
                           f"{err}")
    chain_tail.launches += 1
    if profiling.enabled():
        profiling.stats().add("post_tail_pairs", P)
    if cfg.est_ci:
        out["ani_ci_low"], out["ani_ci_high"] = _bootstrap_ci(
            ranked, out["n_fragments"], cfg.ci_iterations)
    out.update(af_query=af_query, af_ref=af_ref, n_chains=st["n_chains"],
               frag_overflow=frag_overflow)
    return out


chain_tail.launches = 0
