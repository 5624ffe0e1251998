"""Per-chain stage of the packed post-DP: the CUDA kernel's wrapper, its
plain version and its launch count.

For the [P*NF, PF] grid of a ``chain_block`` or ``chain_triangle`` call
(row p*NF + f = pair p, query fragment f) and the chain DP's roots, the
stage gives what the per-pair tail of ``ops/chain.py::_post_dp_block``
reads:

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

The kernel (``csrc/chain_post.cu``) replaces no TPU kernel: the JAX
package computes this stage with XLA ops (a per-row sort and segmented
scans).  Its bound is bytes: 24 B per valid grid cell (``w1``, ``w2``
int64, score f32, root int32) read once, plus the [P, NF] and [P, CE]
outputs.  It runs one block per pair, one warp per row, with the row's
chain bins in shared memory; the source says how that meets the bound.
:func:`chain_post_plain` is the stage in PyTorch, the CPU path and the
kernel's parity oracle: every output is integer (the score only enters
the keep rule), so the two are bit-equal.  :func:`chain_post` takes the
plain version for CPU tensors; for CUDA tensors it launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING

import torch

from ..utils import profiling
from . import _build

if TYPE_CHECKING:
    from .chain import ChainConfig

# the most anchors per fragment row the kernel takes: one warp's chain
# bins (24 B per column) fill most of an H100 block's shared memory
MAX_PF = 8192

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
