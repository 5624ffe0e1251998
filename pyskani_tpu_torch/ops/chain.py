"""Anchor chaining + ANI/AF estimation (PyTorch).

Port of the JAX package's ``ops/chain.py``: the block path
(``chain_block``), its all-vs-all form over one genome stack
(``chain_triangle``: a self-join in place of step 1, the rest shared),
and the full-range per-pair path (``chain_pairs``, which keeps
contig-local coordinates and takes what the packed block grid cannot
hold).  For G_r references x G_q queries, ``chain_block``:

1. ``_block_join``: every seed table goes into ONE stable sort by
   (kmer, tag); each query occurrence expands against its k-mer's whole
   reference run, which holds the matching occurrences of all reference
   genomes.  The expansion is a ``searchsorted`` over the run offsets.
2. The anchors are sorted by (row, ref contig, ref position, query
   position), rows = (pair, query fragment), and gathered into two packed
   [P*NF, PF] grid words.
3. The chain DP (``ops/chain_dp.py``: the CUDA kernel on the card).
4. ``_post_dp_block``: per-chain statistics in [rows, PF] bins keyed by
   chain root (``ops/chain_post.py``: a CUDA kernel on the card, in place
   of the JAX per-row sort + segmented scans, with the same values),
   then the per-pair tail (a second CUDA kernel on the card): span
   denominators on both genomes' fragment grids, the pooled mean /
   trimmed mean / median, and aligned fractions from interval unions of
   the kept chains.

Integer outputs equal the JAX package's bit for bit; f32 estimators and
aligned fractions agree within 1e-6 (summation order and ``pow`` may
differ in the last ulp).  One key departs from it: ``frag_overflow`` [P]
is set, on every path, for a pair that lost anchors or spans to a
fragment past ``max_fragments`` on either genome; the JAX package sets it
on ``chain_pairs`` for the query side only, so its packed paths and its
reference grids truncate a result silently.

With profiling on (``utils/profiling.py``), each path's stages are the
spans ``chain/join`` (the join), ``chain/grid`` (the anchor sorts and the
DP grid), ``chain/dp`` (the kernel launch) and ``chain/post`` (the
post-DP statistics), and each call of ``chain_block``, ``chain_triangle``
or ``chain_pairs`` adds 1 to the counter ``chain_calls``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils import profiling
from . import prng
from .chain_dp import chain_dp
from .chain_post import GenomeTables, chain_post, chain_tail
from .sketch import I32_SENTINEL, U32_SENTINEL, DeviceSketch

NEG_BIG = -(2**30)
POS_BIG = 2**30
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class ChainConfig:
    """All reconstruction dials of the chaining pipeline. [RECON]

    Copied field for field from the JAX package's
    ``oracle/chain.py::ChainConfig``; the numpy oracle itself is not
    ported."""

    k: int = 15                          # seed k-mer length (the 1/k ANI
                                         # exponent)
    fragment_length: int = 20_000
    max_gap_length: int = 2_500
    chain_band: int = 25
    anchor_score: float = 50.0
    gap_cost_scale: float = 0.1          # score -= gap * scale
    min_anchors_chain: int = 1           # chains smaller than this dropped
    min_chain_score: float = 105.0       # chains scoring below this dropped
    keep_long_span: int = 2_500          # additionally keep chains whose
                                         # query span >= this (0 = off)
    max_seed_multiplicity: int = 4       # k-mers with more occurrences skipped
    chain_scope: str = "fragment"        # "fragment" | "global"
    sort_by: str = "ref"                 # anchor sort order ("ref" | "query")
    extend_left: int = 0                 # extend intervals left by this many bp
    extend_right: int = 14               # extend intervals right by k-1 bp
    ani_cap: bool = True                 # cap per-fragment ratio at 1.0
    weighted_mean: bool = False          # weight fragment ANIs by seed count
    nonoverlap_side: str = "none"        # "ref" | "query" | "none"
    nonoverlap_frac: float = 0.5         # max allowed overlap fraction
    chunk_side: str = "query"            # side carrying the ANI fragments
    est_side: str = "both"               # "chunk" | "other" | "both": which
                                         # side's fragment grid carries the
                                         # ANI estimates ("both" pools them)
    chain_group_side: str = ""           # side whose fragments bound chains
                                         # ("" = same as chunk_side)
    denom_mode: str = "span"             # "fragment"|"covered"|"length"|"span"
    span_source: str = "kept"            # "kept" | "multi" | "all"
    span_extend: int = 0                 # extend each fragment's span
    numer_mode: str = "anchors"          # "anchors" | "distinct"
    min_frag_anchors: int = 1            # fragments with fewer anchors excluded
    min_span_cover: float = 0.0          # min kept-span cover of a fragment
    bridge_gap: int = 0                  # merge intervals separated by <= this
    mask_repetitive_denom: str = "own"   # "none" | "own" | "both"
    denom_mask_mult: int = 16            # multiplicity threshold for the
                                         # denominator mask (0 = anchors')
    est_ci: bool = False                 # bootstrap CI on the mean ANI
    ci_iterations: int = 100             # bootstrap resamples when est_ci


@dataclasses.dataclass(frozen=True)
class EngineBudgets:
    """Shape budgets for the pair pipeline."""

    max_anchors: int = 65536
    max_fragments: int = 384
    max_anchors_per_fragment: int = 512
    # kept chains per pair in the block tail; overflow is reported via the
    # n_chains output
    max_chains_per_pair: int = 2048


def _check_supported(cfg: ChainConfig):
    if cfg.chunk_side != "query" or (cfg.chain_group_side not in ("", "query")):
        raise NotImplementedError("engine implements query-side fragments")
    if cfg.nonoverlap_side != "none":
        raise NotImplementedError("engine implements nonoverlap_side='none'")
    if cfg.denom_mode != "span":
        raise NotImplementedError("engine implements the span denominator")
    if cfg.numer_mode != "anchors":
        raise NotImplementedError("engine implements anchors numerator")
    if cfg.sort_by != "ref":
        raise NotImplementedError("engine implements ref-sorted chaining")
    if cfg.chain_scope != "fragment":
        raise NotImplementedError("engine implements fragment-scoped chains")
    if cfg.bridge_gap != 0 or cfg.weighted_mean or not cfg.ani_cap:
        raise NotImplementedError
    if cfg.span_source != "kept" or cfg.span_extend != 0:
        raise NotImplementedError("engine implements kept-chain spans")
    if cfg.est_side not in ("chunk", "both"):
        raise NotImplementedError("engine implements chunk/both est_side")
    if cfg.min_span_cover != 0:
        raise NotImplementedError("engine implements min_span_cover=0")


def _contig_layout(sk: DeviceSketch, fl: int):
    """(contig_starts [.., C+1], frag_offsets [.., C+1]) in global
    coordinates (int64) for a single or stacked sketch."""
    clens = sk.contig_lengths.to(torch.int64)
    zero = torch.zeros(clens.shape[:-1] + (1,), dtype=torch.int64,
                       device=clens.device)
    starts = torch.cat([zero, torch.cumsum(clens, -1)], -1)
    slot = torch.arange(clens.shape[-1], device=clens.device)
    live = slot < sk.n_contigs.unsqueeze(-1)
    nfr = (clens + (fl - 1)) // fl * live
    frag_offs = torch.cat([zero, torch.cumsum(nfr, -1)], -1)
    return starts, frag_offs


def _frag_contig(frag_offs: torch.Tensor, NF: int, C: int) -> torch.Tensor:
    """[G, NF] contig id of every fragment slot (clipped to [0, C-1])."""
    frag_ids = torch.arange(NF, device=frag_offs.device, dtype=torch.int64)
    frag_ids = frag_ids.expand(frag_offs.shape[0], NF).contiguous()
    return (torch.searchsorted(frag_offs.contiguous(), frag_ids, right=True)
            - 1).clamp(0, C - 1)


def _searchsorted_rows(table: torch.Tensor, rows: torch.Tensor,
                       vals: torch.Tensor) -> torch.Tensor:
    """``searchsorted(table[rows[i]], vals[i], side='left')`` per row of
    ``vals`` [P, K]; ``table`` is [G, S] with ascending rows."""
    if table.shape[-1] == 0:  # a store of seed=False sketches
        return torch.zeros(vals.shape, dtype=torch.int64, device=vals.device)
    return torch.searchsorted(table[rows].contiguous(), vals.contiguous())


def _denom_prefix(sk: DeviceSketch, starts: torch.Tensor, cfg: ChainConfig):
    """(sorted global seed positions [G, S], denominator-eligible seeds up
    to and including each [G, S]) of a stacked sketch."""
    C = sk.contig_lengths.shape[-1]
    S = sk.seed_budget
    denom_thr = cfg.denom_mask_mult or cfg.max_seed_multiplicity
    slot = torch.arange(S, device=starts.device)
    p_valid = slot < sk.n_seeds.unsqueeze(-1)
    if cfg.mask_repetitive_denom == "none":
        p_ok = p_valid
    else:
        p_ok = p_valid & (sk.p_own_mult <= denom_thr)
    p_cid = sk.p_contig_ids.to(torch.int64).clamp(0, C - 1)
    p_gpos = torch.where(p_valid,
                         starts.gather(1, p_cid) + sk.p_positions, POS_BIG)
    return p_gpos, torch.cumsum(p_ok, 1)


def _interp_quantile(sorted_vals: torch.Tensor, n: torch.Tensor,
                     q: float) -> torch.Tensor:
    """Linear-interpolation quantile of the first n entries of each row
    (np.quantile); rows with n = 0 give an unused value."""
    M = sorted_vals.shape[-1]
    pos = q * (n.to(torch.float32) - 1.0)
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.minimum(lo + 1, n.to(torch.int64) - 1)
    w = pos - lo.to(torch.float32)
    v_lo = sorted_vals.gather(-1, lo.clamp(0, M - 1).unsqueeze(-1))[..., 0]
    v_hi = sorted_vals.gather(-1, hi.clamp(0, M - 1).unsqueeze(-1))[..., 0]
    return v_lo * (1 - w) + v_hi * w


# elements of one [rows, R, M] block of bootstrap index tables
CI_BLOCK = 1 << 27


def _bootstrap_ci(s: torch.Tensor, n_cov: torch.Tensor, R: int):
    """[5%, 95%] percentile-bootstrap interval of the mean of the first
    ``n_cov`` entries of each row of the sorted ``s`` [P, M]: R resamples
    of M indices drawn as the JAX package draws them
    (``randint(PRNGKey(1539), (R, M), 0, max(n_cov, 1))``, ``ops/prng.py``),
    the columns below ``n_cov`` summed in f32; 0 in rows with no covered
    entry.  Rows go in blocks of at most ``CI_BLOCK`` table elements."""
    P, M = s.shape
    f32, i64 = torch.float32, torch.int64
    high, low = prng.bootstrap_bits(R, M, s.device)
    span = torch.clamp(n_cov.to(i64), min=1)
    uncovered = torch.arange(M, device=s.device) >= n_cov.unsqueeze(-1)
    denom = torch.clamp(n_cov.to(f32), min=1.0)
    rows = max(1, CI_BLOCK // (R * M))
    boots = []
    for lo in range(0, P, rows):
        sl = slice(lo, lo + rows)
        idx = prng.randint_from_bits(high, low, span[sl].view(-1, 1, 1))
        vals = torch.gather(s[sl].unsqueeze(1).expand(-1, R, -1), 2, idx)
        del idx
        vals.masked_fill_(uncovered[sl].unsqueeze(1), 0.0)
        boots.append(vals.sum(-1) / denom[sl].unsqueeze(-1))
    boot_s = torch.sort(torch.cat(boots), -1).values
    n = torch.full((P,), R, dtype=torch.int32, device=s.device)
    no_cov = n_cov == 0
    return tuple(_interp_quantile(boot_s, n, q).masked_fill(no_cov, 0.0)
                 for q in (0.05, 0.95))


def _pooled_estimators(fa: torch.Tensor, covered: torch.Tensor,
                       cfg: ChainConfig):
    """mean / 10-90% trimmed mean / median (and, with ``cfg.est_ci``, the
    bootstrap interval) of the covered entries of each row of ``fa``
    [P, M] (+inf at uncovered slots)."""
    M = fa.shape[-1]
    f32 = torch.float32
    n_cov = covered.sum(-1, dtype=torch.int32)
    s = torch.sort(fa, -1).values
    zero = torch.zeros((), dtype=f32, device=fa.device)
    mean = torch.where(covered, fa, zero).sum(-1) / \
        torch.clamp(n_cov.to(f32), min=1.0)
    q10 = _interp_quantile(s, n_cov, 0.1)
    q90 = _interp_quantile(s, n_cov, 0.9)
    slot = torch.arange(M, device=fa.device)
    in_win = (s >= q10.unsqueeze(-1)) & (s <= q90.unsqueeze(-1)) & \
        (slot < n_cov.unsqueeze(-1))
    robust = torch.where(in_win, s, zero).sum(-1) / \
        torch.clamp(in_win.sum(-1).to(f32), min=1.0)
    mid_hi = (n_cov // 2).clamp(0, M - 1).to(torch.int64)
    mid_lo = torch.div(n_cov - 1, 2, rounding_mode="floor").clamp(
        0, M - 1).to(torch.int64)
    med = 0.5 * (s.gather(-1, mid_lo.unsqueeze(-1))[..., 0] +
                 s.gather(-1, mid_hi.unsqueeze(-1))[..., 0])
    no_cov = n_cov == 0
    out = dict(
        ani_mean=torch.where(no_cov, zero, mean),
        ani_robust=torch.where(no_cov, zero, robust),
        ani_median=torch.where(no_cov, zero, med),
        n_fragments=n_cov,
    )
    if cfg.est_ci:
        out["ani_ci_low"], out["ani_ci_high"] = _bootstrap_ci(
            s, n_cov, cfg.ci_iterations)
    return out


def _union_length(lo: torch.Tensor, hi: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """Per row, total length of the union of inclusive intervals
    [lo, hi] (global coordinates; intervals never span contigs)."""
    lo_s = torch.where(valid, lo, POS_BIG)
    hi_s = torch.where(valid, hi, NEG_BIG)
    lo_s, order = torch.sort(lo_s, -1)
    hi_s = hi_s.gather(-1, order)
    cmax = torch.cummax(hi_s, -1).values
    prev = torch.cat([torch.full_like(cmax[..., :1], NEG_BIG),
                      cmax[..., :-1]], -1)
    contrib = torch.clamp(hi_s - torch.maximum(lo_s - 1, prev), min=0)
    contrib = torch.where(hi_s == NEG_BIG, 0, contrib)
    return contrib.sum(-1)


_REF_SPAN_PIECES = 4  # a chain's ref interval can cross ref-fragment
                      # boundaries (chains are query-fragment scoped)


def _ref_spans(clens_r, r_fo, keep_f, rmn_f, rmx_f, rcid_f,
               cfg: ChainConfig, NF: int):
    """Kept-chain coverage spans over the REFERENCE fragment grid, per
    pair: all arguments are [P, ...].  Returns (span_lo, span_hi) [P, NF]
    in contig-local coordinates and ``dropped`` [P]: a span piece fell in
    a reference fragment >= NF, past the grid."""
    fl = cfg.fragment_length
    P = keep_f.shape[0]
    dev = keep_f.device
    lo = torch.clamp(rmn_f - cfg.extend_left, min=0)
    hi = torch.minimum(rmx_f + cfg.extend_right,
                       clens_r.gather(1, rcid_f) - 1)
    f0_local = lo // fl
    fo = r_fo.gather(1, rcid_f)
    span_lo = torch.full((P, NF + 1), I32_SENTINEL, dtype=torch.int64,
                         device=dev)
    span_hi = torch.full((P, NF + 1), NEG_BIG, dtype=torch.int64, device=dev)
    dropped = torch.zeros(P, dtype=torch.bool, device=dev)
    for j in range(_REF_SPAN_PIECES):
        base = (f0_local + j) * fl
        plo = torch.maximum(lo, base)
        phi = torch.minimum(hi, base + fl - 1)
        fj = fo + f0_local + j
        live = keep_f & (plo <= phi)
        okp = live & (fj < NF)
        dropped |= (live & ~okp).any(1)
        slot = torch.where(okp, fj, NF)
        span_lo.scatter_reduce_(1, slot, torch.where(okp, plo, I32_SENTINEL),
                                "amin", include_self=True)
        span_hi.scatter_reduce_(1, slot, torch.where(okp, phi, NEG_BIG),
                                "amax", include_self=True)
    return span_lo[:, :NF], span_hi[:, :NF], dropped


# The packed paths' limits: one call's DP grid holds MAX_GRID_ROWS rows
# (pairs * max_fragments); a query's total stays below MAX_PACKED_TOTAL, as
# its positions pack into 30 bits of w1 in genome-global coordinates.
MAX_GRID_ROWS = 1 << 17
MAX_PACKED_TOTAL = 1 << 30


def rcid_bits_for(C: int) -> int:
    """Bits of the packed block-grid word w2 allotted to the ref contig
    id, sized from the contig-table budget ``C`` (a power of two); the
    remaining ``32 - bits`` go to the in-contig position."""
    return max(1, (C - 1).bit_length())


def packed_cap(contig_budget: int) -> int:
    """Exclusive bound on a reference contig's length on the packed grid
    of a stack whose contig table is ``contig_budget`` wide."""
    return 1 << (32 - rcid_bits_for(contig_budget))


def fits_packed(longest: int, total: int, contig_budget: int) -> bool:
    """Whether a genome can take either side of a packed pair; one that
    cannot takes ``chain_pairs``."""
    return longest < packed_cap(contig_budget) and total < MAX_PACKED_TOTAL


def _count_call() -> None:
    """One call of a chain pipeline (``chain_block``, ``chain_triangle``
    or ``chain_pairs``) into the ``chain_calls`` counter."""
    if profiling.enabled():
        profiling.stats().add("chain_calls")


def grid_fits(pairs: int, max_fragments: int) -> bool:
    """Whether ``pairs`` pairs fit one packed call's DP grid."""
    return pairs * max_fragments <= MAX_GRID_ROWS


def _pack_grid_words(qpos, rpos, rcid, rev, rcid_bits: int):
    """Pack an anchor into two u32 grid words (held in int64):

      w1 = qpos << 2 | rev << 1 | valid          (qpos < 2^30)
      w2 = rpos << rcid_bits | rcid              (rpos < 2^(32-rcid_bits))

    Within a chain rev and rcid are constant, so min/max of the words
    recover the exact qpos/rpos extrema by shifting."""
    rmask = (1 << rcid_bits) - 1
    w1 = ((qpos << 2) | (rev.to(torch.int64) << 1) | 1) & _U32
    w2 = ((rpos << rcid_bits) | (rcid & rmask)) & _U32
    return w1, w2


def _dp_grid_from_words(w1g, w2g, rcid_bits: int) -> dict:
    """DP input planes (int32) from the packed grid words.  The meta keeps
    the kernel contract (chain-compatible = equal ``meta >> 1``, valid =
    bit 0): rcid<<3 | rev<<1 | valid; the query contig is constant within
    a grid row, so it is left out."""
    rmask = (1 << rcid_bits) - 1
    return {"qpos": (w1g >> 2).to(torch.int32),
            "rpos": (w2g >> rcid_bits).to(torch.int32),
            "meta": (((w2g & rmask) << 3) | (w1g & 3)).to(torch.int32)}


def _grid_from_sorted_stream(rowid_s, planes, R: int, PF: int):
    """[R, PF] grid planes from the rowid-sorted anchor stream: row r is
    the stream run [bounds[r], bounds[r+1]) cut to its first PF anchors.
    ``planes`` holds (stream values, fill of the empty cells) pairs.
    Returns ([R, PF] planes, row_bounds [R+1])."""
    dev = rowid_s.device
    A = rowid_s.shape[0]
    row_bounds = torch.searchsorted(
        rowid_s, torch.arange(R + 1, dtype=torch.int64, device=dev))
    if A == 0:
        return [torch.full((R, PF), fill, dtype=vals.dtype, device=dev)
                for vals, fill in planes], row_bounds
    starts_r = row_bounds[:-1]
    counts_r = row_bounds[1:] - starts_r
    cols = torch.arange(PF, dtype=torch.int64, device=dev)
    ok_g = cols[None, :] < torch.clamp(counts_r, max=PF)[:, None]
    idx = torch.clamp(starts_r[:, None] + cols[None, :], max=A - 1)
    return [torch.where(ok_g, vals[idx], fill) for vals, fill in planes], \
        row_bounds


def _bin_reduce(values, flat_bin, n_bins, reduce, init):
    out = torch.full((n_bins,), init, dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce_(0, flat_bin, values.reshape(-1), reduce,
                               include_self=True)


def _genome_tables(sk: DeviceSketch, starts, frag_offs, cfg: ChainConfig,
                   *, denom: bool = True) -> GenomeTables:
    """One side's per-genome tables for the per-pair tail; ``denom``
    builds the seed tables of its span denominators."""
    pos, pref = _denom_prefix(sk, starts, cfg) if denom else (None, None)
    return GenomeTables(starts, frag_offs, sk.contig_lengths, pos, pref,
                        sk.total_len)


def _post_dp_block(refs: DeviceSketch, queries: DeviceSketch,
                   w1g, w2g, scores, roots, row_bounds, q_starts,
                   q_frag_offs, cfg: ChainConfig, budgets: EngineBudgets,
                   tail_r, tail_q, r_starts, r_frag_offs,
                   rcid_bits: int) -> dict:
    """Per-chain statistics + estimators for a block of P pairs.

    ``tail_r``/``tail_q`` [P] map each pair slot to its genome index in
    ``refs``/``queries``.  The per-chain stage (``ops/chain_post.py``:
    the CUDA kernel on the card) bins chains by (row, root), keeps them,
    and compacts the kept chain ends into a [P, max_chains_per_pair]
    table; the per-pair tail (a second CUDA kernel on the card) takes the
    denominators, the estimators and the AF unions from them; overflow is
    reported in the ``n_chains`` output.  ``frag_overflow`` [P] is set
    where a kept anchor or a kept chain's span lies in a reference
    fragment >= NF, which the ref grid drops."""
    NF = budgets.max_fragments
    CE = budgets.max_chains_per_pair
    st = chain_post(w1g, w2g, scores, roots, row_bounds, tail_r, r_frag_offs,
                    cfg, NF=NF, CE=CE, rcid_bits=rcid_bits)
    q = _genome_tables(queries, q_starts, q_frag_offs, cfg)
    # a triangle group has one stack on both sides
    r = q if refs is queries else _genome_tables(
        refs, r_starts, r_frag_offs, cfg, denom=cfg.est_side == "both")
    return chain_tail(st, tail_r, tail_q, q, r, cfg, NF=NF, CE=CE)


def _frag_ani(numer, denom, cfg: ChainConfig):
    """(fragment ANI with +inf at uncovered slots, covered) from anchor
    numerators and seed denominators."""
    f32 = torch.float32
    covered = numer >= max(1, cfg.min_frag_anchors)
    ratio = torch.clamp(numer.to(f32) / torch.clamp(denom.to(f32), min=1.0),
                        max=1.0)
    inf = torch.tensor(float("inf"), dtype=f32, device=numer.device)
    return torch.where(covered, ratio ** (1.0 / float(cfg.k)), inf), covered


def _expand_runs(ok, rc, run_start, total: int):
    """The first ``total`` slots of a join's expansion, as (src, r_idx):
    slot t belongs to the ``ok`` entry whose run of ``rc`` slots covers
    it, and pairs that entry with the sorted entry ``run_start[src] + j``,
    j being t's rank inside the run."""
    src_ok = torch.nonzero(ok).flatten()
    cnt = rc[src_ok]
    cend = torch.cumsum(cnt, 0)
    t = torch.arange(total, device=rc.device, dtype=torch.int64)
    k = torch.searchsorted(cend, t, right=True)
    src = src_ok[k]
    return src, run_start[src] + t - (cend[k] - cnt[k])


def _pool_counts(ok, over, rc):
    """(anchors the ``ok`` entries expand to, anchors the ``over`` entries
    would expand to): one host read for the pool's size and the side
    expansion of the entries past the fragment budget."""
    return torch.stack([torch.where(ok, rc, 0).sum(),
                        torch.where(over, rc, 0).sum()]).tolist()


def _block_join(refs: DeviceSketch, queries: DeviceSketch, cfg: ChainConfig,
                total_anchors: int, q_frag_offs: torch.Tensor, NF: int):
    """Anchors for EVERY (ref genome, query genome) pair from ONE sort.

    The seed tables go into one stream tagged ref/query and sorted stably
    by (kmer, tag), so within a k-mer run all reference occurrences (of
    every reference genome) precede the query occurrences; each query
    occurrence expands against its run's reference prefix.  Seeds whose
    own multiplicity exceeds ``max_seed_multiplicity`` are masked up front
    (a k-mer's run length within one genome is its multiplicity there).

    A query seed whose fragment lies past NF still expands and takes
    pool slots, as in the JAX join, and its anchors are dropped here.
    Such seeds are expanded once more on the side, only to set
    ``frag_overflow`` [G_r * G_q] for the pairs they join.  Returns the
    valid anchors only, plus the join's counts and flags."""
    G_r, Sr = refs.kmers.shape
    G_q, Sq = queries.kmers.shape
    C = queries.contig_lengths.shape[1]
    fl = cfg.fragment_length
    cap = cfg.max_seed_multiplicity
    dev = refs.kmers.device
    i64 = torch.int64
    NR, NQ = G_r * Sr, G_q * Sq
    if not (NR < (1 << 30) and NQ < (1 << 30) and G_r < (1 << 15)):
        raise ValueError("block join: seed tables too large")
    n = NR + NQ

    r_kmers = torch.where(refs.own_mult <= cap, refs.kmers,
                          U32_SENTINEL).reshape(-1)
    q_kmers = torch.where(queries.own_mult <= cap, queries.kmers,
                          U32_SENTINEL).reshape(-1)
    # per-seed payload words:
    #   ref:   p1 = in-contig position, p2 = g<<15 | rcid<<1 | strand
    #   query: p1 = qpos<<1 | strand,   p2 = qi*NF + fragment
    #                                         (-1 - qi if fragment >= NF)
    g_id = torch.arange(NR, device=dev, dtype=i64) // Sr
    r_p1 = refs.positions.reshape(-1).to(i64)
    r_p2 = (g_id << 15) | (refs.contig_ids.reshape(-1).to(i64) << 1) | \
        refs.strands.reshape(-1).to(i64)
    qi_id = torch.arange(NQ, device=dev, dtype=i64) // Sq
    q_cid = queries.contig_ids.reshape(-1).to(i64).clamp(0, C - 1)
    q_pos = queries.positions.reshape(-1).to(i64)
    frag = q_frag_offs.reshape(-1)[qi_id * (C + 1) + q_cid] + q_pos // fl
    q_p1 = (q_pos << 1) | queries.strands.reshape(-1).to(i64)
    q_p2 = torch.where(frag < NF, qi_id * NF + frag, -1 - qi_id)

    kmer = torch.cat([r_kmers, q_kmers])
    tag_q = torch.arange(n, device=dev) >= NR
    order = torch.sort(kmer * 2 + tag_q.to(i64), stable=True).indices
    kmer_s = kmer[order]
    tag_s = tag_q[order]
    p1_s = torch.cat([r_p1, q_p1])[order]
    p2_s = torch.cat([r_p2, q_p2])[order]

    # k-mer runs: the start of every entry's run by a gather of the run
    # starts (the JAX package fills it with a running max)
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = kmer_s[1:] != kmer_s[:-1]
    run_start = torch.nonzero(first).flatten()[torch.cumsum(first, 0) - 1]
    # reference entries before me in my run (all of the run's reference
    # entries, since they sort before its query entries)
    is_ref = (~tag_s).to(i64)
    r_excl = torch.cumsum(is_ref, 0) - is_ref
    zero = torch.zeros((), dtype=i64, device=dev)
    rc = torch.where(tag_s, r_excl - r_excl[run_start], zero)
    ok = tag_s & (kmer_s != U32_SENTINEL) & (rc > 0)
    over = ok & (p2_s < 0)
    want, n_over = _pool_counts(ok, over, rc)
    total = min(want, total_anchors)
    src, r_idx = _expand_runs(ok, rc, run_start, total)

    q1, q2 = p1_s[src], p2_s[src]
    r1, r2 = p1_s[r_idx], p2_s[r_idx]
    valid = q2 >= 0
    g = r2 >> 15
    frag_over = torch.zeros(G_r * G_q, dtype=torch.bool, device=dev)
    if n_over:
        # pair g*G_q + qi, with qi = -1 - p2 of a seed past NF
        src_o, r_o = _expand_runs(over, rc, run_start, n_over)
        frag_over[(p2_s[r_o] >> 15) * G_q - 1 - p2_s[src_o]] = True
    return dict(
        qpos=(q1 >> 1)[valid],
        rowid=(g * (G_q * NF) + q2)[valid],
        rpos=r1[valid],
        rcid=((r2 >> 1) & 0x3FFF)[valid],
        rev=((q1 & 1) != (r2 & 1))[valid],
        n_anchors=total,
        anchors_overflow=want > total_anchors,
        frag_overflow=frag_over,
    )


def chain_block(refs: DeviceSketch, queries: DeviceSketch, *,
                cfg: ChainConfig, budgets: EngineBudgets,
                total_anchors: int | None = None) -> dict:
    """All-pairs [G_r x G_q] pipeline with ONE join sort and ONE DP.

    ``refs``/``queries`` are stacked sketches on one device.  All
    G_r*G_q*NF fragment rows go through the chain DP as lanes of one
    kernel launch.  Returns a dict of [G_r, G_q] tensors.

    ``total_anchors`` is the anchor budget of the WHOLE block (default:
    the per-pair budget times the number of pairs).  ``frag_overflow``
    flags the pairs that ``max_fragments`` truncated, on the query or the
    reference side (``engine.batch.check_overflow`` raises on it).
    """
    _check_supported(cfg)
    fl = cfg.fragment_length
    NF = budgets.max_fragments
    G_r = refs.kmers.shape[0]
    G_q = queries.kmers.shape[0]
    P = G_r * G_q
    if not grid_fits(P, NF):
        raise ValueError(f"block too large: pairs*max_fragments = {P * NF} "
                         f"exceeds 2^17 (shrink the block or fragments)")
    if total_anchors is None:
        total_anchors = P * budgets.max_anchors
    dev = refs.kmers.device
    _count_call()

    q_starts, q_frag_offs = _contig_layout(queries, fl)   # [G_q, C+1]
    with profiling.scope("chain/join", dev):
        a = _block_join(refs, queries, cfg, total_anchors, q_frag_offs, NF)
    pair_ids = torch.arange(P, device=dev, dtype=torch.int64)
    out = _chain_anchors(refs, queries, a, q_starts, q_frag_offs,
                         pair_ids // G_q, pair_ids % G_q, cfg, budgets)
    return {k: v.reshape((G_r, G_q) + v.shape[1:]) for k, v in out.items()}


def _chain_anchors(refs: DeviceSketch, queries: DeviceSketch, a: dict,
                   q_starts, q_frag_offs, tail_r, tail_q, cfg: ChainConfig,
                   budgets: EngineBudgets) -> dict:
    """The packed pipeline after a join: anchor sort, [P*NF, PF] grid,
    ONE chain-DP launch, post-DP statistics.  ``a`` holds the join's
    valid anchors (rowid = pair*NF + query fragment); pair p chains
    ``refs[tail_r[p]]`` against ``queries[tail_q[p]]``.  Returns a dict
    of [P] tensors; ``frag_overflow`` joins the join's query-side flag
    (``a["frag_overflow"]``) and the post-DP's reference-side one, so it
    means what it means on :func:`chain_pairs`."""
    fl = cfg.fragment_length
    NF = budgets.max_fragments
    PF = budgets.max_anchors_per_fragment
    P = tail_r.shape[0]
    C = queries.contig_lengths.shape[1]
    dev = refs.kmers.device
    i64 = torch.int64

    with profiling.scope("chain/grid", dev):
        # sort by (rowid<<14 | rcid, rpos, qpos<<2 | rev<<1 | 1): the tuple is
        # unique per anchor, so the order is total.  Two stable passes: the
        # payload first, then the (k1, k2) composite (k1, k2 < 2^31).
        k1 = (a["rowid"] << 14) | a["rcid"]
        payload = ((a["qpos"] << 2) | (a["rev"].to(i64) << 1) | 1) & _U32
        o1 = torch.sort(payload, stable=True).indices
        o2 = torch.sort(((k1 << 31) | a["rpos"])[o1], stable=True).indices
        order = o1[o2]
        k1_s = k1[order]
        payload_s = payload[order]
        rowid_s = k1_s >> 14
        rcid_s = k1_s & 0x3FFF
        rpos_s = a["rpos"][order]
        qpos_s = payload_s >> 2
        rev_s = (payload_s & 2) == 2

        frag_cid_tab = _frag_contig(q_frag_offs, NF, C)        # [G_q, NF]
        rbits = rcid_bits_for(refs.contig_lengths.shape[1])
        w1, w2 = _pack_grid_words(qpos_s, rpos_s, rcid_s, rev_s, rbits)
        # positions past the packed word ranges would corrupt results: ref
        # contigs past packed_cap, query contigs or totals past
        # MAX_PACKED_TOTAL (the rule that fits_packed states on the host)
        rcap = packed_cap(refs.contig_lengths.shape[1])
        pos_overflow = bool((rpos_s >= rcap).any()) or \
            bool((queries.contig_lengths.to(i64) >= MAX_PACKED_TOTAL).any()) \
            or bool((queries.total_len >= MAX_PACKED_TOTAL).any())
        R = P * NF
        (w1g, w2g), row_bounds = _grid_from_sorted_stream(
            rowid_s, ((w1, 0), (w2, 0)), R, PF)

        grid = _dp_grid_from_words(w1g, w2g, rbits)
    with profiling.scope("chain/dp", dev):
        scores, roots = chain_dp(grid["qpos"], grid["rpos"], grid["meta"],
                                 cfg)
    with profiling.scope("chain/post", dev):
        r_starts, r_frag_offs = (q_starts, q_frag_offs) if refs is queries \
            else _contig_layout(refs, fl)
        out = _post_dp_block(refs, queries, w1g, w2g, scores, roots,
                             row_bounds, q_starts, q_frag_offs, cfg, budgets,
                             tail_r, tail_q, r_starts, r_frag_offs, rbits)
    out["pos_overflow"] = torch.full((P,), pos_overflow, dtype=torch.bool,
                                     device=dev)
    bounds = row_bounds[torch.arange(P + 1, device=dev) * NF]
    out["n_anchors"] = (bounds[1:] - bounds[:-1]).to(torch.int32)
    out["anchors_overflow"] = torch.full(
        (P,), a["anchors_overflow"], dtype=torch.bool, device=dev)
    out["frag_overflow"] = a["frag_overflow"] | out["frag_overflow"]
    return out


def triu_pairs(G: int):
    """(ref_idx, query_idx) int32 arrays over the strict upper triangle,
    in the order :func:`chain_triangle` emits its [P] outputs (ref <
    query, row-major)."""
    ri, qi = np.triu_indices(G, k=1)
    return ri.astype("int32"), qi.astype("int32")


def _triangle_self_join(gs: DeviceSketch, cfg: ChainConfig,
                        total_anchors: int, q_frag_offs: torch.Tensor,
                        NF: int):
    """Anchors for EVERY unordered pair (i < j) of one genome stack from
    ONE self-join sort: each seed table enters the sort once.

    Every seed occurrence carries gcs = g<<15 | contig<<1 | strand, and
    one stable sort by ``kmer<<30 | gcs`` orders each k-mer run by genome
    (ties in seed-table order, as the JAX package's stable 2-key sort).
    An occurrence acting as the QUERY (genome j) expands against the run
    prefix of the genomes i < j: the references of all its upper-triangle
    pairs at once, and never itself.  The multiplicity cap is the
    own-multiplicity premask of ``_block_join``.

    Unlike ``_block_join``, an occurrence whose query fragment lies past
    NF takes no pool slots: it is dropped BEFORE the expansion is counted
    (the JAX join's ``ok`` tests it), so it counts toward neither the pool
    nor ``anchors_overflow``.  Such occurrences are expanded on the side,
    only to set ``frag_overflow`` [G*(G-1)/2] for the pairs they would
    have joined.  Anchors come out in (source, j) order, so a pool
    clipped at ``total_anchors`` keeps the JAX package's anchors.
    Returns the anchors (all valid) and the join's counts and flags."""
    G, S = gs.kmers.shape
    C = gs.contig_lengths.shape[1]
    fl = cfg.fragment_length
    cap = cfg.max_seed_multiplicity
    dev = gs.kmers.device
    i64 = torch.int64
    n = G * S
    if not (n < (1 << 30) and G < (1 << 15)):
        raise ValueError("triangle join: seed tables too large")

    kmer = torch.where(gs.own_mult <= cap, gs.kmers,
                       U32_SENTINEL).reshape(-1)
    g_id = torch.arange(n, device=dev, dtype=i64) // S
    cid = gs.contig_ids.reshape(-1).to(i64).clamp(0, C - 1)
    pos = gs.positions.reshape(-1).to(i64)
    gcs = (g_id << 15) | (cid << 1) | gs.strands.reshape(-1).to(i64)
    frag = q_frag_offs.reshape(-1)[g_id * (C + 1) + cid] + pos // fl
    fragw = torch.where(frag < NF, g_id * NF + frag, -1)

    # (kmer, gcs) in one int64: kmer (u32) in bits 61:30, gcs < 2^30
    order = torch.sort((kmer << 30) | gcs, stable=True).indices
    kmer_s, gcs_s, pos_s, fragw_s = (x[order] for x in (kmer, gcs, pos,
                                                        fragw))

    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = kmer_s[1:] != kmer_s[:-1]
    run_start = torch.nonzero(first).flatten()[torch.cumsum(first, 0) - 1]
    # first entry of MY genome's group inside the run: the entries before
    # it, back to the run start, belong to strictly smaller genomes
    gchg = first.clone()
    gchg[1:] |= (gcs_s[1:] >> 15) != (gcs_s[:-1] >> 15)
    gfirst = torch.nonzero(gchg).flatten()[torch.cumsum(gchg, 0) - 1]
    rc = gfirst - run_start
    joins = (kmer_s != U32_SENTINEL) & (rc > 0)
    ok = joins & (fragw_s >= 0)
    over = joins & (fragw_s < 0)
    want, n_over = _pool_counts(ok, over, rc)
    total = min(want, total_anchors)

    def pair_of(src, r_idx):
        # strict-upper-triangle pair index (ref = the smaller genome id)
        g_r, g_q = gcs_s[r_idx] >> 15, gcs_s[src] >> 15
        return g_r * G - (g_r * (g_r + 1)) // 2 + (g_q - g_r - 1), g_q

    src, r_idx = _expand_runs(ok, rc, run_start, total)
    tri, g_q = pair_of(src, r_idx)
    frag_over = torch.zeros((G * (G - 1)) // 2, dtype=torch.bool, device=dev)
    if n_over:
        tri_o, _ = pair_of(*_expand_runs(over, rc, run_start, n_over))
        frag_over[tri_o] = True
    qgcs, rgcs = gcs_s[src], gcs_s[r_idx]
    return dict(
        qpos=pos_s[src],
        rowid=tri * NF + fragw_s[src] - g_q * NF,
        rpos=pos_s[r_idx],
        rcid=(rgcs >> 1) & 0x3FFF,
        rev=(qgcs & 1) != (rgcs & 1),
        n_anchors=total,
        anchors_overflow=want > total_anchors,
        frag_overflow=frag_over,
    )


def chain_triangle(genomes: DeviceSketch, *, cfg: ChainConfig,
                   budgets: EngineBudgets,
                   total_anchors: int | None = None) -> dict:
    """All unordered pairs of a genome stack: ONE join sort, ONE DP.

    The self-join sorts each seed table once, and no lower-triangle or
    diagonal grid rows are built: pair p is
    ``(triu_pairs(G)[0][p], triu_pairs(G)[1][p])``, the smaller genome as
    the reference.  ``total_anchors`` is the anchor budget of the whole
    triangle (default: the per-pair budget times the pairs).  Returns a
    dict of [G*(G-1)/2] tensors with the keys of :func:`chain_block`."""
    _check_supported(cfg)
    NF = budgets.max_fragments
    G = genomes.kmers.shape[0]
    P = (G * (G - 1)) // 2
    if not grid_fits(P, NF):
        raise ValueError(f"triangle too large: pairs*max_fragments = "
                         f"{P * NF} exceeds 2^17 (split the genome set)")
    if total_anchors is None:
        total_anchors = P * budgets.max_anchors
    dev = genomes.kmers.device
    _count_call()

    q_starts, q_frag_offs = _contig_layout(genomes, cfg.fragment_length)
    with profiling.scope("chain/join", dev):
        a = _triangle_self_join(genomes, cfg, total_anchors, q_frag_offs,
                                NF)
    tri_r, tri_q = (torch.from_numpy(x).to(dev, torch.int64)
                    for x in triu_pairs(G))
    # every genome is a query, so the position checks cover them all
    return _chain_anchors(genomes, genomes, a, q_starts, q_frag_offs, tri_r,
                          tri_q, cfg, budgets)


# ---------------------------------------------------------------------------
# Full-range per-pair path: chain_pairs
# ---------------------------------------------------------------------------


def _take(sk: DeviceSketch, i: int) -> DeviceSketch:
    return sk.map(lambda x: x[i])


def _join_anchors(ref: DeviceSketch, query: DeviceSketch, cfg: ChainConfig,
                  budgets: EngineBudgets) -> dict:
    """Anchors of shared non-repetitive k-mers of one pair (valid ones
    only, at most ``max_anchors``).

    Both seed tables go into ONE sort by (kmer, tag, index); each query
    occurrence expands against its k-mer's reference run (a
    ``searchsorted`` over the run offsets, as in ``_block_join``).  The
    anchors come out in query-occurrence-major order, the JAX package's
    slot order."""
    Sq, Sr = query.seed_budget, ref.seed_budget
    if not (Sq < (1 << 30) and Sr < (1 << 30)):
        raise ValueError("pair join: seed tables too large")
    cap = cfg.max_seed_multiplicity
    dev = ref.kmers.device
    i64 = torch.int64
    n = Sr + Sq
    kmer = torch.cat([ref.kmers, query.kmers])
    ii = torch.arange(n, device=dev, dtype=i64)
    tag_q = ii >= Sr
    orig = torch.where(tag_q, ii - Sr, ii)
    # (kmer, tag, index) in one int64: kmer (u32) in bits 62:31, tag in
    # bit 30, index in bits 29:0; the keys are unique
    order = torch.sort((kmer << 31) | (tag_q.to(i64) << 30) | orig).indices
    kmer_s = kmer[order]
    tag_s = tag_q[order]
    orig_s = orig[order]

    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = kmer_s[1:] != kmer_s[:-1]
    run_start = torch.nonzero(first).flatten()[torch.cumsum(first, 0) - 1]
    # a query entry's reference run is [run_start, run_start + rc): the
    # run's reference entries sort before its query entries
    is_ref = (~tag_s).to(i64)
    r_excl = torch.cumsum(is_ref, 0) - is_ref
    zero = torch.zeros((), dtype=i64, device=dev)
    rc = torch.where(tag_s, r_excl - r_excl[run_start], zero)
    own_q = query.own_mult[orig_s.clamp(max=Sq - 1)]
    ok = tag_s & (kmer_s != U32_SENTINEL) & (own_q <= cap) & \
        (rc > 0) & (rc <= cap)
    want = int(rc[ok].sum())
    total = min(want, budgets.max_anchors)
    src, r_idx = _expand_runs(ok, rc, run_start, total)
    q_orig = orig_s[src]
    r_orig = orig_s[r_idx]
    return dict(
        qpos=query.positions[q_orig].to(i64),
        qcid=query.contig_ids[q_orig].to(i64),
        rpos=ref.positions[r_orig].to(i64),
        rcid=ref.contig_ids[r_orig].to(i64),
        rev=query.strands[q_orig] != ref.strands[r_orig],
        n_anchors=total,
        anchors_overflow=want > budgets.max_anchors,
    )


def _pre_dp(ref: DeviceSketch, query: DeviceSketch, cfg: ChainConfig,
            budgets: EngineBudgets):
    """Anchors -> sorted -> [NF, PF] int32 grid planes qpos / rpos / meta
    (meta = qcid<<17 | rcid<<3 | rev<<1 | valid; empty cells hold
    I32_SENTINEL, I32_SENTINEL, 0).  Returns (grid, n_anchors,
    anchors_overflow, frag_overflow)."""
    fl = cfg.fragment_length
    NF = budgets.max_fragments
    PF = budgets.max_anchors_per_fragment
    C = query.contig_lengths.shape[0]
    i32 = torch.int32
    dev = ref.kmers.device

    _, q_frag_offs = _contig_layout(query, fl)
    with profiling.scope("chain/join", dev):
        a = _join_anchors(ref, query, cfg, budgets)
    with profiling.scope("chain/grid", dev):
        frag = q_frag_offs[a["qcid"].clamp(0, C - 1)] + a["qpos"] // fl
        # anchors of fragments past the grid budget are dropped by the
        # grid build: check_overflow raises on it
        frag_overflow = bool((frag >= NF).any())

        # sort by (frag, rcid, rpos, qpos), unique per anchor: a stable
        # pass by the low pair (rpos, qpos < 2^31), then by the high
        # (rcid < 2^14).  Positions stay contig-local, so there is no
        # genome-total cap
        o1 = torch.sort((a["rpos"] << 31) | a["qpos"], stable=True).indices
        o2 = torch.sort(((frag << 14) | a["rcid"])[o1], stable=True).indices
        order = o1[o2]
        frag_s = frag[order]
        rcid_s = a["rcid"][order]
        rev_s = a["rev"][order].to(torch.int64)
        frag_cid_tab = _frag_contig(q_frag_offs[None], NF, C)[0]
        qcid_s = frag_cid_tab[frag_s.clamp(0, NF - 1)]
        meta = (qcid_s << 17) | (rcid_s << 3) | (rev_s << 1) | 1
        (qpos, rpos, meta), _ = _grid_from_sorted_stream(
            frag_s, ((a["qpos"][order].to(i32), I32_SENTINEL),
                     (a["rpos"][order].to(i32), I32_SENTINEL),
                     (meta.to(i32), 0)), NF, PF)
    grid = {"qpos": qpos, "rpos": rpos, "meta": meta}
    return grid, a["n_anchors"], a["anchors_overflow"], frag_overflow


def _union_length_seg(cid: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """Total length (f32) of the union of inclusive intervals [lo, hi],
    grouped by contig id (intervals never span contigs).

    Coordinates stay contig-local, so it is exact for genomes of any
    total length.  The sum is taken in int64 and rounded to f32 once; the
    JAX package sums in f32, which agrees below 2^24 bp of union and
    within one f32 rounding above."""
    cid, lo, hi = cid[valid], lo[valid], hi[valid]
    if cid.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=cid.device)
    # (contig, lo) order; the order among equal keys leaves the union as is
    order = torch.sort((cid << 32) + lo).indices
    cid_s, lo_s, hi_s = cid[order], lo[order], hi[order]
    # a running max of (cid<<32) + hi restarts at every contig, since
    # contig-local coordinates lie within (-2^31, 2^31)
    cmax = torch.cummax((cid_s << 32) + hi_s, 0).values - (cid_s << 32)
    first = torch.ones_like(cid_s, dtype=torch.bool)
    first[1:] = cid_s[1:] != cid_s[:-1]
    prev = torch.full_like(cmax, NEG_BIG)
    prev[1:] = torch.where(first[1:], NEG_BIG, cmax[:-1])
    contrib = torch.clamp(hi_s - torch.maximum(lo_s - 1, prev), min=0)
    contrib = torch.where(hi_s == NEG_BIG, 0, contrib)
    return contrib.sum().to(torch.float32)


def _denom_tables(sk: DeviceSketch, cfg: ChainConfig):
    """(position-view keys [S], eligible-seed prefix [S+1]) of one sketch.

    The keys are ``contig<<32 + position`` of the (contig, position)
    sorted seed view, ascending with the sentinel padding last, so one
    ``searchsorted`` finds a position inside a contig's segment (the JAX
    package bounds a binary search by per-contig segment offsets)."""
    S = sk.seed_budget
    denom_thr = cfg.denom_mask_mult or cfg.max_seed_multiplicity
    p_valid = torch.arange(S, device=sk.device) < sk.n_seeds.to(torch.int64)
    if cfg.mask_repetitive_denom == "none":
        p_ok = p_valid
    else:
        p_ok = p_valid & (sk.p_own_mult <= denom_thr)
    keys = (sk.p_contig_ids.to(torch.int64) << 32) + \
        sk.p_positions.to(torch.int64)
    prefix = torch.zeros(S + 1, dtype=torch.int64, device=sk.device)
    prefix[1:] = torch.cumsum(p_ok.to(torch.int64), 0)
    return keys, prefix


def _searchsorted_bounded(keys: torch.Tensor, cid: torch.Tensor,
                          vals: torch.Tensor) -> torch.Tensor:
    """Index of the first seed of contig ``cid`` with position >= ``vals``
    in the position view (its contig's segment end if none), per element.
    ``vals`` lie in [-2^31, 2^31]."""
    return torch.searchsorted(keys, (cid << 32) + vals)


def _count_seeds_in_spans(sk: DeviceSketch, keys: torch.Tensor,
                          prefix: torch.Tensor, cid: torch.Tensor,
                          lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Denominator-eligible seeds of contig ``cid`` with position in
    [lo, hi], per element (shapes broadcast together)."""
    cid_c = cid.to(torch.int64).clamp(0, sk.contig_lengths.shape[-1] - 1)
    cid_c, lo, hi = torch.broadcast_tensors(cid_c, lo, hi)
    i_lo = _searchsorted_bounded(keys, cid_c, lo)
    i_hi = _searchsorted_bounded(keys, cid_c, hi + 1)
    return prefix[i_hi] - prefix[i_lo]


def _ref_grid_estimates(ref: DeviceSketch, keep_f, rmn_f, rmx_f, rcid_f,
                        numer_r, cfg: ChainConfig, NF: int):
    """Fragment-ANI estimates over the REFERENCE fragment grid of one
    pair: kept chains' ref intervals (flat arrays) are split across ref
    fragments (``_ref_spans``), and each fragment's span denominator
    counts its contig's seeds inside.  Returns (frag_ani [NF], +inf at
    uncovered slots, covered [NF], whether a span piece fell past NF)."""
    fl = cfg.fragment_length
    Cr = ref.contig_lengths.shape[0]
    _, r_frag_offs = _contig_layout(ref, fl)
    span_lo, span_hi, dropped = _ref_spans(
        ref.contig_lengths.to(torch.int64)[None], r_frag_offs[None],
        keep_f[None], rmn_f[None], rmx_f[None],
        rcid_f.clamp(0, Cr - 1)[None], cfg, NF)
    keys, prefix = _denom_tables(ref, cfg)
    frag_cid = _frag_contig(r_frag_offs[None], NF, Cr)[0]
    denom = _count_seeds_in_spans(ref, keys, prefix, frag_cid, span_lo[0],
                                  span_hi[0])
    return (*_frag_ani(numer_r, denom, cfg), dropped[0])


def _post_dp(ref: DeviceSketch, query: DeviceSketch, grid: dict, scores,
             roots, cfg: ChainConfig, budgets: EngineBudgets) -> dict:
    """Chain statistics, estimators and aligned fractions of one pair.

    Per-chain statistics are scatter-reduces into [NF, PF+1] bins keyed
    by chain root (the JAX form).  Every coordinate stays contig-local:
    denominators count seeds by contig (``_count_seeds_in_spans``) and
    aligned fractions are per-contig interval unions, so genomes of any
    total length and contigs up to 2^31 bp are exact.  ``frag_overflow``
    is the reference side's: a kept anchor or span past the ref grid's
    NF fragments (``_pre_dp`` reports the query side's)."""
    fl = cfg.fragment_length
    NF = budgets.max_fragments
    PF = budgets.max_anchors_per_fragment
    C = query.contig_lengths.shape[0]
    Cr = ref.contig_lengths.shape[0]
    dev = scores.device
    i64 = torch.int64
    ext_l, ext_r = cfg.extend_left, cfg.extend_right

    _, q_frag_offs = _contig_layout(query, fl)
    meta = grid["meta"].to(i64)
    qpos = grid["qpos"].to(i64)
    rpos = grid["rpos"].to(i64)
    v = (meta & 1) == 1
    qcid_g = meta >> 17
    rcid_g = (meta >> 3) & 0x3FFF

    # ---- per-chain stats: [NF, PF] bins keyed by root (PF = no chain) ----
    rootc = torch.where(v, roots.to(i64), PF)
    rows = torch.arange(NF, device=dev, dtype=i64)[:, None]
    flat_bin = (rows * (PF + 1) + rootc).reshape(-1)
    nb = NF * (PF + 1)

    def per_chain(values, reduce, init):
        return _bin_reduce(values, flat_bin, nb, reduce, init).view(
            NF, PF + 1)[:, :PF]

    c_count = per_chain(v.to(i64), "sum", 0)
    c_score = per_chain(scores, "amax", float("-inf"))
    c_qmin = per_chain(qpos, "amin", I32_SENTINEL)
    c_qmax = per_chain(qpos, "amax", NEG_BIG)
    c_rmin = per_chain(rpos, "amin", I32_SENTINEL)
    c_rmax = per_chain(rpos, "amax", NEG_BIG)
    # all anchors of a chain share (qcid, rcid), both < 2^14
    c_qrcid = per_chain((qcid_g << 14) | rcid_g, "amin", I32_SENTINEL)

    keep = c_count >= cfg.min_anchors_chain
    if cfg.min_chain_score > 0:
        keep &= c_score >= cfg.min_chain_score
    if cfg.keep_long_span > 0:
        keep |= (c_count >= 2) & ((c_qmax - c_qmin) >= cfg.keep_long_span)
    keep &= c_count > 0

    # ---- per-fragment numerator / span denominator (query grid) ----
    numer = torch.where(keep, c_count, 0).sum(1)
    frag_ids = torch.arange(NF, device=dev, dtype=i64)
    frag_cid = _frag_contig(q_frag_offs[None], NF, C)[0]
    frag_base = (frag_ids - q_frag_offs[frag_cid]) * fl
    frag_clen = query.contig_lengths.to(i64)[frag_cid]
    frag_end = torch.minimum(frag_base + fl - 1, frag_clen - 1)
    span_lo = torch.where(keep, c_qmin - ext_l, I32_SENTINEL).amin(1)
    span_hi = torch.where(keep, c_qmax + ext_r, NEG_BIG).amax(1)
    span_lo = torch.maximum(span_lo, frag_base)
    span_hi = torch.minimum(span_hi, frag_end)
    keys_q, prefix_q = _denom_tables(query, cfg)
    denom = _count_seeds_in_spans(query, keys_q, prefix_q, frag_cid,
                                  span_lo, span_hi)
    frag_ani, covered = _frag_ani(numer, denom, cfg)

    # kept chains as flat arrays (the tail works on these only)
    kidx = torch.nonzero(keep.reshape(-1)).flatten()
    k_qmin, k_qmax = c_qmin.reshape(-1)[kidx], c_qmax.reshape(-1)[kidx]
    k_rmin, k_rmax = c_rmin.reshape(-1)[kidx], c_rmax.reshape(-1)[kidx]
    k_qrcid = c_qrcid.reshape(-1)[kidx]
    k_qcid = (k_qrcid >> 14).clamp(0, C - 1)
    k_rcid = (k_qrcid & 0x3FFF).clamp(0, Cr - 1)
    k_all = torch.ones_like(kidx, dtype=torch.bool)

    if cfg.est_side == "both":
        # ---- ref-side fragment grid (pooled with the query grid) ----
        _, r_frag_offs = _contig_layout(ref, fl)
        keep_a = keep.gather(1, rootc.clamp(max=PF - 1)) & v
        refrag = r_frag_offs[rcid_g.clamp(0, Cr - 1)] + \
            rpos.clamp(min=0) // fl
        ok_a = keep_a & (refrag < NF)
        numer_r = torch.zeros(NF + 1, dtype=i64, device=dev).index_add_(
            0, torch.where(ok_a, refrag, NF).reshape(-1),
            ok_a.to(i64).reshape(-1))[:NF]
        fa_r, cov_r, span_over = _ref_grid_estimates(
            ref, k_all, k_rmin, k_rmax, k_rcid, numer_r, cfg, NF)
        fa_all = torch.cat([frag_ani, fa_r])
        cov_all = torch.cat([covered, cov_r])
        ref_over = (keep_a & ~ok_a).any() | span_over
    else:
        fa_all, cov_all = frag_ani, covered
        ref_over = torch.zeros((), dtype=torch.bool, device=dev)
    out = {k: v_[0] for k, v_ in
           _pooled_estimators(fa_all[None], cov_all[None], cfg).items()}
    out["frag_overflow"] = ref_over

    # ---- aligned fractions: per-contig unions of the kept chains ----
    q_clens = query.contig_lengths.to(i64)
    r_clens = ref.contig_lengths.to(i64)
    q_lo = torch.clamp(k_qmin - ext_l, min=0)
    q_hi = torch.minimum(k_qmax + ext_r, q_clens[k_qcid] - 1)
    r_lo = torch.clamp(k_rmin - ext_l, min=0)
    r_hi = torch.minimum(k_rmax + ext_r, r_clens[k_rcid] - 1)
    # denominators: the summed contig lengths (padding rows are 0)
    f32 = torch.float32
    q_total = torch.clamp(q_clens.sum().to(f32), min=1.0)
    r_total = torch.clamp(r_clens.sum().to(f32), min=1.0)
    out["af_query"] = _union_length_seg(k_qcid, q_lo, q_hi, k_all) / q_total
    out["af_ref"] = _union_length_seg(k_rcid, r_lo, r_hi, k_all) / r_total
    return out


def chain_pairs(refs: DeviceSketch, queries: DeviceSketch, *,
                cfg: ChainConfig, budgets: EngineBudgets) -> dict:
    """Full-range pair pipeline over stacked sketches with leading axis B
    (pair i = refs[i] vs queries[i]).

    Pre-DP (join, sort, grid) and post-DP run per pair; the DP runs ONCE
    on the merged [B*NF, PF] grid.  Coordinates stay contig-local int32
    planes, so this path has none of the packed block-grid caps: contigs
    up to 2^31 bp on either side and genomes of any total length.
    Returns a dict of [B] tensors."""
    _check_supported(cfg)
    NF = budgets.max_fragments
    B = refs.kmers.shape[0]
    dev = refs.kmers.device
    _count_call()
    pre = [_pre_dp(_take(refs, i), _take(queries, i), cfg, budgets)
           for i in range(B)]
    merged = {key: torch.cat([p[0][key] for p in pre])
              for key in ("qpos", "rpos", "meta")}
    n_anchors = [p[1] for p in pre]
    anchors_overflow = [p[2] for p in pre]
    frag_overflow = [p[3] for p in pre]
    del pre
    with profiling.scope("chain/dp", dev):
        scores, roots = chain_dp(merged["qpos"], merged["rpos"],
                                 merged["meta"], cfg)
    outs = []
    for i in range(B):
        rows = slice(i * NF, (i + 1) * NF)
        with profiling.scope("chain/post", dev):
            outs.append(_post_dp(_take(refs, i), _take(queries, i),
                                 {k: g[rows] for k, g in merged.items()},
                                 scores[rows], roots[rows], cfg, budgets))
    out = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
    out["n_anchors"] = torch.tensor(n_anchors, dtype=torch.int32, device=dev)
    out["anchors_overflow"] = torch.tensor(anchors_overflow, device=dev)
    # the query side's (the grid build dropped anchors) or the reference
    # side's (the post-DP dropped kept anchors or spans)
    out["frag_overflow"] = torch.tensor(frag_overflow, device=dev) | \
        out["frag_overflow"]
    return out


def chain_pair(ref: DeviceSketch, query: DeviceSketch, *, cfg: ChainConfig,
               budgets: EngineBudgets) -> dict:
    """One pair through :func:`chain_pairs`: a dict of scalars."""
    out = chain_pairs(ref.map(lambda x: x[None]), query.map(lambda x: x[None]),
                      cfg=cfg, budgets=budgets)
    return {k: v[0] for k, v in out.items()}
