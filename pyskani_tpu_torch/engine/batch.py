"""Batched pair engine over stacked sketch tensors.

Port of the JAX package's ``engine/batch.py``: sketches are padded to
common budgets and stacked on a leading axis.  ``one_vs_many`` chains a
query against chunks of the stack, one ``chain_block`` per chunk;
``one_vs_many_pairs`` and ``pairs_ani`` run one ``chain_pairs`` per
chunk; ``triangle`` is the all-vs-all mode (``chain_triangle`` per
genome group, ``chain_block`` tiles across groups, ``pairs_ani`` for
genomes past the packed range).  Python loops stand where JAX used
``lax.map``.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import List, Sequence

import numpy as np
import torch

from ..ops.chain import (MAX_GRID_ROWS, ChainConfig, EngineBudgets,
                         chain_block, chain_pairs, chain_triangle,
                         fits_packed, grid_fits)
from ..ops.sketch import (FIELDS, I32_SENTINEL, U32_SENTINEL, DeviceSketch,
                          HostSketch, contig_budget_for, pad_to,
                          round_up)
from ..utils import profiling

# padding of each per-seed / per-marker field
_SEED_FILL = dict(kmers=U32_SENTINEL, positions=I32_SENTINEL,
                  contig_ids=I32_SENTINEL, strands=False, own_mult=0,
                  p_positions=I32_SENTINEL, p_contig_ids=I32_SENTINEL,
                  p_own_mult=0)
_MARKER_FILL = dict(markers_hi=U32_SENTINEL, markers_lo=U32_SENTINEL)


def repad_sketch(host: HostSketch, seed_budget: int, marker_budget: int,
                 max_contigs: int | None = None) -> DeviceSketch:
    """Re-pad a sketch's tensors to common budgets (on its device; on the
    CPU it is the JAX package's ``_repad_host``).  ``max_contigs=None``
    keeps the sketch's own contig-table size."""
    dev = host.device
    n, m, nc = int(dev.n_seeds), int(dev.n_markers), int(dev.n_contigs)
    if max_contigs is None:
        max_contigs = dev.contig_lengths.shape[0]
    if n > seed_budget or m > marker_budget:
        raise ValueError(f"sketch {host.name} exceeds budgets "
                         f"({n}>{seed_budget} or {m}>{marker_budget})")
    if nc > max_contigs:
        raise ValueError(f"sketch {host.name} has {nc} contigs, more than "
                         f"the max_contigs={max_contigs} budget")
    fields = {}
    for name in FIELDS:
        t = getattr(dev, name)
        if name in _SEED_FILL:
            fields[name] = pad_to(t[:n], seed_budget, _SEED_FILL[name])
        elif name in _MARKER_FILL:
            fields[name] = pad_to(t[:m], marker_budget, _MARKER_FILL[name])
        elif name == "contig_lengths":
            fields[name] = pad_to(t, max_contigs, 0)
        else:
            fields[name] = t
    return DeviceSketch(**fields)


def stack_buckets(sketches: Sequence[HostSketch], seed_step: int = 1024):
    """(seed, marker, contig) budgets that hold every sketch of
    ``sketches``: the largest counts, read in one copy, rounded up to
    ``seed_step`` and 512, and the largest contig-table bucket."""
    counts = torch.stack([torch.stack([s.device.n_seeds, s.device.n_markers,
                                       s.device.n_contigs])
                          for s in sketches]).cpu()
    return (round_up(int(counts[:, 0].max()), seed_step),
            round_up(int(counts[:, 1].max()), 512),
            max(contig_budget_for(int(c)) for c in counts[:, 2]))


def _stack(sketches: Sequence[HostSketch], seed_budget, marker_budget,
           contig_budget, pin: bool = False) -> DeviceSketch:
    sb, mb, cb = stack_buckets(sketches)
    padded = [repad_sketch(s, sb if seed_budget is None else seed_budget,
                           mb if marker_budget is None else marker_budget,
                           cb if contig_budget is None else contig_budget)
              for s in sketches]
    fields = {}
    for f in FIELDS:
        parts = [getattr(p, f) for p in padded]
        out = torch.empty((len(parts),) + parts[0].shape,
                          dtype=parts[0].dtype, pin_memory=True) \
            if pin else None
        fields[f] = torch.stack(parts, out=out)
    return DeviceSketch(**fields)


def stack_sketches(sketches: Sequence[HostSketch],
                   seed_budget: int | None = None,
                   marker_budget: int | None = None,
                   contig_budget: int | None = None) -> DeviceSketch:
    """Stack sketches into one batched DeviceSketch (leading axis N) on
    the first sketch's device, with a common power-of-two contig table
    (``contig_budget`` wide, by default the largest member's bucket)."""
    return _stack(sketches, seed_budget, marker_budget, contig_budget)


def stack_sketches_host(sketches: Sequence[HostSketch],
                        seed_budget: int | None = None,
                        marker_budget: int | None = None,
                        contig_budget: int | None = None,
                        pin: bool = False) -> DeviceSketch:
    """:func:`stack_sketches` on the host: the stack's tensors are on the
    CPU, in pinned (page-locked) memory with ``pin``, so that one
    asynchronous copy moves a whole chunk to the card.  Pinned buffers
    belong to the current CUDA device's context, so a caller that pins
    makes its target card current first (``engine/stream.py::stage_chunk``
    does).  The contig table is ``contig_budget``
    wide, by default the largest member's bucket."""
    cpu = [dataclasses.replace(s, device=s.device.map(lambda t: t.cpu()))
           for s in sketches]
    return _stack(cpu, seed_budget, marker_budget, contig_budget, pin)


def take_sketch(batch: DeviceSketch, idx) -> DeviceSketch:
    """Select sketch(es) ``idx`` from a stacked batch."""
    return batch.map(lambda x: x[idx])


def one_vs_many(refs: DeviceSketch, query: DeviceSketch, ref_idx,
                *, cfg: ChainConfig, budgets: EngineBudgets,
                chunk: int = 8) -> dict:
    """One query against the references ``ref_idx`` of a stacked store.

    Chunks of ``chunk`` references run as one ``chain_block`` (one sort +
    one DP launch each).  The last chunk is padded with ``ref_idx[0]``:
    the padding pairs share the chunk's anchor pool, so a pool that
    overflows clips the same anchors as in the JAX package, which pads
    with store index 0 (the same reference whenever ``ref_idx[0]`` is
    0).  Padding with a caller-chosen reference keeps a store genome
    outside the packed range out of the block, where its positions would
    raise ``pos_overflow``.  Returns a dict of [len(ref_idx)] tensors."""
    q1 = query.map(lambda x: x[None])
    idx = torch.as_tensor(np.asarray(ref_idx), dtype=torch.int64,
                          device=refs.device)
    P = idx.shape[0]
    idx = torch.cat([idx, idx[:1].expand((-P) % chunk)])
    parts = []
    for lo in range(0, idx.shape[0], chunk):
        out = chain_block(take_sketch(refs, idx[lo:lo + chunk]), q1,
                          cfg=cfg, budgets=budgets)
        parts.append({k: v[:, 0] for k, v in out.items()})
    return {k: torch.cat([p[k] for p in parts])[:P] for k in parts[0]}


def one_vs_many_pairs(refs: DeviceSketch, query: DeviceSketch, ref_idx,
                      *, cfg: ChainConfig, budgets: EngineBudgets) -> dict:
    """Full-range variant of :func:`one_vs_many` built on ``chain_pairs``
    (no packed block-grid caps: contigs up to 2^31 bp and genomes of any
    total length).  Each chunk of up to 4 references is one DP launch, as
    in :func:`pairs_ani`; every pair has its own anchor pool, so the last
    chunk needs no padding.  Returns a dict of [len(ref_idx)] tensors."""
    idx = torch.as_tensor(np.asarray(ref_idx), dtype=torch.int64,
                          device=refs.device)
    parts = []
    for lo in range(0, idx.shape[0], 4):
        sel = idx[lo:lo + 4]
        q = query.map(lambda x: x[None].expand((sel.shape[0],) + x.shape))
        parts.append(chain_pairs(take_sketch(refs, sel), q, cfg=cfg,
                                 budgets=budgets))
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def pairs_ani(batch: DeviceSketch, ref_idx, query_idx, *, cfg: ChainConfig,
              budgets: EngineBudgets) -> dict:
    """ANI/AF for an arbitrary list of (ref, query) index pairs of a
    stacked batch, on the full-range per-pair pipeline: one
    ``chain_pairs`` (one DP launch) per chunk of 4 pairs.  Every
    pair has its own anchor pool, so the last chunk needs no padding (the
    JAX package pads it with the pair (0, 0)).  Returns a dict of [P]
    tensors."""
    ri, qi = (torch.as_tensor(np.asarray(x), dtype=torch.int64,
                              device=batch.device)
              for x in (ref_idx, query_idx))
    parts = [chain_pairs(take_sketch(batch, ri[lo:lo + 4]),
                         take_sketch(batch, qi[lo:lo + 4]), cfg=cfg,
                         budgets=budgets)
             for lo in range(0, ri.shape[0], 4)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def engine_budgets(seed_budget: int, n_fragments: int) -> EngineBudgets:
    """Budgets for genomes of at most ``n_fragments`` fragments and seed
    tables ``seed_budget`` wide, bucketed to limit shapes."""
    return EngineBudgets(
        max_anchors=round_up(seed_budget * 3 // 2 + 4096, 8192),
        max_fragments=round_up(n_fragments + 2, 128),
        max_anchors_per_fragment=256)


def default_budgets(sketches: List[HostSketch], batch: DeviceSketch,
                    cfg: ChainConfig) -> EngineBudgets:
    """The triangle's budgets: fragments for the largest genome, and an
    anchor pool per pair from the stack's seed budget."""
    return engine_budgets(batch.kmers.shape[1], max(
        s.n_fragments(cfg.fragment_length) for s in sketches))


def max_triangle_group(budgets: EngineBudgets, cap: int = 32) -> int:
    """Largest genome-group size whose triangle fits the pair-grid limit
    (``ops.chain.grid_fits``, see chain_triangle)."""
    g = cap
    while g > 2 and not grid_fits(g * (g - 1) // 2, budgets.max_fragments):
        g -= 1
    return g


def max_tile(budgets: EngineBudgets, cap: int) -> int:
    """Side of the largest square ``chain_block`` tile, ``cap`` halved
    until its pairs fit the pair-grid limit."""
    block = cap
    while block > 1 and not grid_fits(block * block, budgets.max_fragments):
        block //= 2
    return block


def square_tiles(ridx, qidx, block: int):
    """The ``block`` x ``block`` ``chain_block`` tiles of ``ridx`` x
    ``qidx``: (ref rows, query rows, both padded to ``block`` with their
    first genome, which shares the tile's anchor pool, as JAX pads)."""
    for bi in range(0, len(ridx), block):
        for bj in range(0, len(qidx), block):
            r, q = ridx[bi:bi + block], qidx[bj:bj + block]
            yield (r, q, np.concatenate([r, np.full(block - len(r), r[0])]),
                   np.concatenate([q, np.full(block - len(q), q[0])]))


def split_giants(n: int, giant: List[int]) -> tuple:
    """(the packable genomes of ``n``, and the (ref, query) indices of the
    pairs that touch a genome of ``giant``, in triu order): those pairs
    take ``pairs_ani``, the others the packed paths."""
    ri, qi = np.triu_indices(n, k=1)
    touch = np.isin(ri, giant) | np.isin(qi, giant)
    return np.setdiff1d(np.arange(n), giant), ri[touch], qi[touch]


def block_chunk(n: int, budgets: EngineBudgets) -> int:
    """:func:`one_vs_many`'s chunk for ``n`` references: a power of two
    up to 16 whose pairs fit the pair-grid limit."""
    cap = max(1, min(16, MAX_GRID_ROWS // budgets.max_fragments))
    p = 1
    while p < min(max(n, 1), cap):
        p *= 2
    return p


def triangle(sketches: List[HostSketch], cfg: ChainConfig | None = None,
             budgets: EngineBudgets | None = None, block: int | None = None,
             anchors_per_pair: int | None = None, group: int = 32):
    """All-vs-all ANI over a genome set (skani's ``triangle`` mode), on
    the sketches' device.

    Genomes are split into groups of up to ``group``: each group's own
    pairs run as ONE ``chain_triangle``, and each cross-group rectangle
    as :func:`square_tiles` of ``block`` (default: :func:`max_tile` of the
    group size).  A genome that fails ``ops.chain.fits_packed`` takes
    ``pairs_ani`` for every pair it is in (the smaller index as the
    reference).  ``anchors_per_pair`` sizes each call's shared anchor
    pool (default: the per-pair budget).

    Returns (ref_idx, query_idx, dict of numpy arrays) over the N(N-1)/2
    unordered pairs in ``np.triu_indices`` order.  A key that one path
    lacks reads 0 for the other paths' pairs, as in the JAX package.

    With profiling on, the call is the span ``triangle``, holding
    ``triangle/stack``, one ``triangle/group`` per group, one
    ``triangle/cross`` per tile, ``triangle/pairs_ani`` and
    ``triangle/merge``.
    """
    dev = sketches[0].device.device if sketches else None
    with profiling.scope("triangle", dev):
        return _triangle(sketches, cfg, budgets, block, anchors_per_pair,
                         group)


def _triangle(sketches, cfg, budgets, block, anchors_per_pair, group):
    cfg = cfg or ChainConfig()
    n = len(sketches)
    with profiling.scope("triangle/stack"):
        batch = stack_sketches(sketches)
    if budgets is None:
        budgets = default_budgets(sketches, batch, cfg)
    group = max_triangle_group(budgets, min(group, n))
    app = anchors_per_pair or budgets.max_anchors
    if block is None:
        block = max_tile(budgets, group)
    dev = batch.device

    def take(idx):
        return take_sketch(batch, torch.as_tensor(idx, dtype=torch.int64,
                                                  device=dev))

    cb = batch.contig_lengths.shape[1]
    pk, ri_f, qi_f = split_giants(n, [
        i for i, s in enumerate(sketches)
        if not fits_packed(max(s.lengths, default=0), s.total_len, cb)])
    starts = list(range(0, len(pk), group))
    pending = []          # (ref indices, query indices, dict of [P] tensors)
    for a in starts:
        gidx = pk[a:a + group]
        if len(gidx) < 2:
            # no pairs inside; the cross-group tiles cover its other pairs
            continue
        with profiling.scope("triangle/group", dev):
            out = chain_triangle(
                take(gidx), cfg=cfg, budgets=budgets,
                total_anchors=round_up(
                    len(gidx) * (len(gidx) - 1) // 2 * app, 8192))
        tri_r, tri_q = np.triu_indices(len(gidx), k=1)
        pending.append((gidx[tri_r], gidx[tri_q], out))
    if len(ri_f):
        with profiling.scope("triangle/pairs_ani", dev):
            pending.append((ri_f, qi_f, pairs_ani(
                batch, ri_f, qi_f, cfg=cfg, budgets=budgets)))
    for a in starts:
        for b in starts[a // group + 1:]:
            for ridx, qidx, rpad, qpad in square_tiles(
                    pk[a:a + group], pk[b:b + group], block):
                with profiling.scope("triangle/cross", dev):
                    out = chain_block(
                        take(rpad), take(qpad), cfg=cfg, budgets=budgets,
                        total_anchors=round_up(block * block * app, 8192))
                rr, qq = np.meshgrid(ridx, qidx, indexing="ij")
                pending.append((rr, qq, {k: v[:len(ridx), :len(qidx)]
                                         for k, v in out.items()}))

    with profiling.scope("triangle/merge"):
        ri, qi, out = assemble(n, [
            (ridx, qidx, {k: v.cpu().numpy() for k, v in part.items()})
            for ridx, qidx, part in pending])
        check_overflow(out, budgets)
    return ri, qi, out


def assemble(G: int, parts) -> tuple:
    """(ri, qi, dict of [P] arrays) in ``np.triu_indices`` order from
    (ref idx, query idx, dict of arrays) parts; a key that one part lacks
    reads 0 for its pairs."""
    mats = {}
    for ri_p, qi_p, res in parts:
        for key, val in res.items():
            arr = np.asarray(val)
            if key not in mats:
                mats[key] = np.zeros((G, G), arr.dtype)
            mats[key][ri_p, qi_p] = arr
    ri, qi = np.triu_indices(G, k=1)
    return ri, qi, {k: v[ri, qi] for k, v in mats.items()}


def check_overflow(out: dict, budgets: EngineBudgets,
                   raise_on_overflow: bool = False) -> None:
    """Surface budget saturation to the caller.

    ``pos_overflow`` (a position past the packed grid range) and
    ``frag_overflow`` (anchors past the fragment budget were dropped)
    always raise: results for such pairs are wrong.
    ``anchors_overflow`` (the shared anchor pool clipped the join) and
    ``n_chains > max_chains_per_pair`` warn, or raise with
    ``raise_on_overflow``."""
    problems = []

    def any_of(key):
        return key in out and bool(np.any(np.asarray(out[key])))

    pos_over = any_of("pos_overflow")
    if pos_over:
        problems.append(
            "contig coordinate overflow: a position exceeds the packed "
            "block-grid range (ref contigs >= 2^(32-rcid_bits) bp or a "
            "query genome >= 2^30 bp) — use the per-pair path for such "
            "genomes")
    frag_over = any_of("frag_overflow")
    if frag_over:
        problems.append(
            "fragment budget overflow: a genome has anchors beyond "
            "max_fragments * fragment_length — raise max_fragments to "
            "cover the largest genome")
    if any_of("anchors_overflow"):
        problems.append("anchor budget overflow: the shared anchor pool "
                        "clipped the join (raise total_anchors / "
                        "max_anchors)")
    if "n_chains" in out:
        mx = int(np.max(np.asarray(out["n_chains"]), initial=0))
        if mx > budgets.max_chains_per_pair:
            problems.append(
                f"chain table overflow: a pair kept {mx} chains > "
                f"max_chains_per_pair={budgets.max_chains_per_pair}")
    if problems and (pos_over or frag_over or raise_on_overflow):
        raise RuntimeError("; ".join(problems))
    for msg in problems:
        warnings.warn(msg, RuntimeWarning, stacklevel=3)
