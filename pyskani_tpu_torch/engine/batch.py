"""Batched pair engine: one query against many stacked references.

Port of the JAX package's ``engine/batch.py`` minus the triangle:
sketches are padded to common budgets and stacked on a leading axis;
``one_vs_many`` chains a query against chunks of the stack, one
``chain_block`` per chunk, and ``one_vs_many_pairs`` one ``chain_pairs``
per chunk (Python loops where JAX used ``lax.map``).
"""

from __future__ import annotations

import warnings
from typing import Sequence

import numpy as np
import torch

from ..ops.chain import (ChainConfig, EngineBudgets, chain_block,
                         chain_pairs)
from ..ops.sketch import (FIELDS, I32_SENTINEL, U32_SENTINEL, DeviceSketch,
                          HostSketch, contig_budget_for, pad_to,
                          round_up)

# padding of each per-seed / per-marker field
_SEED_FILL = dict(kmers=U32_SENTINEL, positions=I32_SENTINEL,
                  contig_ids=I32_SENTINEL, strands=False, own_mult=0,
                  p_positions=I32_SENTINEL, p_contig_ids=I32_SENTINEL,
                  p_own_mult=0)
_MARKER_FILL = dict(markers_hi=U32_SENTINEL, markers_lo=U32_SENTINEL)


def repad_sketch(host: HostSketch, seed_budget: int, marker_budget: int,
                 max_contigs: int | None = None) -> DeviceSketch:
    """Re-pad a sketch's tensors to common budgets (on its device).
    ``max_contigs=None`` keeps the sketch's own contig-table size."""
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


def stack_sketches(sketches: Sequence[HostSketch],
                   seed_budget: int | None = None,
                   marker_budget: int | None = None) -> DeviceSketch:
    """Stack sketches into one batched DeviceSketch (leading axis N) on
    the first sketch's device, with a common power-of-two contig table."""
    counts = torch.stack([torch.stack([s.device.n_seeds, s.device.n_markers,
                                       s.device.n_contigs])
                          for s in sketches]).cpu()
    if seed_budget is None:
        seed_budget = round_up(int(counts[:, 0].max()), 1024)
    if marker_budget is None:
        marker_budget = round_up(int(counts[:, 1].max()), 512)
    cb = max(contig_budget_for(int(c)) for c in counts[:, 2])
    padded = [repad_sketch(s, seed_budget, marker_budget, cb)
              for s in sketches]
    return DeviceSketch(**{f: torch.stack([getattr(p, f) for p in padded])
                           for f in FIELDS})


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
                      *, cfg: ChainConfig, budgets: EngineBudgets,
                      chunk: int = 4) -> dict:
    """Full-range variant of :func:`one_vs_many` built on ``chain_pairs``
    (no packed block-grid caps: contigs up to 2^31 bp and genomes of any
    total length).  Each chunk of up to ``chunk`` references is one DP
    launch; every pair has its own anchor pool, so the last chunk needs
    no padding.  Returns a dict of [len(ref_idx)] tensors."""
    idx = torch.as_tensor(np.asarray(ref_idx), dtype=torch.int64,
                          device=refs.device)
    parts = []
    for lo in range(0, idx.shape[0], chunk):
        sel = idx[lo:lo + chunk]
        q = query.map(lambda x: x[None].expand((sel.shape[0],) + x.shape))
        parts.append(chain_pairs(take_sketch(refs, sel), q, cfg=cfg,
                                 budgets=budgets))
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


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
