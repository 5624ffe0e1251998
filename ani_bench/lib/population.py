"""A configuration's population of genomes.

A configuration's ``population`` gives ``roots`` (species of a
dereplication pool) of ``root_bp`` = [min, median, max] lengths,
``children`` per root (members) at ``divergence`` = [lo, hi]
substitutions from their root, indels at ``indel_ratio`` of that, each
cut into ``contigs`` = [lo, hi] pieces of at least ``min_contig_bp``.

The lengths, divergences and contig counts are fixed sets, and which
contig count goes with which (length rank, divergence rank) is the same
for every seed; the seed changes the sequences and which root holds
which length and which child which divergence.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from . import genomes as gm


@dataclasses.dataclass
class Population:
    children: List[gm.Genome]        # root-major: child c of root r at r*M+c
    length_rank: np.ndarray          # [N] rank of each root by length
    div_order: np.ndarray            # [N, M] children of a root, least
                                     # divergent first


def fixed_rng(*tags: int) -> np.random.Generator:
    """The same for every seed: which size goes with which genome."""
    return gm.host_rng(0, 99, *tags)


def make(pop: dict, seed: int, device,
         roots: Optional[int] = None) -> Population:
    """The population of ``pop`` (``roots`` overrides its number of
    roots)."""
    rng = gm.host_rng(seed, 1)
    N = int(roots or pop["roots"])
    M = int(pop["children"])
    ratio = float(pop["indel_ratio"])
    min_len = int(pop["min_contig_bp"])
    root_len = gm.permuted(gm.log_spread(*pop["root_bp"], N), rng).astype(
        np.int64)
    by_rank = np.argsort(root_len, kind="stable")
    rank = np.empty(N, np.int64)
    rank[by_rank] = np.arange(N)
    divs = np.stack([gm.permuted(gm.spread(*pop["divergence"], M), rng)
                     for _ in range(N)])
    div_order = np.argsort(divs, axis=1, kind="stable")
    div_rank = np.argsort(div_order, axis=1)
    # contig counts by (length rank, divergence rank), the same every seed
    by_size = gm.permuted(gm.contig_counts(*pop["contigs"], N * M),
                          fixed_rng(2))

    children: List[gm.Genome] = []
    for r in range(N):
        gen = gm.device_rng(device, seed, 2, r)
        root = gm.random_codes(int(root_len[r]), gen)
        per = max(1, gm.BATCH_BASES // int(root_len[r]))
        for c0 in range(0, M, per):
            batch = range(c0, min(M, c0 + per))
            codes, sizes = gm.mutate_many(
                root, [(divs[r][c], divs[r][c] * ratio) for c in batch], gen)
            raw = gm.ascii(codes)
            ends = np.cumsum(sizes)
            for c, e, size in zip(batch, ends, sizes):
                children.append(gm.to_genome(
                    f"r{r:04d}c{c:03d}", raw[e - size:e],
                    int(by_size[rank[r] * M + div_rank[r][c]]),
                    gm.host_rng(seed, 4, r, c), min_len))
    return Population(children=children, length_rank=rank,
                      div_order=div_order)
