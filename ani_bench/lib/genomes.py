"""Seeded synthetic genomes, made on the device.

A population is a set of roots (random sequence) and, for each root, a
set of children mutated from it by substitutions and short indels (the
model of the repository's test helpers: substitutions at ``d``, indels
of 1-29 bp at ``d * indel_ratio``, half insertions).  The children of
a root are made in a few batches, each read back to the host at once.

The seed changes the sequences and which length, divergence and contig
count goes to which genome, never the sets of them: lengths, divergences
and contig counts are fixed quantiles of the configured ranges, so every
seed does the same amount of work in another order.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

_ACGT = torch.tensor(list(b"ACGT"), dtype=torch.uint8)


def host_rng(seed: int, *tags: int) -> np.random.Generator:
    if seed < 0:
        raise ValueError("the seed must be a whole number >= 0")
    return np.random.default_rng(np.random.SeedSequence([seed, *tags]))


def device_rng(device, seed: int, *tags: int) -> torch.Generator:
    state = host_rng(seed, *tags).integers(0, 2**62)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state))
    return gen


def spread(lo: float, hi: float, n: int) -> np.ndarray:
    """n evenly spaced values from lo to hi (midpoints of n bins)."""
    return lo + (np.arange(n) + 0.5) / n * (hi - lo)


def log_spread(lo: float, mid: float, hi: float, n: int) -> np.ndarray:
    """n fixed lengths from lo to hi with median mid: evenly spaced in
    log space on each side of the median."""
    u = (np.arange(n) + 0.5) / n
    low = np.exp(np.log(lo) + (np.log(mid) - np.log(lo)) * u * 2)
    high = np.exp(np.log(mid) + (np.log(hi) - np.log(mid)) * (u * 2 - 1))
    return np.where(u < 0.5, low, high)


def random_codes(n: int, gen: torch.Generator) -> torch.Tensor:
    return torch.randint(0, 4, (n,), generator=gen, device=gen.device,
                         dtype=torch.uint8)


# elements of one batch of children made together: bounds the device
# memory of their int64 work arrays to a few GB
BATCH_BASES = 1 << 26


def mutate_many(codes: torch.Tensor, rates: Sequence[tuple],
                gen: torch.Generator):
    """Children of one parent, each with its (substitution rate, indel
    rate): random substitutions, then deletions and insertions of 1-29
    bp.  The children are made together, concatenated; returns them and
    each one's length (one host read for the whole batch)."""
    dev = codes.device
    n, B = codes.shape[0], len(rates)
    first = torch.arange(B, device=dev, dtype=torch.int64) * n

    def draw(counts):
        """Positions in the parent and each one's child offset."""
        owner = torch.repeat_interleave(
            first, torch.tensor(counts, device=dev, dtype=torch.int64))
        return torch.randint(0, n, (sum(counts),), generator=gen,
                             device=dev), owner

    out = codes.repeat(B)
    # unique positions: a write of duplicates would leave either value
    p, off = draw([int(n * s) for s, _ in rates])
    pos = torch.unique(p + off)
    out[pos] = random_codes(pos.shape[0], gen)
    cuts, off = draw([int(n * i) for _, i in rates])
    nind = cuts.shape[0]
    lens = torch.randint(1, 30, (nind,), generator=gen, device=dev)
    ins = torch.rand(nind, generator=gen, device=dev) < 0.5
    # a deletion ends at its child's end at the latest
    diff = torch.zeros(B * n + 1, dtype=torch.int32, device=dev)
    dcut, doff = cuts[~ins], off[~ins]
    ones = torch.ones_like(dcut, dtype=torch.int32)
    diff.index_add_(0, dcut + doff, ones)
    diff.index_add_(0, torch.clamp(dcut + lens[~ins], max=n) + doff, -ones)
    keep = torch.cumsum(diff[:B * n], 0) == 0
    n_ins = torch.zeros(B * n, dtype=torch.int64, device=dev)
    n_ins.index_add_(0, cuts[ins] + off[ins], lens[ins])
    # each position p holds its inserted bases first, then itself if kept
    size = n_ins + keep.long()
    sizes = size.view(B, n).sum(1).tolist()
    start = torch.cumsum(size, 0) - size
    res = random_codes(sum(sizes), gen)
    res[(start + n_ins)[keep]] = out[keep]
    return res, sizes


def cut(length: int, n_contigs: int, rng: np.random.Generator,
        min_len: int) -> List[int]:
    """Contig lengths of a genome cut into n pieces of >= min_len."""
    n = max(1, min(n_contigs, length // min_len))
    extra = length - n * min_len
    marks = np.sort(rng.integers(0, extra + 1, n - 1))
    return list(np.diff(np.concatenate([[0], marks, [extra]])) + min_len)


@dataclasses.dataclass
class Genome:
    name: str
    contigs: List[bytes]

    @property
    def length(self) -> int:
        return sum(map(len, self.contigs))

    def lengths(self) -> List[int]:
        return [len(c) for c in self.contigs]


def ascii(codes: torch.Tensor) -> np.ndarray:
    """Codes 0-3 as the host's ACGT bytes (one device-to-host copy)."""
    return _ACGT.to(codes.device).index_select(0, codes.int()).cpu().numpy()


def to_genome(name: str, raw: np.ndarray, n_contigs: int,
              rng: np.random.Generator, min_len: int) -> Genome:
    """The genome of ACGT bytes ``raw`` cut into ``n_contigs`` pieces."""
    ends = np.cumsum(cut(len(raw), n_contigs, rng, min_len))
    return Genome(name, [raw[e - n:e].tobytes() for e, n in
                         zip(ends, np.diff(np.concatenate([[0], ends])))])


def contig_counts(lo: int, hi: int, n: int) -> np.ndarray:
    """n fixed contig counts from lo to hi, evenly spaced in log space."""
    return np.round(np.exp(spread(np.log(lo), np.log(hi), n))).astype(int)


def permuted(values: Sequence, rng: np.random.Generator) -> np.ndarray:
    return np.asarray(values)[rng.permutation(len(values))]
