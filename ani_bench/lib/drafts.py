"""A dereplication pool of complete genomes and MAG drafts.

A configuration's ``population`` makes every member whole, one contig
each (``lib/population.py`` with ``contigs`` [1, 1]); its ``drafts``
block then turns all but ``complete`` members of each species into
drafts as a binner leaves them:

* completeness: the member is cut into contigs of at least
  ``min_contig_bp``, and whole contigs are dropped, in a fixed random
  order, until the kept total is at or just above its share of the
  member (``completeness`` = [lo, hi]);
* contamination: contigs of random sequence, related to no species,
  ``contamination`` = [lo, hi] of the kept length, cut as the rest;
* contig counts evenly spaced in log space over ``contigs`` = [lo, hi],
  each capped so that the draft keeps at most ``max_contigs`` contigs
  and a contig N50 of at least ``min_n50_bp`` (planned 1% above it, so
  that no member's indels take it below);
* the contigs shuffled, and a share ``flipped`` of them
  reverse-complemented, as an assembler leaves them.

Which members stay complete, and each draft's contig count, completeness
and contamination, go by (root length rank, divergence rank), the same
for every seed.  A draft's plan (its pieces' lengths and which are
dropped) is made on its root's length, which is fixed by the rank, and
scaled to the member's own length, so its contig count is the same for
every seed too.  The seed changes the sequences, the contigs' order and
which of them are flipped.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from . import genomes as gm
from . import population

_COMPLEMENT = bytes.maketrans(b"ACGT", b"TGCA")
N50_MARGIN = 1.01


@dataclasses.dataclass
class Plan:
    """A draft's contigs: its member's pieces in genome order (lengths on
    the root's length), which pieces are kept, and the lengths of its
    contamination contigs."""

    pieces: np.ndarray
    kept: np.ndarray
    contamination: np.ndarray

    def lengths(self) -> np.ndarray:
        return np.concatenate([self.pieces[self.kept], self.contamination])

    @property
    def count(self) -> int:
        return int(self.kept.sum()) + len(self.contamination)


@dataclasses.dataclass
class Pool:
    genomes: List[gm.Genome]         # root-major, as Population.children
    complete: np.ndarray             # [N*M] bool
    n_contigs: np.ndarray            # [N*M] contigs of each member
    length_rank: np.ndarray          # [N] as Population's
    div_order: np.ndarray            # [N, M] as Population's


def n50(lengths) -> int:
    """The length L such that contigs of at least L hold half the bases."""
    s = np.sort(np.asarray(lengths, np.int64))[::-1]
    return int(s[np.searchsorted(np.cumsum(s), s.sum() / 2)])


def _cut(total: int, n: int, floor: int, order: np.ndarray) -> np.ndarray:
    """``total`` bp in ``n`` pieces: ``floor`` bp each plus a share of the
    rest from an exponential law's quantiles (the spacings of random
    cuts), in the order ``order`` (a permutation of n)."""
    w = -np.log1p(-(np.arange(n) + 0.5) / n)
    extra = np.floor(w[order] / w.sum() * (total - n * floor))
    out = floor + extra.astype(np.int64)
    out[-1] += total - out.sum()
    return out


def plan(length: int, pieces: int, completeness: float,
         contamination: float, floor: int, tag: Tuple[int, ...]) -> Plan:
    """The draft of a member of ``length`` bp cut into ``pieces``: pieces
    dropped in a fixed order while the kept total stays at or above
    ``completeness`` of the member."""
    rng = population.fixed_rng(*tag)
    cut = _cut(length, pieces, floor, rng.permutation(pieces))
    order = rng.permutation(pieces)
    left = length - np.cumsum(cut[order])
    dropped = int(np.sum(np.minimum.accumulate(
        left >= completeness * length)))
    kept = np.ones(pieces, bool)
    kept[order[:dropped]] = False
    bases = int(contamination * cut[kept].sum())
    n = min(int(round(contamination * kept.sum())), bases // floor)
    if n == 0 and bases >= floor:
        n = 1
    cont = _cut(bases, n, floor, rng.permutation(n)) if n else \
        np.zeros(0, np.int64)
    return Plan(cut, kept, cont)


def capped_plan(length: int, count: int, completeness: float,
                contamination: float, d: dict, tag: Tuple[int, ...]) -> Plan:
    """The plan of the most pieces, up to about ``count`` contigs kept,
    that keeps at most ``max_contigs`` contigs and the N50 floor."""
    floor = int(d["min_contig_bp"])

    def make(m):
        return plan(length, m, completeness, contamination, floor, tag)

    def ok(p):
        return p.count <= int(d["max_contigs"]) and \
            n50(p.lengths()) >= N50_MARGIN * int(d["min_n50_bp"])

    lo = 1
    hi = min(max(1, int(round(count / completeness))), length // floor)
    if ok(make(hi)):
        return make(hi)
    while hi - lo > 1:                   # ok(lo) holds, ok(hi) does not
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if ok(make(mid)) else (lo, mid)
    while not ok(make(lo)):
        lo -= 1
    return make(lo)


def roles(pop: dict, d: dict):
    """[N, M] tables by (root length rank, divergence rank): complete or
    not, the contig count asked for, completeness and contamination; the
    same for every seed."""
    N, M = int(pop["roots"]), int(pop["children"])
    complete = np.zeros((N, M), bool)
    counts = np.ones((N, M), np.int64)
    comp = np.ones((N, M))
    cont = np.zeros((N, M))
    for r in range(N):
        rng = population.fixed_rng(5, r)
        complete[r, rng.permutation(M)[:int(d["complete"])]] = True
        rest = np.nonzero(~complete[r])[0]
        counts[r, rest] = gm.permuted(
            gm.contig_counts(*d["contigs"], len(rest)), rng)
        comp[r, rest] = gm.permuted(
            gm.spread(*d["completeness"], len(rest)), rng)
        cont[r, rest] = gm.permuted(
            gm.spread(*d["contamination"], len(rest)), rng)
    return complete, counts, comp, cont


def plans(pop: dict, d: dict) -> Dict[Tuple[int, int], Plan]:
    """The plan of every draft by (root length rank, divergence rank)."""
    N = int(pop["roots"])
    root_len = np.sort(gm.log_spread(*pop["root_bp"], N).astype(np.int64))
    complete, counts, comp, cont = roles(pop, d)
    return {(int(r), int(c)): capped_plan(
                int(root_len[r]), int(counts[r, c]), float(comp[r, c]),
                float(cont[r, c]), d, (6, int(r), int(c)))
            for r, c in zip(*np.nonzero(~complete))}


def scaled(pieces: np.ndarray, total: int) -> np.ndarray:
    """The pieces' lengths scaled to ``total`` bp, each keeping the
    shortest piece's floor."""
    floor = int(pieces.min())
    spare = pieces.sum() - floor * len(pieces)
    out = floor + np.floor((pieces - floor) * (total - floor * len(pieces)) /
                           max(spare, 1)).astype(np.int64)
    out[-1] += total - out.sum()
    return out


def draft(raw: bytes, p: Plan, rng: np.random.Generator,
          flipped: float) -> List[bytes]:
    """The draft's contigs from its member's bases ``raw``: the plan's
    kept pieces and random contamination, shuffled, a share flipped."""
    ends = np.cumsum(scaled(p.pieces, len(raw)))
    starts = np.concatenate([[0], ends[:-1]])
    contigs = [raw[s:e] for s, e, k in zip(starts, ends, p.kept) if k]
    if len(p.contamination):
        junk = rng.choice(np.frombuffer(b"ACGT", np.uint8),
                          int(p.contamination.sum())).tobytes()
        at = np.concatenate([[0], np.cumsum(p.contamination)])
        contigs += [junk[a:b] for a, b in zip(at[:-1], at[1:])]
    order = rng.permutation(len(contigs))
    flip = rng.permutation(len(contigs)) < int(len(contigs) * flipped)
    return [contigs[i][::-1].translate(_COMPLEMENT) if f else contigs[i]
            for i, f in zip(order, flip)]


def layout(pop: dict, d: dict, length_rank: np.ndarray,
           div_order: np.ndarray):
    """([N*M] complete or not, [N*M] plan or None) of each member, root
    r's child c at r*M+c, for roots of ``length_rank`` and children in
    ``div_order`` (least divergent first)."""
    complete, *_ = roles(pop, d)
    by_rank = plans(pop, d)
    div_rank = np.argsort(div_order, axis=1)
    keys = [(int(length_rank[r]), int(div_rank[r][c]))
            for r in range(div_order.shape[0])
            for c in range(div_order.shape[1])]
    return (np.array([bool(complete[k]) for k in keys]),
            [by_rank.get(k) for k in keys])


def make(pop: dict, d: dict, seed: int, device) -> Pool:
    """The pool of ``pop`` with the drafts of ``d``."""
    whole = population.make(dict(pop, contigs=[1, 1]), seed, device)
    M = int(pop["children"])
    complete, plan_of = layout(pop, d, whole.length_rank, whole.div_order)
    genomes = []
    for i, (g, p) in enumerate(zip(whole.children, plan_of)):
        if p is not None:
            r, c = divmod(i, M)
            g = gm.Genome(g.name, draft(b"".join(g.contigs), p,
                                        gm.host_rng(seed, 7, r, c),
                                        float(d["flipped"])))
        genomes.append(g)
    return Pool(genomes=genomes, complete=complete,
                n_contigs=np.array([len(g.contigs) for g in genomes]),
                length_rank=whole.length_rank, div_order=whole.div_order)
