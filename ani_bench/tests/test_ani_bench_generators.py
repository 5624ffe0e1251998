"""The generator: the same seed gives the same genomes, another seed
other sequences with the same sizes."""

import numpy as np
import pytest
import torch

from ani_bench.lib import genomes as gm
from ani_bench.lib import population

POP = dict(roots=3, children=4, root_bp=[20000, 40000, 90000],
           divergence=[0.02, 0.1], indel_ratio=0.1, contigs=[1, 6],
           min_contig_bp=500)


def _make(seed):
    return population.make(POP, seed, "cpu")


def test_same_seed_same_genomes():
    a, b = _make(2**31 + 17), _make(2**31 + 17)
    assert [g.contigs for g in a.children] == [g.contigs for g in b.children]


def test_other_seed_other_sequences_same_root_lengths():
    a, b = _make(11), _make(12)
    assert [g.contigs for g in a.children] != [g.contigs for g in b.children]
    la = sorted(g.length for g in a.children[::4])
    lb = sorted(g.length for g in b.children[::4])
    # the roots' lengths are a fixed set; children differ by indels only
    assert np.allclose(la, lb, rtol=0.02)


def test_mutate_rates_and_alphabet():
    gen = gm.device_rng("cpu", 5, 1)
    root = gm.random_codes(100_000, gen)
    child = gm.mutate_many(root, [(0.05, 0.0)], gen)[0]
    assert child.shape == root.shape
    diff = (child != root).float().mean().item()
    assert 0.03 < diff < 0.05          # a substitution may redraw the base
    codes = gm.mutate_many(root, [(0.01, 0.01)], gen)[0]
    g = gm.to_genome("x", gm.ascii(codes), 4, gm.host_rng(5, 2), 1000)
    assert set(b"".join(g.contigs)) <= set(b"ACGT")
    assert len(g.contigs) == 4 and min(g.lengths()) >= 1000


def test_children_made_together_keep_their_own_rates():
    gen = gm.device_rng("cpu", 6, 1)
    root = gm.random_codes(50_000, gen)
    codes, sizes = gm.mutate_many(
        root, [(0.0, 0.05), (0.1, 0.0), (0.0, 0.0)], gen)
    assert sum(sizes) == codes.shape[0] and sizes[1:] == [50_000, 50_000]
    first, second, third = torch.split(codes, sizes)
    assert sizes[0] != 50_000          # indels change the length
    assert 0.06 < (second != root).float().mean().item() < 0.1
    # a deletion at the first child's end does not reach the next child
    assert torch.equal(third, root)


def test_fixed_sets_do_not_depend_on_the_seed():
    a = gm.permuted(gm.spread(0.1, 0.2, 9), gm.host_rng(1))
    b = gm.permuted(gm.spread(0.1, 0.2, 9), gm.host_rng(2))
    assert sorted(a) == sorted(b) and list(a) != list(b)
    lengths = gm.log_spread(1e6, 3.5e6, 8e6, 256)
    assert 1e6 <= lengths.min() and lengths.max() <= 8e6
    assert abs(np.median(lengths) / 3.5e6 - 1) < 0.02
    counts = gm.contig_counts(1, 200, 100)
    assert counts.min() >= 1 and counts.max() <= 200


def test_seed_must_not_be_negative():
    with pytest.raises(ValueError):
        gm.host_rng(-1)
