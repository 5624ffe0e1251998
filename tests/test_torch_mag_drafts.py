"""``engine.batch.triangle`` over a small cluster that mixes MAG drafts
with complete genomes, as galah and dRep dereplicate them together.

One draft of 4,100 contigs puts the call's contig table at 8,192, so the
packed range (``ops.chain.packed_cap``) falls to 2^19 bp and the
one-contig genome of ~600 kbp fails ``fits_packed``: both of its pairs
take ``pairs_ani`` (``chain_pairs``), the draft x draft pair
``chain_triangle``.  The draft's contigs are shuffled and half
of them reverse-complemented, as an assembler leaves them.  Every pair's
ANI, aligned fractions and anchor count are held to the benchmark's
plain reference (``ani_bench/reference/ani.py``) at the limits of the
cell ``derep_triangle-species``, and the routing counters are checked.
Imports no JAX.
"""

import numpy as np
import pytest
import torch

from ani_bench.reference import ani as ref
from conftest import mutate, random_genome
from pyskani_tpu_torch.database import _chain_cfg_for
from pyskani_tpu_torch.engine import batch
from pyskani_tpu_torch.ops.chain import fits_packed, packed_cap
from pyskani_tpu_torch.ops.sketch import (contig_budget_for,
                                          sketch_genomes_device)
from pyskani_tpu_torch.params import SketchParams
from pyskani_tpu_torch.utils import profiling

torch.set_num_threads(1)

ANI_LIMIT, AF_LIMIT = 1e-5, 1e-6
COMPLEMENT = bytes.maketrans(b"ACGT", b"TGCA")
ROOT_BP = 600_000


def _assembled(rng, contigs):
    """The contigs shuffled, half of them reverse-complemented."""
    order = rng.permutation(len(contigs))
    flip = rng.permutation(len(contigs)) < len(contigs) // 2
    return [contigs[i][::-1].translate(COMPLEMENT) if f else contigs[i]
            for i, f in zip(order, flip)]


def _genomes():
    """[complete, wide draft, small draft]: the wide draft holds
    20 contigs of 24 kbp, 1,000 of 120 bp from the rest of its genome and
    3,080 of 120 bp of unrelated sequence."""
    rng = np.random.default_rng(2121)
    root = random_genome(rng, ROOT_BP)
    member = mutate(rng, root, 0.02)
    wide = [member[i:i + 24_000] for i in range(0, 480_000, 24_000)]
    wide += [member[i:i + 120] for i in range(480_000, 600_000, 120)]
    wide += [random_genome(rng, 120) for _ in range(3_080)]
    small = mutate(rng, root, 0.03)
    small = [small[i:i + 100_000] for i in range(0, 500_000, 100_000)]
    return [("complete_a", [mutate(rng, root, 0.01)]),
            ("wide", _assembled(rng, wide)),
            ("small", _assembled(rng, small[:4]))]


@pytest.fixture(scope="module")
def mixed():
    """(genomes, the program's (ri, qi, out), the (ri, qi) that reached
    ``pairs_ani``, the counters, the reference's output per pair)."""
    genomes = _genomes()
    params = SketchParams(c=125, marker_c=1000, k=15)
    sketches = sketch_genomes_device(genomes, params, device="cpu")
    spied = []
    pairs_ani = batch.pairs_ani

    def spy(b, ri, qi, **kw):
        spied.append((np.asarray(ri).copy(), np.asarray(qi).copy()))
        return pairs_ani(b, ri, qi, **kw)

    profiling.reset_stats()
    profiling.enable()
    batch.pairs_ani = spy
    try:
        got = batch.triangle(sketches, cfg=_chain_cfg_for(params))
        counters = profiling.stats().snapshot()["counters"]
    finally:
        batch.pairs_ani = pairs_ani
        profiling.disable()
        profiling.reset_stats()
    sk = ref.sketch_many([contigs for _, contigs in genomes], "cpu")
    ri, qi, _ = got
    want = ref.chain_pairs([(sk[r], sk[q]) for r, q in zip(ri, qi)], k=15)
    return genomes, got, spied, counters, want


def test_the_draft_puts_complete_genomes_past_the_packed_range(mixed):
    genomes = mixed[0]
    counts = [len(contigs) for _, contigs in genomes]
    assert counts == [1, 4_100, 4]
    cb = contig_budget_for(max(counts))
    assert cb == 8_192 and packed_cap(cb) == 1 << 19
    lengths = [[len(c) for c in contigs] for _, contigs in genomes]
    assert [fits_packed(max(ls), sum(ls), cb) for ls in lengths] == \
        [False, True, True]


def test_pairs_ani_takes_exactly_the_complete_genomes_pairs(mixed):
    _, _, spied, _, _ = mixed
    assert len(spied) == 1
    ri, qi = spied[0]
    assert sorted(zip(ri.tolist(), qi.tolist())) == [(0, 1), (0, 2)]


def test_every_pair_agrees_with_the_plain_reference(mixed):
    _, (ri, qi, out), _, _, want = mixed
    assert len(ri) == 3
    for p, w in enumerate(want):
        assert abs(float(out["ani_mean"][p]) - w["ani"]) <= ANI_LIMIT, p
        assert abs(float(out["af_query"][p]) - w["af_query"]) <= AF_LIMIT
        assert abs(float(out["af_ref"][p]) - w["af_ref"]) <= AF_LIMIT
        assert int(out["n_anchors"][p]) == w["n_anchors"], p
    # the pairs are related: every one chains, at the members' identity
    assert (out["ani_mean"] > 0.95).all() and (out["n_anchors"] > 0).all()


def test_routing_counters(mixed):
    counters = mixed[3]
    # one chain_pairs call (2 pairs) and one chain_triangle group
    assert counters["pairs_ani_pairs"] == 2
    assert counters["triangle_giants"] == 1
    assert counters["chain_calls"] == 2
