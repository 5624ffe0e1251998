"""``pyskani_tpu_torch.Database.query`` against the benchmark's plain
search reference (``ani_bench/reference/search.py``): the same hits, the
corrected ANI within 1e-5 and the aligned fractions within 1e-6 (the
limits of the cell ``strain_search-isolates``), every screened reference
corrected once, and the reference in bfloat16 (the cell's control)
outside those limits.

Two species of six genomes of 150-300 kbp, 1-5 contigs, made from a
seed: five of each species stored, one of each queried against all ten.
"""

import numpy as np
import pytest
import torch

import pyskani_tpu_torch
from ani_bench.lib import population
from ani_bench.reference import ani as ref
from ani_bench.reference import search as ref_search
from pyskani_tpu_torch.utils import profiling

POP = dict(roots=2, children=6, root_bp=[150_000, 200_000, 300_000],
           divergence=[0.002, 0.03], indel_ratio=0.1, contigs=[1, 5],
           min_contig_bp=1000)
STORED = 5
ANI_LIMIT, AF_LIMIT = 1e-5, 1e-6


def _outputs(results, names):
    return {n: (r["ani"], r["af_query"], r["af_ref"])
            for n, r in zip(names, results) if r["hit"]}


@pytest.fixture(scope="module", params=[2**31 + 21, 7])
def searched(request):
    """(program hits, reference hits, bf16 reference hits, the program's
    counters) per query, each hits a {name: (ani, af_q, af_r)}."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        pop = population.make(POP, request.param, "cpu")
        M = POP["children"]
        species = [pop.children[r * M:(r + 1) * M] for r in range(POP["roots"])]
        stored = [g for members in species for g in members[:STORED]]
        queries = [members[STORED] for members in species]
        db = pyskani_tpu_torch.Database(device="cpu")
        db.sketch_many((g.name, g.contigs) for g in stored)
        sk = ref.sketch_many([g.contigs for g in stored + queries], "cpu")
        model = ref_search.load_model()
        names = [g.name for g in stored]
        out = []
        for q, qsk in zip(queries, sk[len(stored):]):
            profiling.reset_stats()
            profiling.enable()
            try:
                hits = db.query(q.name, *q.contigs)
                counters = profiling.stats().snapshot()["counters"]
            finally:
                profiling.disable()
                profiling.reset_stats()
            got = {h.reference_name: (h.identity, h.query_fraction,
                                      h.reference_fraction) for h in hits}
            want, low = (_outputs(ref_search.search(
                qsk, sk[:len(stored)], model, precision=p), names)
                for p in ("f64", "bf16"))
            out.append((got, want, low, counters))
        return out
    finally:
        torch.set_num_threads(before)


def _gaps(got, want):
    ani = max(abs(got[n][0] - want[n][0]) for n in want)
    af = max(max(abs(got[n][1] - want[n][1]), abs(got[n][2] - want[n][2]))
             for n in want)
    return ani, af


def test_same_hits(searched):
    for got, want, _, _ in searched:
        # the query's conspecific stored genomes, and nothing else
        assert len(want) == STORED
        assert set(got) == set(want)


def test_corrected_ani_and_aligned_fractions_agree(searched):
    for got, want, _, _ in searched:
        ani, af = _gaps(got, want)
        assert ani <= ANI_LIMIT and af <= AF_LIMIT, (ani, af)


def test_every_hit_corrected_once(searched):
    for got, _, _, counters in searched:
        assert counters["hits_corrected"] == counters["hits_returned"] == \
            len(got)


def test_bf16_control_fails(searched):
    fails = []
    for _, want, low, _ in searched:
        if set(low) != set(want):
            fails.append(True)
            continue
        ani, af = _gaps(low, want)
        fails.append(ani > ANI_LIMIT or af > AF_LIMIT)
    assert all(fails)


def test_correction_moves_the_estimate_within_its_rails():
    """The reference's correction: none below the fade, at most
    ``MAX_DELTA`` above it, non-decreasing in the raw ANI."""
    model = ref_search.load_model()
    assert ref_search.correct(model, 0.80, 0.9, 0.9) == 0.80
    raw = np.linspace(0.86, 0.999, 40)
    fixed = np.array([ref_search.correct(model, a, 0.9, 0.9) for a in raw])
    assert np.all(np.abs(fixed - raw) <= ref_search.MAX_DELTA + 1e-12)
    assert np.all(np.diff(fixed) >= 0)
