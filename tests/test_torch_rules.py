"""The port's routing, tiling, budget and hit rules, pinned at their edges.

Each rule has one home: the packed range and the pair-grid limit in
``ops/chain.py``, tiles, chunks and engine budgets in ``engine/batch.py``,
store buckets in ``Database._store_buckets``, the hit rule in
``hit.screened_hits``.  The expected budgets and sizes are literals: what
``Database.query``, the triangle and ``ShardedDatabaseSearch`` were given
for the same inputs before the rules were gathered.  No JAX call.
"""

import types

import numpy as np
import pytest
import torch

import pyskani_tpu_torch
from pyskani_tpu_torch import convert, hit, params, regression
from pyskani_tpu_torch.db.storage import MarkerSketch
from pyskani_tpu_torch.engine import batch as eb
from pyskani_tpu_torch.ops import chain as tch
from pyskani_tpu_torch.ops.sketch import HostSketch
from pyskani_tpu_torch.parallel.mesh import make_mesh
from pyskani_tpu_torch.parallel.search import ShardedDatabaseSearch

CFG = pyskani_tpu_torch.database._chain_cfg_for(params.SketchParams())


def _host(lengths, seed_budget=0):
    return HostSketch("x", [], types.SimpleNamespace(seed_budget=seed_budget),
                      lengths)


def _markers(lengths):
    return [MarkerSketch(name=f"r{i}", total_len=sum(ls), contig_names=[],
                         contig_lengths=ls, hi=None, lo=None)
            for i, ls in enumerate(lengths)]


def _db(lengths):
    db = pyskani_tpu_torch.Database(device="cpu")
    db._markers = _markers(lengths)
    return db


# ---- packed range and grid limit: ops/chain.py ----

@pytest.mark.parametrize("cb,cap", [
    (8, 1 << 29), (16, 1 << 28), (32, 1 << 27), (64, 1 << 26),
    (128, 1 << 25), (256, 1 << 24), (512, 1 << 23), (1024, 1 << 22),
    (2048, 1 << 21), (4096, 1 << 20), (8192, 1 << 19)])
def test_packed_cap_and_contig_edge(cb, cap):
    assert tch.packed_cap(cb) == cap
    assert tch.fits_packed(cap - 1, cap - 1, cb)
    assert not tch.fits_packed(cap, cap, cb)


@pytest.mark.parametrize("total,fits", [((1 << 30) - 1, True),
                                        (1 << 30, False)])
def test_packed_total_edge(total, fits):
    assert tch.MAX_PACKED_TOTAL == 1 << 30
    assert tch.fits_packed(1000, total, 8) is fits


@pytest.mark.parametrize("nf", [128, 256, 384, 512])
def test_grid_limit_edge(nf):
    assert tch.MAX_GRID_ROWS == 1 << 17
    assert tch.grid_fits((1 << 17) // nf, nf)
    assert not tch.grid_fits((1 << 17) // nf + 1, nf)


def test_packed_calls_refuse_grids_past_the_limit():
    budgets = tch.EngineBudgets(max_fragments=128)
    sk = types.SimpleNamespace   # the limit is checked before any tensor
    with pytest.raises(ValueError, match="2\\^17"):
        tch.chain_block(sk(kmers=torch.empty(1025, 1)),
                        sk(kmers=torch.empty(1, 1)), cfg=CFG,
                        budgets=budgets)
    with pytest.raises(ValueError, match="2\\^17"):
        tch.chain_triangle(sk(kmers=torch.empty(46, 1)), cfg=CFG,
                           budgets=budgets)


def test_partition_routes_past_the_cap_and_giant_queries():
    db = _db([[(1 << 19) - 1], [1 << 19], [1000] * 4100])
    by_name = {m.name: m for m in db._markers}
    part = pyskani_tpu_torch.database._partition_blockable
    assert part(by_name, ["r0", "r1", "r2"]) == \
        (["r0", "r2"], ["r1"], 8192, 1 << 19)
    assert part(by_name, ["r0", "r1"]) == (["r0", "r1"], [], 8, 1 << 29)
    assert part(by_name, ["r0"], (1 << 30) - 1)[:2] == (["r0"], [])
    assert part(by_name, ["r0"], 1 << 30)[:2] == ([], ["r0"])


def test_split_giants():
    pk, ri, qi = eb.split_giants(5, [1, 3])
    assert pk.tolist() == [0, 2, 4]
    assert list(zip(ri.tolist(), qi.tolist())) == \
        [(0, 1), (0, 3), (1, 2), (1, 3), (1, 4), (2, 3), (3, 4)]
    pk, ri, qi = eb.split_giants(3, [])
    assert pk.tolist() == [0, 1, 2] and len(ri) == len(qi) == 0


# ---- tiles, groups and chunks: engine/batch.py ----

@pytest.mark.parametrize("nf,group,tile,chunks", [
    (128, 32, 32, [1, 4, 8, 16, 16]),
    (256, 32, 16, [1, 4, 8, 16, 16]),
    (384, 26, 16, [1, 4, 8, 16, 16]),
    (512, 23, 16, [1, 4, 8, 16, 16]),
    (16384, 4, 2, [1, 4, 8, 8, 8]),
    (131072, 2, 1, [1, 1, 1, 1, 1])])
def test_group_tile_and_chunk_sizes(nf, group, tile, chunks):
    budgets = tch.EngineBudgets(max_fragments=nf)
    assert eb.max_triangle_group(budgets, 32) == group
    assert eb.max_tile(budgets, 32) == tile
    assert [eb.block_chunk(n, budgets) for n in (1, 3, 5, 16, 100)] == chunks


def test_square_tiles_pad_with_their_first_genome():
    tiles = list(eb.square_tiles(np.arange(5), np.arange(10, 13), 2))
    assert [(r.tolist(), q.tolist(), rp.tolist(), qp.tolist())
            for r, q, rp, qp in tiles] == [
        ([0, 1], [10, 11], [0, 1], [10, 11]),
        ([0, 1], [12], [0, 1], [12, 12]),
        ([2, 3], [10, 11], [2, 3], [10, 11]),
        ([2, 3], [12], [2, 3], [12, 12]),
        ([4], [10, 11], [4, 4], [10, 11]),
        ([4], [12], [4, 4], [12, 12])]


# ---- engine budgets: the triangle's, Database.query's, the searcher's ----

@pytest.mark.parametrize("seed_budget,lengths,want", [
    (1024, [[50_000]], (8192, 128, 256)),
    (8192, [[5_000_000], [4_400_000]], (16384, 256, 256)),
    (12288, [[1000] * 600, [6_000_000]], (24576, 640, 256)),
    (98304, [[2_000_000] * 3], (155648, 384, 256))])
def test_default_budgets(seed_budget, lengths, want):
    b = eb.default_budgets([_host(ls) for ls in lengths],
                           types.SimpleNamespace(
                               kmers=torch.empty(1, seed_budget)), CFG)
    assert (b.max_anchors, b.max_fragments,
            b.max_anchors_per_fragment) == want


STORE = [[5_000_000], [20_000] * 300, [1000] * 1000, [4_000_000] * 2000]


@pytest.mark.parametrize("seed_budget,query,shortlist,want", [
    (40960, [5_000_000], {"r0"}, (65536, 256, 256)),
    (40960, [5_000_000], {"r1"}, (65536, 384, 256)),
    (8192, [100_000], {"r0", "r2"}, (16384, 1024, 256)),
    (40960, [5_000_000], {"r2"}, (65536, 1024, 256)),
    (40960, [5_000_000], {"r3"}, (65536, 524288, 256)),
    (40960, [7_500_000], None, (65536, 524288, 256)),
    (1024, [10_000], {"r0"}, (8192, 256, 256))])
def test_database_budgets(seed_budget, query, shortlist, want):
    b = _db(STORE)._budgets_for(_host(query, seed_budget), shortlist)
    assert (b.max_anchors, b.max_fragments,
            b.max_anchors_per_fragment) == want


def test_sharded_searcher_budgets_from_markers():
    s = ShardedDatabaseSearch(_db(STORE[:3]), make_mesh(device="cpu"),
                              stream_refs_per_device=8)
    b = s._budgets
    assert (s._bucket, s._mbucket, s._cb) == (61440, 8704, 1024)
    assert (b.max_anchors, b.max_fragments, b.max_anchors_per_fragment,
            s._nf) == (98304, 1024, 256, 1024)


# ---- store buckets: Database._store_buckets ----

def _stored(name, n_seeds, n_markers, lengths):
    """A stored sketch with the given counts and contigs (its k-mers and
    markers are placeholders: the buckets read only the counts)."""
    S, M = n_seeds + 7, n_markers + 5

    def z(n, t):
        return np.zeros(n, t)
    fields = dict(
        kmers=np.arange(S, dtype=np.uint32), positions=z(S, np.int32),
        contig_ids=z(S, np.int32), strands=z(S, bool),
        own_mult=z(S, np.int32), p_positions=z(S, np.int32),
        p_contig_ids=z(S, np.int32), p_own_mult=z(S, np.int32),
        markers_hi=z(M, np.uint32), markers_lo=np.arange(M, dtype=np.uint32),
        n_seeds=n_seeds, n_markers=n_markers,
        contig_lengths=np.pad(lengths, (0, 16 - len(lengths))),
        n_contigs=len(lengths), total_len=sum(lengths))
    return convert.sketch_from_numpy(
        fields, name, [f"{name}_{i}" for i in range(len(lengths))], lengths,
        device="cpu")


def test_store_buckets():
    """Placed, the counts' buckets (seeds to 8192, markers to 512, the
    largest contig table); streamed, the buckets of the largest total."""
    db = pyskani_tpu_torch.Database(device="cpu")
    for args in (("g0", 5000, 600, [30_000, 20_000]),
                 ("g1", 9000, 300, [1000] * 9),
                 ("g2", 100, 1100, [2_000_000])):
        db._register_sketch(_stored(*args))
    names = ["g0", "g1", "g2"]
    assert db._store_buckets(names, streamed=False) == (16384, 1536, 16)
    assert db._store_buckets(names, streamed=True) == (21504, 3584, 16)
    _, stack, bucket, mbucket = db._ref_stack()
    assert (bucket, mbucket, stack.contig_lengths.shape[1]) == \
        (16384, 1536, 16)
    for streamed, want in ((None, (16384, 1536, 16, (32768, 128, 256))),
                           (2, (21504, 3584, 16, (40960, 128, 256)))):
        s = ShardedDatabaseSearch(db, make_mesh(device="cpu"),
                                  stream_refs_per_device=streamed)
        b = s._budgets
        assert (s._bucket, s._mbucket, s._cb, (
            b.max_anchors, b.max_fragments,
            b.max_anchors_per_fragment)) == want


# ---- the hit rule: hit.screened_hits ----

MAF = params.CommandParams().min_aligned_frac
EST = dict(
    # float32 0.1 lies above the float64 floor, the float below it not
    ani_mean=np.array([0.98, np.nextafter(np.float32(0.1), 0), 0.1, 1.2,
                       0.97, 0.96], np.float32),
    ani_robust=np.array([0.5, 0.5, 0.5, 0.5, 0.05, 0.5], np.float32),
    ani_median=np.array([0.9, 0.9, 0.9, 0.9, 0.9, 0.09], np.float32),
    af_query=np.array([MAF, 0.9, 0.9, 0.9, 0.0, 0.9], np.float32),
    af_ref=np.array([0.0, 0.9, 0.9, 0.9, np.nextafter(np.float32(MAF), 0),
                     0.9], np.float32))


@pytest.mark.parametrize("median,robust,kept", [
    (False, False, [0, 2, 3, 5]), (False, True, [0, 1, 2, 3, 5]),
    (True, False, [0, 1, 2, 3]), (True, True, [0, 1, 2, 3])])
def test_hit_rule_floor_keep_and_clamp(median, robust, kept):
    names = [f"r{i}" for i in range(6)]
    hits, idx, corrected = hit.screened_hits(
        EST, ["q"] * 6, names, 125, False, median, robust, "cpu")
    assert idx.tolist() == kept and not corrected
    key = hit.estimator_key(median, robust)
    assert [h.reference_name for h in hits] == [names[i] for i in kept]
    assert [h.identity for h in hits] == \
        [float(np.float32(min(float(EST[key][i]), 1.0))) for i in kept]


def test_hit_rule_corrects_the_mean_only():
    """By default at c = 125 the learned model corrects the mean, in one
    batch; the median is never corrected, nor is anything at c = 60.  CI
    bounds are clamped as the ANI is."""
    est = dict(EST, ani_ci_low=np.full(6, -0.5, np.float32),
               ani_ci_high=np.full(6, 1.5, np.float32))
    args = (["q"] * 6, [f"r{i}" for i in range(6)])
    want = np.clip(regression.apply_model_batch(
        regression.get_model(125, True), EST["ani_mean"], EST["af_query"],
        EST["af_ref"]), 0.0, 1.0)
    auto, idx, on = hit.screened_hits(est, *args, 125, None, False, False,
                                      "cpu")
    assert on and [h.identity for h in auto] == \
        [float(np.float32(want[i])) for i in idx]
    _, _, med = hit.screened_hits(est, *args, 125, True, True, False, "cpu")
    _, _, low_c = hit.screened_hits(est, *args, 60, None, False, False,
                                    "cpu")
    assert not med and not low_c
    assert all((h.ci_low, h.ci_high) == (0.0, 1.0) for h in auto)
