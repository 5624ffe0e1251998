"""Port's sharded search (``parallel/``) vs the JAX package's.

The JAX functions run here on the 8-virtual-device CPU mesh; the port's
run on spawned gloo ranks (``dist.launch``, ``tests/torch_mesh_worker.py``)
on the same sketches, carried as numpy arrays, and the same on-disk
stores.  Integer planes are bit-equal, floats within 1e-6, hits equal in
names and within 1e-6, at meshes 1x1, 2x1, 2x2 and 4x1.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import pyskani_tpu
import torch_mesh_worker as worker
from conftest import mutate, random_genome
from pyskani_tpu.engine.batch import stack_sketches
from pyskani_tpu.oracle.chain import ChainConfig
from pyskani_tpu.ops.chain import EngineBudgets
from pyskani_tpu.ops.sketch import sketch_genome_device
from pyskani_tpu.parallel import dist as jax_dist
from pyskani_tpu.parallel.mesh import make_mesh as jax_make_mesh
from pyskani_tpu.parallel.search import \
    ShardedDatabaseSearch as JaxShardedSearch
from pyskani_tpu.params import SketchParams
from pyskani_tpu_torch import Database
from pyskani_tpu_torch.ops.sketch import FIELDS
from pyskani_tpu_torch.parallel import dist as tdist
from pyskani_tpu_torch.parallel.mesh import make_mesh
from pyskani_tpu_torch.parallel.search import ShardedDatabaseSearch

torch.set_num_threads(1)

BUDGETS = dict(max_anchors=4096, max_fragments=128,
               max_anchors_per_fragment=128)
INT_KEYS = ("n_anchors", "n_fragments", "anchors_overflow", "frag_overflow",
            "screen_pass", "total_hits", "n_chained")
FLOAT_KEYS = ("ani_mean", "ani_robust", "ani_median", "af_query", "af_ref")
SHAPES = {1: [(1, 1)], 2: [(2, 1)], 4: [(2, 2), (4, 1)]}
MESH_CASES = [(None, None), (None, 2), (2, None), (4, 1), (1, 4), (3, None),
              (2, 3), (8, 1)]


def _jax_mesh(db, batch):
    return jax_make_mesh(db, batch, devices=jax.devices()[:db * batch])


def _fields(stack) -> dict:
    host = jax.device_get(stack)
    return {f: np.asarray(getattr(host, f)) for f in FIELDS}


def _hits(hits):
    return [[(h.reference_name, h.identity, h.query_fraction,
              h.reference_fraction) for h in hs] for hs in hits]


def _assert_same_hits(got, want):
    assert [[h[0] for h in hs] for hs in got] == \
        [[h[0] for h in hs] for hs in want]
    for g, w in zip(got, want):
        if g:
            np.testing.assert_allclose(np.array([h[1:] for h in g]),
                                       np.array([h[1:] for h in w]),
                                       rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def family():
    """The JAX test's family: 12 genomes of 40 kb, 0.5-6% from a root."""
    rng = np.random.default_rng(21)
    base = random_genome(rng, 40_000)
    genomes = [mutate(rng, base, 0.005 + 0.005 * i) for i in range(12)]
    params = SketchParams()
    return [sketch_genome_device(f"g{i}", [g], params,
                                 length_bucket=1 << 16,
                                 seed_budget=1024, marker_budget=512)
            for i, g in enumerate(genomes)]


@pytest.fixture(scope="module")
def unrelated():
    """2 refs related to a query, 6 unrelated (the screen-saving test)."""
    rng = np.random.default_rng(33)
    params = SketchParams()
    base = random_genome(rng, 40_000)
    genomes = [mutate(rng, base, 0.01) for _ in range(2)] + \
        [random_genome(rng, 40_000) for _ in range(6)] + \
        [mutate(rng, base, 0.02)]
    return [sketch_genome_device(f"g{i}", [g], params, length_bucket=1 << 16,
                                 seed_budget=1024, marker_budget=512)
            for i, g in enumerate(genomes)]


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """On-disk stores written by the JAX package, and their queries:
    'restart' (6 refs of 30 kb), 'streamed' (10 refs), 'big' (4 refs of
    28 kb slices of a 1.988 Mbp genome; a 71-contig query)."""
    out = {}
    rng = np.random.default_rng(41)
    base = random_genome(rng, 30_000)
    path = tmp_path_factory.mktemp("restart") / "db"
    db = pyskani_tpu.Database(path)
    for i in range(6):
        db.sketch(f"g{i}", mutate(rng, base, 0.01))
    db.flush()
    out["restart"] = (path, [(f"q{i}", [mutate(rng, base, 0.02)])
                             for i in range(2)])

    rng = np.random.default_rng(43)
    base = random_genome(rng, 30_000)
    path = tmp_path_factory.mktemp("streamed") / "sdb"
    db = pyskani_tpu.Database(path)
    for i in range(10):
        db.sketch(f"g{i}", mutate(rng, base, 0.005 + 0.002 * i))
    db.flush()
    out["streamed"] = (path, [(f"q{i}", [mutate(rng, base, 0.02)])
                              for i in range(3)])

    rng = np.random.default_rng(47)
    base_big = random_genome(rng, 1_988_000)
    slices = [base_big[i * 28_000:(i + 1) * 28_000] for i in range(71)]
    path = tmp_path_factory.mktemp("big") / "bdb"
    db = pyskani_tpu.Database(path)
    for i in range(4):
        db.sketch(f"g{i}", mutate(rng, slices[i], 0.01))
    db.flush()
    out["big"] = (path, [("big", [mutate(rng, s_, 0.02) for s_ in slices]),
                         ("small", [mutate(rng, slices[0], 0.02)])])
    return out


@pytest.fixture(scope="module")
def port(family, unrelated, stores):
    """Every port result, per world size: {world: [rank results]}."""
    refs, queries = _fields(stack_sketches(family[:8])), \
        _fields(stack_sketches(family[8:12]))
    kw = dict(chunk=2, learned_ani=False)
    jobs = {}
    for world, shapes in SHAPES.items():
        j = {"mesh": ("mesh_cases", (MESH_CASES,))}
        for shape in shapes:
            j[("step", shape)] = ("search_step",
                                  (shape, refs, queries, BUDGETS, 2))
            path, qs = stores["restart"]
            j[("restart", shape)] = ("searcher_hits",
                                     (shape, path, "load", qs, kw))
        jobs[world] = j
    jobs[4]["screen"] = ("search_step", (
        (4, 1), _fields(stack_sketches(unrelated[:8])),
        _fields(stack_sketches(unrelated[8:9])), BUDGETS, 1))
    path, qs = stores["streamed"]
    jobs[4]["memory"] = ("searcher_hits", ((4, 1), path, "load", qs, kw))
    jobs[4]["open"] = ("searcher_hits", ((4, 1), path, "open", qs,
                                         dict(kw, stream_refs_per_device=1)))
    path, qs = stores["big"]
    jobs[2]["big"] = ("searcher_hits", ((2, 1), path, "load", qs,
                                        dict(kw, cutoff=0.01)))
    return {w: tdist.launch(worker.run_all, w, (j,), device="cpu",
                            timeout=400) for w, j in jobs.items()}


def _rank0(port, world, key):
    """Rank 0's result; every rank must have the same."""
    results = [r[key] for r in port[world]]
    for r in results[1:]:
        np.testing.assert_equal(r, results[0])
    return results[0]


@pytest.mark.parametrize("world", [1, 2, 4])
def test_make_mesh_matches_jax(port, world):
    """Shapes, the rank's place (device r of JAX's reshaped array) and the
    ValueError of db * batch != world."""
    for rank, res in enumerate(r["mesh"] for r in port[world]):
        for (db, batch), got in zip(MESH_CASES, res):
            try:
                m = jax_make_mesh(db, batch, devices=jax.devices()[:world])
            except ValueError as e:
                assert got == f"ValueError: {e}"
                continue
            shape, coords = got
            assert shape == (m.shape["db"], m.shape["batch"])
            i, j = np.argwhere(m.devices == jax.devices()[rank])[0]
            assert coords == {"db": i, "batch": j}


def test_make_mesh_in_one_process():
    """Without a process group the world is this process: a 1 x 1 mesh on
    the asked device; the default device is the card."""
    m = make_mesh(device="cpu")
    assert (m.shape, m.size, m.rank, m.distributed) == \
        ({"db": 1, "batch": 1}, 1, 0, False)
    assert m.device == torch.device("cpu")
    with pytest.raises(ValueError, match="mesh 2x0 != 1 devices"):
        make_mesh(2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh()


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (2, 2), (4, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_shard_invariance_matches_jax(family, port, shape):
    refs = stack_sketches(family[:8])
    queries = stack_sketches(family[8:12])
    step = jax_dist.make_sharded_search(_jax_mesh(*shape), ChainConfig(),
                                        EngineBudgets(**BUDGETS), chunk=2)
    want = jax.device_get(step(jax_dist.shard_leading(_jax_mesh(*shape),
                                                      refs, "db"),
                               jax_dist.shard_leading(_jax_mesh(*shape),
                                                      queries, "batch")))
    got = _rank0(port, shape[0] * shape[1], ("step", shape))
    assert set(got) == set(want)
    assert got["ani_mean"].shape == (8, 4)
    assert got["screen_pass"].all()
    for k in INT_KEYS:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    for k in FLOAT_KEYS:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0,
                                   atol=1e-6, err_msg=k)


def test_screen_saves_compute_matches_jax(unrelated, port):
    """Only the 2 related references pass and are chained; the other
    pairs read 0 on every plane."""
    step = jax_dist.make_sharded_search(_jax_mesh(4, 1), ChainConfig(),
                                        EngineBudgets(**BUDGETS), chunk=1)
    mesh = _jax_mesh(4, 1)
    want = jax.device_get(step(
        jax_dist.shard_leading(mesh, stack_sketches(unrelated[:8]), "db"),
        jax_dist.shard_leading(mesh, stack_sketches(unrelated[8:9]),
                               "batch")))
    got = _rank0(port, 4, "screen")
    sp = got["screen_pass"]
    assert int(got["n_chained"][0]) == int(sp.sum()) <= 2
    for k in INT_KEYS:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(got["ani_mean"], np.asarray(want["ani_mean"]),
                               rtol=0, atol=1e-6)
    assert (got["ani_mean"][~sp] == 0).all()
    assert (got["n_anchors"][~sp] == 0).all()


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (2, 2), (4, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_restart_reshard_matches_jax(stores, port, shape):
    """The on-disk store is the checkpoint: reloaded on any mesh shape,
    the port's hits equal the JAX searcher's on its 4 x 2 mesh."""
    path, queries = stores["restart"]
    s = JaxShardedSearch(pyskani_tpu.Database.load(path), _jax_mesh(4, 2),
                         chunk=2, learned_ani=False)
    want = _hits(s.query_many(queries))
    got, _, _ = _rank0(port, shape[0] * shape[1], ("restart", shape))
    _assert_same_hits(got, want)
    assert all(len(hs) == 6 for hs in got)


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (2, 2), (4, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_memory_shard_scales_with_db(port, shape):
    """Over a memory store each rank places only its ``db`` shard: ceil(R
    / db) rows (the 6-genome store pads to a multiple of db), in storages
    that hold no more than those rows, and no whole-store stack is cached
    on the Database."""
    db = shape[0]
    rows1, bytes1, _, _ = _rank0(port, 1, ("restart", (1, 1)))[2]
    for r in port[db * shape[1]]:
        rows, storage, nbytes, cached = r[("restart", shape)][2]
        assert rows == -(-6 // db)
        assert storage == nbytes == bytes1 // rows1 * rows
        assert not cached


def test_streamed_sharded_search_matches_memory(stores, port):
    """An ``open`` store streams in 3 chunks of 4 references through a
    4 x 1 mesh: hits equal the memory store's and the JAX searcher's."""
    path, queries = stores["streamed"]
    mem, n_mem, _ = _rank0(port, 4, "memory")
    got, n_chunks, placed = _rank0(port, 4, "open")
    assert placed is None
    assert (n_mem, n_chunks) == (1, 3)
    _assert_same_hits(got, mem)
    s = JaxShardedSearch(pyskani_tpu.Database.load(path), _jax_mesh(4, 1),
                         chunk=2, learned_ani=False)
    _assert_same_hits(got, _hits(s.query_many(queries)))
    assert all(len(hs) == 10 for hs in got)


def test_sharded_search_oversized_query_fallback(stores, port):
    """A query past the searcher's fragment budget takes Database.query
    (on one rank, its hits all-gathered); the other query the mesh."""
    path, queries = stores["big"]
    got, _, _ = _rank0(port, 2, "big")
    s = JaxShardedSearch(pyskani_tpu.Database.load(path), _jax_mesh(2, 1),
                         chunk=2, learned_ani=False, cutoff=0.01)
    nfrag = sum(max(1, -(-len(c) // s._fl)) for c in queries[0][1])
    assert nfrag + 2 > s._nf, "fixture must exceed the searcher budget"
    want = _hits(s.query_many(queries))
    assert len(got) == 2 and len(got[0]) == 4
    _assert_same_hits(got, want)
    assert "g0" in {h[0] for h in got[1]}


def test_frag_overflow_raises_where_jax_is_silent(stores):
    """Anchors past the fragment budget truncate a pair's estimate.  The
    port's searcher gathers ``frag_overflow`` and raises, as every other
    path does; the JAX searcher drops that plane and returns hits."""
    path, queries = stores["streamed"]
    port_s = ShardedDatabaseSearch(Database.load(path, device="cpu"),
                                   make_mesh(device="cpu"), chunk=2,
                                   learned_ani=False)
    jax_s = JaxShardedSearch(pyskani_tpu.Database.load(path),
                             _jax_mesh(1, 1), chunk=2, learned_ani=False)
    for s, make, cfg in (
            (port_s, tdist.make_sharded_search, port_s._db._chain_cfg),
            (jax_s, jax_dist.make_sharded_search, jax_s._db._chain_cfg)):
        # 30 kb queries span 2 fragments of 20 kb; the budget holds 1
        s._budgets = dataclasses.replace(s._budgets, max_fragments=1)
        s._step = make(s._mesh, cfg, s._budgets, chunk=2)
    assert len(jax_s.query_many(queries[:1])) == 1
    with pytest.raises(RuntimeError, match="fragment budget overflow"):
        port_s.query_many(queries[:1])


def test_aligned_fraction_floor_is_command_params(stores, monkeypatch):
    """The port's searcher takes the aligned-fraction floor from
    CommandParams, as Database.query does (the JAX searcher writes 0.15,
    which is also CommandParams' default).  With the floor raised past
    some hits' fractions, those hits drop out of both, and the two agree
    hit for hit."""
    import functools

    from pyskani_tpu_torch import database, params
    from pyskani_tpu_torch.parallel import search

    path, queries = stores["streamed"]
    db = Database.load(path, device="cpu")
    s = ShardedDatabaseSearch(db, make_mesh(device="cpu"), chunk=2,
                              learned_ani=False)
    before = _hits(s.query_many(queries))
    fracs = sorted(max(h[2], h[3]) for hs in before for h in hs)
    floor = (fracs[0] + fracs[-1]) / 2
    assert fracs[0] >= params.CommandParams().min_aligned_frac
    raised = functools.partial(params.CommandParams,
                               min_aligned_frac=floor)
    monkeypatch.setattr(search, "CommandParams", raised)
    monkeypatch.setattr(database, "CommandParams", raised)
    got = _hits(s.query_many(queries))
    want = [[h for h in hs if max(h[2], h[3]) >= floor] for hs in before]
    assert 0 < sum(map(len, got)) < sum(map(len, before))
    assert got == want
    _assert_same_hits(got, _hits(
        [db.query(n, *cs, learned_ani=False) for n, cs in queries]))
