"""Port ``Database`` vs the JAX package's on synthetic genomes.

Hits must be equal: the same references in the same order, identities
and aligned fractions within 1e-6.  A store sketched by the JAX package
and carried across with ``convert`` gives the same hits.  Paths the port
does not implement yet raise ``NotImplementedError``.
"""

import jax
import numpy as np
import pytest
import torch

import pyskani_tpu
import pyskani_tpu_torch
from conftest import mutate, random_genome
from pyskani_tpu_torch import convert
from pyskani_tpu_torch import database as tdb
from pyskani_tpu_torch.ops.screen import screen_batch

torch.set_num_threads(1)

MODES = {"default": {}, "learned": dict(learned_ani=True),
         "raw": dict(learned_ani=False), "robust": dict(robust=True),
         "median": dict(median=True)}


def _revcomp(s: bytes) -> bytes:
    return s[::-1].translate(bytes.maketrans(b"ACGT", b"TGCA"))


@pytest.fixture(scope="module")
def genomes():
    rng = np.random.default_rng(17)
    base1 = random_genome(rng, 150_000)
    base2 = random_genome(rng, 120_000)
    m2 = mutate(rng, base2, 0.02)
    refs = [
        ("near", [mutate(rng, base1, 0.01)]),
        ("far", [mutate(rng, base1, 0.04, 0.002)]),
        ("multi", [m2[:50_000], _revcomp(m2[50_000:90_000]), m2[90_000:]]),
        ("unrelated", [random_genome(rng, 100_000)]),
    ]
    queries = [("q1", [mutate(rng, base1, 0.02)]),
               ("q2", [mutate(rng, base2, 0.015)])]
    return refs, queries


@pytest.fixture(scope="module")
def dbs(genomes):
    refs, _ = genomes
    jdb = pyskani_tpu.Database()
    tdb_ = pyskani_tpu_torch.Database(device="cpu")
    for name, contigs in refs:
        jdb.sketch(name, *contigs)
        tdb_.sketch(name, *contigs)
    return jdb, tdb_


def _assert_same_hits(got, want):
    assert [h.reference_name for h in got] == \
        [h.reference_name for h in want]
    for g, w in zip(got, want):
        assert g.query_name == w.query_name
        for attr in ("identity", "query_fraction", "reference_fraction"):
            assert getattr(g, attr) == pytest.approx(getattr(w, attr),
                                                     abs=1e-6), attr


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("qi", [0, 1])
def test_hits_match_jax(genomes, dbs, mode, qi):
    _, queries = genomes
    jdb, tdb_ = dbs
    name, contigs = queries[qi]
    want = jdb.query(name, *contigs, **MODES[mode])
    got = tdb_.query(name, *contigs, **MODES[mode])
    _assert_same_hits(got, want)
    assert len(got) >= 1
    assert "unrelated" not in {h.reference_name for h in got}


def test_unrelated_is_screened_out(genomes, dbs):
    _, queries = genomes
    _, tdb_ = dbs
    q = tdb.sketch_genome_device("q1", queries[0][1], tdb_._params,
                                 device="cpu").device
    hi, lo, counts = tdb_._marker_matrix()
    passes, _ = screen_batch(q.markers_hi, q.markers_lo, q.n_markers, hi,
                             lo, counts, 0.8, marker_k=21, rescue_small=True)
    names = [m.name for m in tdb_._markers]
    assert passes.tolist() == [n in ("near", "far") for n in names]


def test_jax_sketched_store_gives_same_hits(genomes, dbs):
    """A store sketched by the JAX package, carried across as numpy."""
    _, queries = genomes
    jdb, _ = dbs
    port = pyskani_tpu_torch.Database(device="cpu")
    for m in jdb._markers:
        h = jdb._storage.load(m.name)
        port._register_sketch(convert.sketch_from_numpy(
            jax.device_get(h.device), h.name, h.contig_names, h.lengths,
            device="cpu"))
    for name, contigs in queries:
        _assert_same_hits(port.query(name, *contigs, learned_ani=False),
                          jdb.query(name, *contigs, learned_ani=False))


def test_convert_round_trip(genomes):
    refs, _ = genomes
    host = tdb.sketch_genome_device("multi", refs[2][1], tdb.SketchParams(),
                                    device="cpu")
    fields = convert.sketch_to_numpy(host)
    back = convert.sketch_from_numpy(fields, host.name, host.contig_names,
                                     host.lengths, device="cpu")
    for f, arr in fields.items():
        assert torch.equal(getattr(back.device, f), getattr(host.device, f)), f
    assert fields["kmers"].dtype == np.uint32
    assert back.contig_names == host.contig_names == \
        ["multi_0", "multi_1", "multi_2"]


@pytest.mark.parametrize("ref_seeds,query_seed", [
    ((False,), True), ((False, True), True), ((False, True), False)])
def test_seedless_sketches_match_jax(ref_seeds, query_seed):
    """``seed=False`` sketches screen but never chain (a store of only
    such sketches has an empty seed table)."""
    rng = np.random.default_rng(3)
    g = random_genome(rng, 60_000)
    q = mutate(rng, g, 0.01)
    jdb = pyskani_tpu.Database()
    port = pyskani_tpu_torch.Database(device="cpu")
    for i, flag in enumerate(ref_seeds):
        jdb.sketch(f"r{i}", g, seed=flag)
        port.sketch(f"r{i}", g, seed=flag)
    want = jdb.query("q", q, seed=query_seed, learned_ani=False)
    _assert_same_hits(port.query("q", q, seed=query_seed, learned_ani=False),
                      want)
    assert len(want) == int(query_seed and any(ref_seeds))


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert pyskani_tpu_torch.Database().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pyskani_tpu_torch.Database()


def test_empty_database_and_api_surface():
    db = pyskani_tpu_torch.Database(device="cpu", compression=200)
    assert db.compression == 200 and db.marker_compression == 1000
    assert db.path is None
    assert db.query("q", b"ACGT" * 100) == []
    with db as same:
        same.sketch("tiny", b"ATGC" * 100)
    with pytest.raises(KeyError):
        db._storage.load("nope")


@pytest.mark.parametrize("call", [
    "path", "open", "load", "save", "sketch_many", "est_ci", "k", "giant",
    "fallback"])
def test_not_ported_paths_raise(call, monkeypatch, tmp_path):
    db = pyskani_tpu_torch.Database(device="cpu")
    db.sketch("a", random_genome(np.random.default_rng(3), 20_000))
    calls = {
        "path": lambda: pyskani_tpu_torch.Database(tmp_path, device="cpu"),
        "open": lambda: pyskani_tpu_torch.Database.open(tmp_path),
        "load": lambda: pyskani_tpu_torch.Database.load(tmp_path),
        "save": lambda: db.save(tmp_path),
        "sketch_many": lambda: db.sketch_many([("b", [b"ACGT" * 100])]),
        "est_ci": lambda: db.query("q", b"ACGT" * 100, est_ci=True),
        "k": lambda: pyskani_tpu_torch.Database(k=16, device="cpu"),
    }
    if call == "giant":
        monkeypatch.setattr(tdb, "sketch_genome_device",
                            _small_buffer(tdb.sketch_genome_device))
        calls["giant"] = lambda: db.sketch("g", b"ACGT" * 1000)
    if call == "fallback":
        # a reference past the packed grid range goes to the full-range
        # per-pair path, which is not ported
        monkeypatch.setattr(tdb, "_partition_blockable",
                            lambda by_name, sl, qt: ([], list(sl), 8, 0))
        q = random_genome(np.random.default_rng(3), 20_000)
        calls["fallback"] = lambda: db.query("q", q)
    with pytest.raises(NotImplementedError, match="not ported|to port"):
        calls[call]()


def _small_buffer(fn):
    def wrapped(*a, **kw):
        return fn(*a, max_buffer=1024, **kw)
    return wrapped
