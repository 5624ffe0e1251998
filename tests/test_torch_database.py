"""Port ``Database`` vs the JAX package's on synthetic genomes.

Hits must be equal: the same references in the same order, identities
and aligned fractions within 1e-6.  A store sketched by the JAX package
and carried across with ``convert`` gives the same hits.  References past
the packed block-grid range, queries of 2^30 bp or more and genomes above
the sketch buffer take the full-range per-pair path or chunked sketching,
as in the JAX package.  Other k: ``tests/test_torch_generic_k.py``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import pyskani_tpu
import pyskani_tpu_torch
from conftest import mutate, random_genome
from pyskani_tpu_torch import convert
from pyskani_tpu_torch import database as tdb
from pyskani_tpu_torch.ops.chain import packed_cap
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


def test_package_surface_matches_jax():
    """``SKANI_VERSION`` and ``__build__`` as the JAX package exports them
    (backend ``torch/cuda``), and the typed surface shipped beside them."""
    import ast
    import os
    assert pyskani_tpu_torch.SKANI_VERSION == pyskani_tpu.SKANI_VERSION
    assert pyskani_tpu_torch.__build__ == dict(
        pyskani_tpu.__build__, backend="torch/cuda")
    assert set(pyskani_tpu_torch.__all__) == set(pyskani_tpu.__all__)
    pkg = os.path.dirname(pyskani_tpu_torch.__file__)
    assert os.path.exists(os.path.join(pkg, "py.typed"))
    with open(os.path.join(pkg, "__init__.pyi")) as f:
        stub = ast.parse(f.read())
    classes = {n.name: {m.name for m in n.body
                        if isinstance(m, ast.FunctionDef)}
               for n in stub.body if isinstance(n, ast.ClassDef)}
    for name, methods in classes.items():
        cls = getattr(pyskani_tpu_torch, name)
        assert all(hasattr(cls, m) for m in methods), name
    assert set(classes) == {"Sketch", "Hit", "Database"}


@pytest.mark.parametrize("qi", [0, 1])
def test_sketch_many_matches_jax_and_per_genome(genomes, dbs, qi):
    """A store built by ``sketch_many`` (batched passes) gives the JAX
    package's ``sketch_many`` store's hits, and the hits of the port's
    store built genome by genome."""
    refs, queries = genomes
    _, per_genome = dbs
    jdb = pyskani_tpu.Database()
    jdb.sketch_many(refs)
    port = pyskani_tpu_torch.Database(device="cpu")
    port.sketch_many(iter(refs))
    assert [m.name for m in port._markers] == [n for n, _ in refs]
    name, contigs = queries[qi]
    got = port.query(name, *contigs, learned_ani=False)
    assert len(got) >= 1
    _assert_same_hits(got, jdb.query(name, *contigs, learned_ani=False))
    _assert_same_hits(got, per_genome.query(name, *contigs,
                                            learned_ani=False))


def _small_buffer(fn, max_buffer):
    def wrapped(*a, **kw):
        return fn(*a, max_buffer=max_buffer, **kw)
    return wrapped


def test_chunked_sketches_give_same_hits(genomes, dbs, monkeypatch):
    """Genomes above the sketch buffer (shrunk to 40 kb here) are
    sketched in chunked calls, store and query alike: the same hits."""
    refs, queries = genomes
    jdb, _ = dbs
    monkeypatch.setattr(tdb, "sketch_genome_device",
                        _small_buffer(tdb.sketch_genome_device, 40_000))
    port = pyskani_tpu_torch.Database(device="cpu")
    for name, contigs in refs:
        port.sketch(name, *contigs)
    for name, contigs in queries:
        _assert_same_hits(port.query(name, *contigs, learned_ani=False),
                          jdb.query(name, *contigs, learned_ani=False))


def _split(genome: bytes, n: int):
    step = -(-len(genome) // n)
    return [genome[i:i + step] for i in range(0, len(genome), step)]


def test_giant_contig_fallback_matches_jax():
    """A reference whose contig is past the packed range (the cap shrunk
    by a related 4100-contig draft in the shortlist) takes the full-range
    per-pair path while the draft chains on the block path: the hits
    equal the JAX package's, and the rerouted hit equals the one a store
    without the draft gives on the block path."""
    rng = np.random.default_rng(23)
    base = random_genome(rng, 600_000)
    draft = _split(mutate(rng, base, 0.04), 600) + \
        [random_genome(rng, 1000) for _ in range(3500)]
    q = mutate(rng, base, 0.01)
    assert len(base) >= packed_cap(8192)

    control = pyskani_tpu_torch.Database(device="cpu")
    control.sketch("giant", base)
    jdb = pyskani_tpu.Database()
    port = pyskani_tpu_torch.Database(device="cpu")
    for db in (jdb, port):
        db.sketch("giant", base)
        db.sketch("draft", *draft)
    by_name = {m.name: m for m in port._markers}
    block, fb, cb, _ = tdb._partition_blockable(by_name, ["giant", "draft"])
    assert (block, fb, cb) == (["draft"], ["giant"], 8192)
    want = jdb.query("q", q)
    got = port.query("q", q)
    _assert_same_hits(got, want)
    assert [h.reference_name for h in got] == ["giant", "draft"]
    _assert_same_hits(got[:1], control.query("q", q))


def test_block_chunk_padding_skips_rerouted_store_head():
    """Store index 0 is a complete genome past the packed range and three
    4100-contig drafts chain on the block path in one chunk of four, so
    the chunk is padded.  The padding reference is the first draft, never
    store index 0, whose positions would overflow the block grid: the
    query returns every hit, the complete genome's equal to a store of it
    alone and the drafts' equal to the JAX package's on a store of the
    drafts alone (where it, too, pads with the first draft)."""
    rng = np.random.default_rng(31)
    base = random_genome(rng, 560_000)
    drafts = [(f"d{i}", _split(mutate(rng, base, 0.02 + 0.01 * i), 600) +
               [random_genome(rng, 150) for _ in range(3500)])
              for i in range(3)]
    q = mutate(rng, base, 0.01)
    assert len(base) >= packed_cap(8192)

    control = pyskani_tpu_torch.Database(device="cpu")
    control.sketch("giant", base)
    port = pyskani_tpu_torch.Database(device="cpu")
    port.sketch("giant", base)
    jdb = pyskani_tpu.Database()
    for name, contigs in drafts:
        port.sketch(name, *contigs)
        jdb.sketch(name, *contigs)
    by_name = {m.name: m for m in port._markers}
    block, fb, cb, _ = tdb._partition_blockable(by_name, list(by_name))
    assert (block, fb, cb) == (["d0", "d1", "d2"], ["giant"], 8192)
    got = port.query("q", q, learned_ani=False)
    assert [h.reference_name for h in got] == ["giant", "d0", "d1", "d2"]
    _assert_same_hits(got[:1], control.query("q", q, learned_ani=False))
    _assert_same_hits(got[1:], jdb.query("q", q, learned_ani=False))


@pytest.fixture(scope="module")
def giant_setup():
    """JAX and port stores of two related references, a control query
    and a >= 2.2 Gbp query fabricated around the control's sketch: the
    control's contig placed after 30 seedless pad contigs of 56 Mbp, 10
    more after it.  Coarse 200 kb fragments keep the giant's grid small;
    the control uses the same config."""
    from test_giant_query import _embed_giant

    rng = np.random.default_rng(29)
    base = random_genome(rng, 500_000)
    m = mutate(rng, base, 0.03)
    refs = [("near", [mutate(rng, base, 0.01)]),
            ("multi", [m[:200_000], _revcomp(m[200_000:350_000]),
                       m[350_000:]])]
    q = mutate(rng, base, 0.02)
    jdb = pyskani_tpu.Database()
    port = pyskani_tpu_torch.Database(device="cpu")
    for db in (jdb, port):
        db._chain_cfg = dataclasses.replace(db._chain_cfg,
                                            fragment_length=200_000)
        for name, contigs in refs:
            db.sketch(name, *contigs)
    q_sk = pyskani_tpu.database.sketch_genome_device("q", [q], jdb._params)
    giant = _embed_giant(q_sk, pre=30, post=10, pad_len=56_000_000)
    assert giant.total_len >= 2_200_000_000
    giant_port = convert.sketch_from_numpy(
        jax.device_get(giant.device), giant.name, giant.contig_names,
        giant.lengths, device="cpu")
    return jdb, port, q, q_sk, giant, giant_port


def test_giant_query_matches_jax(giant_setup, monkeypatch):
    """A >= 2^30 bp query goes through ``Database.query`` (every
    reference on the per-pair path) and gives the JAX package's hits:
    identity and reference fraction within 1e-6, query fraction within
    1e-6 relative (the JAX package sums the contig lengths in f32).  It
    equals the control query's hits, the query fraction scaled by the
    total-length ratio."""
    jdb, port, q, q_sk, giant, giant_port = giant_setup
    control = port.query("q", q, learned_ani=False)
    assert len(control) == 2
    monkeypatch.setattr(pyskani_tpu.database, "sketch_genome_device",
                        lambda *a, **k: giant)
    monkeypatch.setattr(tdb, "sketch_genome_device",
                        lambda *a, **k: giant_port)
    want = jdb.query("qgiant", b"A" * 600, learned_ani=False)
    got = port.query("qgiant", b"A" * 600, learned_ani=False)
    assert [h.reference_name for h in got] == \
        [h.reference_name for h in want] == ["near", "multi"]
    scale = q_sk.total_len / giant.total_len
    for g, w, c in zip(got, want, control):
        assert g.identity == pytest.approx(w.identity, abs=1e-6)
        assert g.reference_fraction == pytest.approx(w.reference_fraction,
                                                     abs=1e-6)
        assert g.query_fraction == pytest.approx(w.query_fraction, rel=1e-6)
        assert abs(g.identity - c.identity) < 2e-6
        assert abs(g.reference_fraction - c.reference_fraction) < 2e-6
        assert g.query_fraction == pytest.approx(c.query_fraction * scale,
                                                 rel=1e-5)


def test_convert_saturates_giant_total(giant_setup):
    """A sketch of 4.3 Gbp or more: ``total_len`` saturates at 2^32-1 in
    both packages and survives the round trip."""
    from test_giant_query import _embed_giant

    _, _, _, q_sk, _, _ = giant_setup
    giant = _embed_giant(q_sk, pre=80, post=0, pad_len=56_000_000)
    assert giant.total_len >= 1 << 32
    fields = jax.device_get(giant.device)
    port = convert.sketch_from_numpy(fields, giant.name, giant.contig_names,
                                     giant.lengths, device="cpu")
    assert port.total_len == giant.total_len
    back = convert.sketch_to_numpy(port)
    assert back["total_len"] == np.uint32(0xFFFFFFFF)
    for f in back:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(fields, f)),
                                      err_msg=f)
    # an unsaturated int64 total saturates on the way out, never wraps
    port.device.total_len = torch.tensor(giant.total_len, dtype=torch.int64)
    assert convert.sketch_to_numpy(port)["total_len"] == \
        np.uint32(0xFFFFFFFF)
