"""``frag_overflow`` on every path of the port: a fragment budget that
truncates either genome of a pair raises, never a silent result.

The JAX package flags anchors past ``max_fragments`` on ``chain_pairs``'
query side only: its ``chain_block`` and ``chain_triangle`` have no such
key, and no path flags a reference's fragments past the budget.  Here the
same numpy-made genomes, sketched by the JAX package, go through both:

* query side: the port's packed flag equals JAX ``chain_pairs``' flag
  pair for pair, and every other key equals JAX's packed outputs
  (integers bit-equal, floats within 1e-6);
* reference side: JAX gives results and no flag on every path; the port
  flags the pair on all three, every other key still equal to JAX's;
* ``check_overflow`` raises through ``Database.query`` (memory and
  ``open``), ``engine.batch.triangle`` and ``stream_one_vs_many``
  (``sharded_triangle`` / ``ring_triangle``:
  ``tests/test_torch_sharded_triangle.py``);
* with the default budgets no pair of any path sets the flag.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import pyskani_tpu
import pyskani_tpu_torch
from conftest import mutate, random_genome
from pyskani_tpu.engine import batch as jax_batch
from pyskani_tpu.oracle.chain import ChainConfig as JaxChainConfig
from pyskani_tpu.ops import chain as jch
from pyskani_tpu.ops.sketch import sketch_genome_device
from pyskani_tpu.params import SketchParams
from pyskani_tpu_torch import convert
from pyskani_tpu_torch.engine import batch as tbatch
from pyskani_tpu_torch.engine.stream import stream_one_vs_many
from pyskani_tpu_torch.ops import chain as tch

torch.set_num_threads(1)

# NF = 3 fragments of 20 kb: 60 kb of each genome fit the grids
SIZES = dict(max_anchors=4096, max_fragments=3, max_anchors_per_fragment=128)
FLOAT_KEYS = ("ani_mean", "ani_robust", "ani_median", "af_query", "af_ref")
OVERFLOW = "fragment budget overflow"


def _port_stack(stack):
    return convert.sketch_from_numpy(jax.device_get(stack), "stack", [], [],
                                     device="cpu").device


def _port_sketch(h):
    return convert.sketch_from_numpy(jax.device_get(h.device), h.name,
                                     h.contig_names, h.lengths, device="cpu")


def _numpy(out):
    return {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in out.items()}


@pytest.fixture(scope="module")
def query_side():
    """Three 40 kb references (2 fragments each: inside the budget) and
    two queries past it: a 50 kb one (3 fragments) and a 100 kb two-contig
    one (6 fragments, the second contig's at 3-5).  Reference r1 is a
    mutant of the root's 40-80 kb, so its anchors land in the long
    query's fragments 2-4, two of them past the budget; r0's in 0-1; r2
    is unrelated.  Returns the genomes (references first) and the JAX
    stack of their sketches."""
    rng = np.random.default_rng(71)
    root = random_genome(rng, 100_000)
    genomes = [
        ("r0", [mutate(rng, root[:40_000], 0.01)]),
        ("r1", [mutate(rng, root[40_000:80_000], 0.01)]),
        ("r2", [random_genome(rng, 40_000)]),
        ("q_short", [mutate(rng, root[:50_000], 0.015)]),
        ("q_long", [mutate(rng, root[:55_000], 0.02),
                    mutate(rng, root[55_000:], 0.02)]),
    ]
    sk = [sketch_genome_device(n, c, SketchParams()) for n, c in genomes]
    return genomes, jax_batch.stack_sketches(sk)


@pytest.fixture(scope="module")
def ref_side():
    """A 100 kb reference (5 fragments: 2 past the budget) and a 40 kb
    query (2 fragments) from the reference's 50-90 kb: the query's chains
    cover the reference's fragments 2-4.  References first."""
    rng = np.random.default_rng(73)
    root = random_genome(rng, 100_000)
    genomes = [("ref_long", [mutate(rng, root, 0.01)]),
               ("q", [mutate(rng, root[50_000:90_000], 0.015)])]
    sk = [sketch_genome_device(n, c, SketchParams()) for n, c in genomes]
    return genomes, jax_batch.stack_sketches(sk)


def _jax_pairs(stack, ri, qi):
    return jax.device_get(jch.chain_pairs(
        jax_batch.take_sketch(stack, np.asarray(ri)),
        jax_batch.take_sketch(stack, np.asarray(qi)), cfg=JaxChainConfig(),
        budgets=jch.EngineBudgets(**SIZES)))


def _port_path(path, stack, refs, queries):
    """(port output, JAX output, JAX chain_pairs output) of ``path`` on the
    JAX ``stack``'s genomes ``refs`` x ``queries`` (chain_block, a flat
    [P] view) or its upper triangle (chain_triangle, chain_pairs)."""
    port = _port_stack(stack)
    budgets = tch.EngineBudgets(**SIZES)
    if path == "chain_block":
        r, q = (jax_batch.take_sketch(stack, np.asarray(x))
                for x in (refs, queries))
        want = jax.device_get(jch.chain_block(
            r, q, cfg=JaxChainConfig(), budgets=jch.EngineBudgets(**SIZES)))
        got = tch.chain_block(_port_stack(r), _port_stack(q),
                              cfg=tch.ChainConfig(), budgets=budgets)
        ri, qi = (x.reshape(-1) for x in np.meshgrid(refs, queries,
                                                     indexing="ij"))
        flat = {k: np.asarray(v).reshape(len(ri)) for k, v in want.items()}
        got = {k: v.reshape(len(ri)) for k, v in got.items()}
        return _numpy(got), flat, _jax_pairs(stack, ri, qi)
    G = stack.kmers.shape[0]
    ri, qi = tch.triu_pairs(G)
    if path == "chain_triangle":
        want = jax.device_get(jch.chain_triangle(
            stack, cfg=JaxChainConfig(), budgets=jch.EngineBudgets(**SIZES)))
        got = tch.chain_triangle(port, cfg=tch.ChainConfig(),
                                 budgets=budgets)
    else:
        want = _jax_pairs(stack, ri, qi)
        got = tch.chain_pairs(
            tbatch.take_sketch(port, torch.from_numpy(ri).long()),
            tbatch.take_sketch(port, torch.from_numpy(qi).long()),
            cfg=tch.ChainConfig(), budgets=budgets)
    return _numpy(got), {k: np.asarray(v) for k, v in want.items()}, \
        _jax_pairs(stack, ri, qi)


def _assert_rest_equal(got, want):
    """Every key but ``frag_overflow`` equal to JAX's (floats 1e-6)."""
    assert set(got) - {"frag_overflow"} == set(want) - {"frag_overflow"}
    for key, w in want.items():
        if key == "frag_overflow":
            continue
        assert got[key].shape == w.shape, key
        if key in FLOAT_KEYS:
            np.testing.assert_allclose(got[key], w, rtol=0, atol=1e-6,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], w, err_msg=key)


@pytest.mark.parametrize("path", ["chain_block", "chain_triangle"])
def test_query_side_flag_matches_jax_chain_pairs(query_side, path):
    _, stack = query_side
    got, want, pairs = _port_path(path, stack, [0, 1, 2], [3, 4])
    assert "frag_overflow" not in want
    assert not got["anchors_overflow"].any()
    assert not np.asarray(pairs["anchors_overflow"]).any()
    np.testing.assert_array_equal(got["frag_overflow"],
                                  np.asarray(pairs["frag_overflow"]))
    # the flag is set on some pairs only: r1 x q_long, not r0 x q_long;
    # a flagged pair kept some of its anchors, so its estimate is wrong
    # rather than empty
    flagged = got["frag_overflow"]
    assert 0 < flagged.sum() < len(flagged)
    assert (got["n_anchors"][flagged] > 0).all()
    assert (got["n_anchors"][flagged] <
            np.asarray(pairs["n_anchors"])[flagged]).all()
    _assert_rest_equal(got, want)


@pytest.mark.parametrize("path", ["chain_block", "chain_triangle",
                                  "chain_pairs"])
def test_ref_side_flag_where_jax_is_silent(ref_side, path):
    """JAX's reference grid drops the kept chains' anchors and spans in
    reference fragments 3-4 and reports nothing; the port flags it."""
    _, stack = ref_side
    got, want, pairs = _port_path(path, stack, [0], [1])
    assert not np.asarray(pairs["frag_overflow"]).any()
    assert not np.asarray(want.get("frag_overflow", False)).any()
    assert got["frag_overflow"].all()
    assert (want["ani_mean"] > 0.9).all() and (want["n_anchors"] > 0).all()
    _assert_rest_equal(got, want)


def _budgets_patch(monkeypatch, db, budgets):
    """Fixed budgets for every ``query`` of ``db`` (as a caller who sizes
    them by hand gets)."""
    monkeypatch.setattr(db, "_budgets_for",
                        lambda query, shortlist=None: budgets)


@pytest.mark.parametrize("store", ["memory", "open"])
@pytest.mark.parametrize("side", ["query_side", "ref_side"])
def test_database_query_raises(request, tmp_path, monkeypatch, store, side):
    """``Database.query`` with a too-small fragment budget raises on the
    block path, in memory and streamed from ``open``; the JAX Database
    returns hits with the same budgets."""
    genomes, _ = request.getfixturevalue(side)
    refs, queries = (genomes[:3], genomes[4:]) if side == "query_side" \
        else (genomes[:1], genomes[1:])
    db = pyskani_tpu_torch.Database(device="cpu")
    jdb = pyskani_tpu.Database()
    for name, contigs in refs:
        db.sketch(name, *contigs)
        jdb.sketch(name, *contigs)
    if store == "open":
        db.save(tmp_path / "store")
        db = pyskani_tpu_torch.Database.open(tmp_path / "store",
                                             device="cpu")
    budgets = tch.EngineBudgets(max_fragments=3,
                                max_anchors_per_fragment=256)
    _budgets_patch(monkeypatch, db, budgets)
    _budgets_patch(monkeypatch, jdb, jch.EngineBudgets(
        max_fragments=3, max_anchors_per_fragment=256))
    name, contigs = queries[0]
    assert jdb.query(name, *contigs, learned_ani=False)
    with pytest.raises(RuntimeError, match=OVERFLOW):
        db.query(name, *contigs, learned_ani=False)
    monkeypatch.undo()
    assert db.query(name, *contigs, learned_ani=False)


def test_triangle_engine_raises(query_side):
    genomes, stack = query_side
    port = [_port_sketch(h) for h in (
        sketch_genome_device(n, c, SketchParams()) for n, c in genomes)]
    budgets = tch.EngineBudgets(**SIZES)
    with pytest.raises(RuntimeError, match=OVERFLOW):
        tbatch.triangle(port, tch.ChainConfig(), budgets=budgets, group=3)
    # JAX: the same triangle, silent
    jsk = [sketch_genome_device(n, c, SketchParams()) for n, c in genomes]
    jax_batch.triangle(jsk, JaxChainConfig(),
                       budgets=jch.EngineBudgets(**SIZES), group=3)


def test_stream_one_vs_many_carries_flag(query_side):
    """The streamed chunks carry the flag of ``one_vs_many``'s pairs and
    ``check_overflow`` raises on it."""
    genomes, _ = query_side
    hosts = {n: _port_sketch(sketch_genome_device(n, c, SketchParams()))
             for n, c in genomes[:3]}
    q = _port_sketch(sketch_genome_device(*genomes[4], SketchParams()))
    budgets = tch.EngineBudgets(**SIZES)
    qpad = tbatch.repad_sketch(q, 2048, 1024, max_contigs=8)
    names = list(hosts)
    got = stream_one_vs_many(hosts.__getitem__, names, qpad,
                             cfg=tch.ChainConfig(), budgets=budgets,
                             seed_budget=2048, marker_budget=1024, chunk=2)
    mem = tbatch.one_vs_many(
        tbatch.stack_sketches(list(hosts.values()), 2048, 1024), qpad,
        np.arange(3), cfg=tch.ChainConfig(), budgets=budgets, chunk=2)
    np.testing.assert_array_equal(got["frag_overflow"],
                                  mem["frag_overflow"].numpy())
    np.testing.assert_array_equal(got["frag_overflow"], [False, True, False])
    with pytest.raises(RuntimeError, match=OVERFLOW):
        tbatch.check_overflow(got, budgets)


# ---- default budgets: no path sets the flag ----

def _draft(rng, genome: bytes, pieces: int, extra: int):
    step = -(-len(genome) // pieces)
    return [genome[i:i + step] for i in range(0, len(genome), step)] + \
        [random_genome(rng, 150) for _ in range(extra)]


@pytest.fixture(scope="module")
def drafts():
    """A 560 kb complete genome past the packed range of a 4100-contig
    draft's contig bucket, two such drafts of it and a query: the
    fallback store and the mixed triangle of test_torch_database's
    rerouting tests, at their size."""
    rng = np.random.default_rng(31)
    base = random_genome(rng, 560_000)
    genomes = [("complete", [mutate(rng, base, 0.01)])] + \
        [(f"d{i}", _draft(rng, mutate(rng, base, 0.02 + 0.01 * i), 600,
                          3500)) for i in range(2)]
    return genomes, mutate(rng, base, 0.015)


def _family(rng, n: int, length: int):
    root = random_genome(rng, length)
    return [(f"g{i}", [mutate(rng, root, 0.01 + 0.005 * i)])
            for i in range(n)], mutate(rng, root, 0.01)


def _run_search(db, genomes, query):
    for name, contigs in genomes:
        db.sketch(name, *contigs)
    return db.query("q", query, learned_ani=False)


def _case_search(_):
    genomes, q = _family(np.random.default_rng(81), 4, 60_000)
    return _run_search(pyskani_tpu_torch.Database(device="cpu"), genomes, q)


def _case_k21(_):
    genomes, q = _family(np.random.default_rng(83), 4, 60_000)
    return _run_search(pyskani_tpu_torch.Database(k=21, device="cpu"),
                       genomes, q)


def _case_fallback(drafts):
    genomes, q = drafts
    return _run_search(pyskani_tpu_torch.Database(device="cpu"), genomes, q)


def _case_family(_):
    genomes, _ = _family(np.random.default_rng(85), 6, 50_000)
    db = pyskani_tpu_torch.Database(device="cpu")
    db.sketch_many(genomes)
    sk = [db._storage.load(n) for n, _ in genomes]
    return tbatch.triangle(sk, tch.ChainConfig(), group=3)


def _case_mixed(drafts):
    genomes, _ = drafts
    db = pyskani_tpu_torch.Database(device="cpu")
    for name, contigs in genomes:
        db.sketch(name, *contigs)
    return tbatch.triangle([db._storage.load(n) for n, _ in genomes],
                           tch.ChainConfig())


CASES = {"search": (_case_search, {"chain_block"}),
         "fallback": (_case_fallback, {"chain_block", "chain_pairs"}),
         "family": (_case_family, {"chain_triangle", "chain_block"}),
         "mixed_triangle": (_case_mixed, {"chain_triangle", "chain_pairs"}),
         "k21": (_case_k21, {"chain_block"})}


@pytest.mark.parametrize("case", list(CASES))
def test_default_budgets_set_no_flag(request, monkeypatch, case):
    """Every output of every chain path that ran carries ``frag_overflow``
    and no pair sets it; the case produced results."""
    fn, paths = CASES[case]
    seen = {}
    for name in ("chain_block", "chain_pairs", "chain_triangle"):
        def spy(*a, _real=getattr(tbatch, name), _name=name, **kw):
            out = _real(*a, **kw)
            seen.setdefault(_name, []).append(out["frag_overflow"].clone())
            return out
        monkeypatch.setattr(tbatch, name, spy)
    arg = request.getfixturevalue("drafts") \
        if case in ("fallback", "mixed_triangle") else None
    res = fn(arg)
    assert set(seen) == paths
    for name, flags in seen.items():
        for f in flags:
            assert f.dtype == torch.bool and not f.any(), name
    if isinstance(res, tuple):       # a triangle: (ri, qi, outputs)
        assert not res[2]["frag_overflow"].any()
        assert (res[2]["ani_mean"] > 0.9).any()
    else:
        assert res and res[0].identity > 0.9


def test_ci_keeps_flag(query_side):
    """``est_ci`` adds its bounds and leaves the flag as without it."""
    _, stack = query_side
    port = _port_stack(stack)
    budgets = tch.EngineBudgets(**SIZES)
    plain = tch.chain_triangle(port, cfg=tch.ChainConfig(), budgets=budgets)
    ci = tch.chain_triangle(port, cfg=dataclasses.replace(
        tch.ChainConfig(), est_ci=True), budgets=budgets)
    assert torch.equal(plain["frag_overflow"], ci["frag_overflow"])
    assert plain["frag_overflow"].any()
