"""The est_ci bootstrap interval of the port vs the JAX package.

``ani_ci_low`` / ``ani_ci_high`` of ``chain_block``, ``chain_pairs`` and
``chain_triangle`` on the test_block_join family within 1e-6 of JAX
(the resample indices are JAX's, ``ops/prng.py``; only f32 summation
order may differ), every other key equal to the port's run without the
interval; ``Database.query(est_ci=True)`` against JAX; ports of
``tests/test_ci.py``'s cases; and the CLI's ``--ci`` rows against the
JAX CLI's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyskani_tpu
import pyskani_tpu_torch
from conftest import mutate, random_genome
from pyskani_tpu import cli as jax_cli
from pyskani_tpu.engine.batch import stack_sketches, take_sketch
from pyskani_tpu.oracle.chain import ChainConfig as JaxChainConfig
from pyskani_tpu.ops import chain as jch
from pyskani_tpu.ops.sketch import sketch_genome_device
from pyskani_tpu.params import SketchParams
from pyskani_tpu_torch import cli, convert
from pyskani_tpu_torch.ops import chain as tch

torch.set_num_threads(1)

SIZES = dict(max_anchors=4096, max_fragments=64, max_anchors_per_fragment=128)
CI_KEYS = ("ani_ci_low", "ani_ci_high")


@pytest.fixture(scope="module")
def family():
    """(JAX stack, port stack): the test_block_join family (a 60 kb base,
    mutants at 1% and 3%, a 2-contig mutant, an unrelated genome)."""
    rng = np.random.default_rng(5)
    base = random_genome(rng, 60_000)
    genomes = [
        ("base", [base]),
        ("mut1", [mutate(rng, base, 0.01)]),
        ("mut2", [mutate(rng, base, 0.03)]),
        ("multi", [mutate(rng, base[:30_000], 0.02),
                   mutate(rng, base[30_000:], 0.02)]),
        ("unrelated", [random_genome(rng, 60_000)]),
    ]
    stack = stack_sketches([
        sketch_genome_device(n, c, SketchParams(), seed_budget=1024,
                             marker_budget=512, length_bucket=1 << 16,
                             max_contigs=8) for n, c in genomes])
    port = convert.sketch_from_numpy(jax.device_get(stack), "stack", [], [],
                                     device="cpu").device
    return stack, port


def _check(got: dict, plain: dict, want: dict):
    """CI keys within 1e-6 of JAX; the rest equal the run without CI
    (``frag_overflow`` too, a key the JAX packed paths lack)."""
    assert set(got) == set(plain) | set(CI_KEYS) == \
        set(want) | {"frag_overflow"}
    assert not got["frag_overflow"].any()
    for key in CI_KEYS:
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.dtype == np.float32 and g.shape == w.shape, key
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=key)
    for key, p in plain.items():
        assert torch.equal(got[key], p), key
    lo, hi = got["ani_ci_low"].numpy(), got["ani_ci_high"].numpy()
    mean = got["ani_mean"].numpy()
    cov = got["n_fragments"].numpy() > 0
    assert cov.any() and (~cov).any()
    assert (lo[~cov] == 0).all() and (hi[~cov] == 0).all()
    assert (lo[cov] <= mean[cov] + 1e-6).all()
    assert (mean[cov] <= hi[cov] + 1e-6).all()
    assert (hi[cov] - lo[cov] > 0).any()


@pytest.mark.parametrize("est_side", ["both", "chunk"])
def test_chain_block_ci_matches_jax(family, est_side):
    jstack, tstack = family
    budgets = tch.EngineBudgets(**SIZES)
    cfg = tch.ChainConfig(est_side=est_side)
    want = jax.device_get(jch.chain_block(
        jstack, jstack, cfg=JaxChainConfig(est_side=est_side, est_ci=True),
        budgets=jch.EngineBudgets(**SIZES)))
    got = tch.chain_block(tstack, tstack, budgets=budgets,
                          cfg=dataclasses.replace(cfg, est_ci=True))
    _check(got, tch.chain_block(tstack, tstack, cfg=cfg, budgets=budgets),
           want)


def test_chain_pairs_ci_matches_jax(family):
    jstack, tstack = family
    ri, qi = [0, 1, 3, 4, 2], [1, 3, 0, 0, 2]
    budgets = tch.EngineBudgets(**SIZES)
    want = jax.device_get(jch.chain_pairs(
        take_sketch(jstack, np.array(ri)), take_sketch(jstack, np.array(qi)),
        cfg=JaxChainConfig(est_ci=True), budgets=jch.EngineBudgets(**SIZES)))
    r = tstack.map(lambda x: x[torch.tensor(ri)])
    q = tstack.map(lambda x: x[torch.tensor(qi)])
    got = tch.chain_pairs(r, q, cfg=tch.ChainConfig(est_ci=True),
                          budgets=budgets)
    _check(got, tch.chain_pairs(r, q, cfg=tch.ChainConfig(), budgets=budgets),
           want)


def test_chain_triangle_ci_matches_jax(family):
    jstack, tstack = family
    budgets = tch.EngineBudgets(**SIZES)
    want = jax.device_get(jch.chain_triangle(
        jstack, cfg=JaxChainConfig(est_ci=True),
        budgets=jch.EngineBudgets(**SIZES)))
    got = tch.chain_triangle(tstack, cfg=tch.ChainConfig(est_ci=True),
                             budgets=budgets)
    _check(got, tch.chain_triangle(tstack, cfg=tch.ChainConfig(),
                                   budgets=budgets), want)


def test_ci_row_blocks_give_the_same_bounds(family, monkeypatch):
    """Rows processed in blocks of one pair give the bounds of one block."""
    _, tstack = family
    kw = dict(cfg=tch.ChainConfig(est_ci=True),
              budgets=tch.EngineBudgets(**SIZES))
    whole = tch.chain_block(tstack, tstack, **kw)
    monkeypatch.setattr(tch, "CI_BLOCK", 1)
    blocked = tch.chain_block(tstack, tstack, **kw)
    for key in CI_KEYS:
        assert torch.equal(whole[key], blocked[key]), key


@pytest.fixture(scope="module")
def dbs():
    """test_ci.py's store (one 120 kb reference) in both packages, a 2%
    mutant query, and a 3-contig draft reference beside it."""
    rng = np.random.default_rng(23)
    base = random_genome(rng, 120_000)
    q = mutate(rng, base, 0.02)
    draft = mutate(rng, base, 0.03)
    jdb = pyskani_tpu.Database()
    tdb = pyskani_tpu_torch.Database(device="cpu")
    for db in (jdb, tdb):
        db.sketch("ref", base)
        db.sketch("draft", draft[:40_000], draft[40_000:70_000],
                  draft[70_000:])
    return jdb, tdb, q


@pytest.mark.parametrize("mode", [dict(learned_ani=False), {},
                                  dict(median=True)])
def test_query_est_ci_matches_jax(dbs, mode):
    jdb, tdb, q = dbs
    want = jdb.query("q", q, est_ci=True, **mode)
    got = tdb.query("q", q, est_ci=True, **mode)
    plain = tdb.query("q", q, **mode)
    assert [h.reference_name for h in got] == \
        [h.reference_name for h in want] == ["ref", "draft"]
    for g, w, p in zip(got, want, plain):
        assert (g.identity, g.query_fraction, g.reference_fraction) == \
            (p.identity, p.query_fraction, p.reference_fraction)
        assert g.ci_low == pytest.approx(w.ci_low, abs=1e-6)
        assert g.ci_high == pytest.approx(w.ci_high, abs=1e-6)
        assert p.ci_low is None and p.ci_high is None


def test_ci_off_by_default(dbs):
    _, tdb, q = dbs
    hits = tdb.query("q", q, learned_ani=False)
    assert len(hits) == 2
    assert all(h.ci_low is None and h.ci_high is None for h in hits)


def test_ci_brackets_mean(dbs):
    _, tdb, q = dbs
    h = tdb.query("q", q, learned_ani=False, est_ci=True)[0]
    assert h.ci_low is not None and h.ci_high is not None
    assert 0.0 < h.ci_low <= h.identity <= h.ci_high <= 1.0
    assert h.ci_high - h.ci_low < 0.05


def test_ci_deterministic(dbs):
    _, tdb, q = dbs
    a = tdb.query("q", q, learned_ani=False, est_ci=True)
    b = tdb.query("q", q, learned_ani=False, est_ci=True)
    assert [(h.ci_low, h.ci_high) for h in a] == \
        [(h.ci_low, h.ci_high) for h in b]


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    d = tmp_path_factory.mktemp("ci_fasta")
    rng = np.random.default_rng(7)
    base = random_genome(rng, 80_000)
    paths = []
    for name, g in (("a", base), ("b", mutate(rng, base, 0.02)),
                    ("c", mutate(rng, base, 0.04))):
        (d / f"{name}.fa").write_bytes(b">" + name.encode() + b"\n" + g +
                                       b"\n")
        paths.append(str(d / f"{name}.fa"))
    return paths


def _rows(main, argv, capsys):
    assert main(argv) == 0
    return [line.split("\t") for line in
            capsys.readouterr().out.strip().splitlines()]


def _assert_same_rows(got, want):
    assert len(got) == len(want) >= 2
    assert got[0] == want[0]
    assert want[0][-2:] == ["ANI_5_percentile", "ANI_95_percentile"]
    for g, w in zip(got[1:], want[1:]):
        assert g[:2] == w[:2] and len(g) == len(w) == 7
        for a, b in zip(g[2:5], w[2:5]):
            assert abs(float(a) - float(b)) <= 0.01 + 1e-9, (g, w)
        # the bounds agree within 1e-6 (the library tests above), so their
        # printed percentages agree exactly on these inputs
        assert g[5:] == w[5:], (g, w)
        assert float(g[5]) <= float(g[2]) <= float(g[6])


@pytest.mark.parametrize("command", ["dist", "triangle"])
def test_cli_ci_rows_match_jax(fasta, capsys, command):
    a, b, c = fasta
    argv = ["dist", "-q", b, c, "-r", a, "--learned-ani", "no", "--ci"] \
        if command == "dist" else ["triangle", a, b, c, "--ci"]
    want = _rows(jax_cli.main, argv, capsys)
    got = _rows(cli.main, argv + ["--device", "cpu"], capsys)
    _assert_same_rows(got, want)


def test_bootstrap_indices_reach_jnp_gather(family):
    """The resampled values are JAX's: one pair's bootstrap means, from
    the port's index table and JAX's, agree."""
    _, tstack = family
    fa = torch.tensor([[0.99, 0.97, 0.98, float("inf")]], dtype=torch.float32)
    cov = torch.isfinite(fa)
    out = tch._pooled_estimators(fa, cov, tch.ChainConfig(est_ci=True))
    want = jch._pooled_estimators(jnp.asarray(fa[0].numpy()),
                                  jnp.asarray(cov[0].numpy()),
                                  JaxChainConfig(est_ci=True))
    for key in CI_KEYS:
        assert float(out[key][0]) == pytest.approx(float(want[key]),
                                                   abs=1e-7)
