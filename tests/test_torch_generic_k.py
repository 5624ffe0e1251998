"""Generic k in the port vs the JAX package.

Every 4 <= k, marker_k <= 32: the sketch arrays equal the JAX package's
bit for bit (one call, chunked calls and stacks), with markers of up to
64 bits kept in unsigned (hi, lo) order; the screen on 64-bit markers
equals JAX's; seed tables at small k equal the numpy oracle's; ANI / AF
at k = 17 and 21 equal JAX's within 1e-6 in memory, streamed from disk,
with the bootstrap interval and on ``chain_pairs``; a k = 21 store
crosses between the packages; ``sketch_many`` and the triangle at k = 21
equal JAX's; k outside [4, 32] raises ``ValueError``.
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
from pyskani_tpu.oracle.seeding import sketch_genome as oracle_sketch
from pyskani_tpu.ops import chain as jch
from pyskani_tpu.ops import screen as jscreen
from pyskani_tpu.ops import sketch as jsk
from pyskani_tpu.params import SketchParams as JaxParams
from pyskani_tpu_torch import convert
from pyskani_tpu_torch.database import _chain_cfg_for
from pyskani_tpu_torch.engine import batch as tbatch
from pyskani_tpu_torch.ops import chain as tch
from pyskani_tpu_torch.ops import screen as tscreen
from pyskani_tpu_torch.ops import sketch as tsk
from pyskani_tpu_torch.params import SketchParams

torch.set_num_threads(1)

PAIRS = [(4, 21), (9, 21), (16, 21), (17, 21), (21, 21), (32, 21),
         (15, 32), (21, 32), (32, 32)]
FLOAT_KEYS = ("ani_mean", "ani_robust", "ani_median", "af_query", "af_ref")
BUCKET = 1 << 16


def _jax_cfg(k: int, **kw):
    return dataclasses.replace(JaxChainConfig(), k=k, extend_right=k - 1,
                               **kw)


def _assert_sketch_equal(got, want):
    assert got.contig_names == want.contig_names
    assert got.lengths == want.lengths
    got_np = convert.sketch_to_numpy(got)
    for f, w in jax.device_get(vars(want.device)).items():
        w = np.asarray(w)
        assert got_np[f].dtype == w.dtype, f
        np.testing.assert_array_equal(got_np[f], w, err_msg=f)


def _assert_hits_equal(got, want):
    assert [h.reference_name for h in got] == \
        [h.reference_name for h in want]
    for g, w in zip(got, want):
        for attr in ("identity", "query_fraction", "reference_fraction",
                     "ci_low", "ci_high"):
            a, b = getattr(g, attr), getattr(w, attr)
            assert (a is None) == (b is None), attr
            if a is not None:
                assert a == pytest.approx(b, abs=1e-6), attr


@pytest.fixture(scope="module")
def two_contigs():
    """A 60 kbp genome in two contigs, and a 300 bp contig."""
    rng = np.random.default_rng(61)
    return [random_genome(rng, 35_000), random_genome(rng, 300),
            random_genome(rng, 25_000)]


@pytest.mark.parametrize("k,marker_k", PAIRS,
                         ids=[f"k{k}-m{m}" for k, m in PAIRS])
def test_sketch_bit_equal_jax(two_contigs, k, marker_k):
    want = jsk.sketch_genome_device("g", two_contigs,
                                    JaxParams(k=k, marker_k=marker_k),
                                    length_bucket=BUCKET)
    got = tsk.sketch_genome_device("g", two_contigs,
                                   SketchParams(k=k, marker_k=marker_k),
                                   length_bucket=BUCKET, device="cpu")
    _assert_sketch_equal(got, want)
    dev = got.device
    n, m = int(dev.n_seeds), int(dev.n_markers)
    assert n > 300 and m > 40
    hi = dev.markers_hi[:m]
    if marker_k == 32:
        # markers at and above 2^63 sort after the others (unsigned)
        top = hi >= 1 << 31
        assert top.any() and (~top).any()
        assert not (top[:-1] & ~top[1:]).any()
    if 2 * k > 32:
        # hash fingerprints: the padding sentinel never appears as a key
        assert (dev.kmers[:n] < 0xFFFFFFFF).all()


@pytest.mark.parametrize("marker_k", [21, 32])
def test_chunked_k21_equals_single_and_jax(two_contigs, marker_k):
    """A small call buffer splits the first contig: the chunked sketch
    equals the JAX package's chunked sketch, and the one-call sketch on
    every table row (one call's padding rows carry the sentinel run's
    multiplicity, the chunked merge's carry 0)."""
    kw = dict(length_bucket=1 << 14, max_buffer=1 << 14)
    want = jsk.sketch_genome_device("g", two_contigs,
                                    JaxParams(k=21, marker_k=marker_k), **kw)
    params = SketchParams(k=21, marker_k=marker_k)
    got = tsk.sketch_genome_device("g", two_contigs, params, device="cpu",
                                   **kw)
    _assert_sketch_equal(got, want)
    single = tsk.sketch_genome_device("g", two_contigs, params,
                                      length_bucket=BUCKET, device="cpu")
    n, m = int(single.device.n_seeds), int(single.device.n_markers)
    assert (n, m) == (int(got.device.n_seeds), int(got.device.n_markers))
    for f in tsk.FIELDS:
        a, b = getattr(got.device, f), getattr(single.device, f)
        if f.startswith("markers"):
            a, b = a[:m], b[:m]
        elif a.dim() and f != "contig_lengths":
            a, b = a[:n], b[:n]
        assert torch.equal(a, b), f


def test_sketch_kernel_batch_rows_64bit_markers(two_contigs):
    """A stack of genomes at k = 21 / marker_k = 32 (per-row dedupe of
    64-bit markers) equals JAX's vmapped stack, genome for genome."""
    rng = np.random.default_rng(62)
    named = [("a", two_contigs), ("b", [mutate(rng, two_contigs[0])]),
             ("c", [random_genome(rng, 20_000)])]
    want = jsk.sketch_genomes_device(named, JaxParams(k=21, marker_k=32),
                                     length_bucket=BUCKET)
    got = tsk.sketch_genomes_device(named, SketchParams(k=21, marker_k=32),
                                    length_bucket=BUCKET, device="cpu")
    for g, w in zip(got, want):
        _assert_sketch_equal(g, w)


def test_marker_dedupe_forms_agree():
    """The one-``unique`` form (markers of at most 42 bits) and the
    two-sort form give the same bits on markers both can take, and the
    two-sort form keeps the unsigned order above 2^63."""
    rng = np.random.default_rng(65)
    b = torch.from_numpy(np.sort(rng.integers(0, 5, 4000)))
    small = torch.from_numpy(rng.integers(0, 1 << 42, 4000))
    small[::7] = small[1::7][:len(small[::7])]          # duplicates
    one = tsk._unique_markers(b, small, 21)
    two = tsk._unique_markers(b, small, 32)
    for x, y in zip(one, two):
        assert torch.equal(x, y)
    wide = torch.from_numpy(rng.integers(0, 2**64, 4000, dtype=np.uint64)
                            .view(np.int64))
    gb, hi, lo = tsk._unique_markers(b, wide, 32)
    want = sorted({(int(g), int(m)) for g, m in
                   zip(b, wide.numpy().view(np.uint64))})
    assert [(int(g), (int(h) << 32) | int(w)) for g, h, w in
            zip(gb, hi, lo)] == want


def test_screen_batch_64bit_markers_matches_jax():
    """One query against a family and an unrelated genome, on markers of
    up to 64 bits (marker_k = 32): pass flags equal, estimates within
    1e-6, the query against itself 1.0."""
    rng = np.random.default_rng(63)
    base = random_genome(rng, 50_000)
    genomes = [base] + [mutate(rng, base, d) for d in (0.005, 0.02, 0.08)] \
        + [random_genome(rng, 50_000)]
    params = SketchParams(marker_c=40, marker_k=32)
    sk = [tsk.sketch_genome_device(f"g{i}", [g], params, device="cpu")
          for i, g in enumerate(genomes)]
    M = max(s.device.marker_budget for s in sk)
    hi = torch.stack([tsk.pad_to(s.device.markers_hi, M, 0xFFFFFFFF)
                      for s in sk])
    lo = torch.stack([tsk.pad_to(s.device.markers_lo, M, 0xFFFFFFFF)
                      for s in sk])
    n = torch.stack([s.device.n_markers for s in sk])
    assert (hi >= 1 << 31).any()
    q = sk[1].device
    for rescue in (True, False):
        got_pass, got_est = tscreen.screen_batch(
            q.markers_hi, q.markers_lo, q.n_markers, hi, lo, n, 0.95,
            marker_k=32, rescue_small=rescue)
        want_pass, want_est = jax.device_get(jscreen.screen_batch(
            q.markers_hi.numpy().astype(np.uint32),
            q.markers_lo.numpy().astype(np.uint32), q.n_markers.numpy(),
            hi.numpy().astype(np.uint32), lo.numpy().astype(np.uint32),
            n.numpy(), 0.95, marker_k=32, rescue_small=rescue))
        np.testing.assert_array_equal(got_pass.numpy(), want_pass)
        np.testing.assert_allclose(got_est.numpy(), want_est, rtol=0,
                                   atol=1e-6)
    assert float(got_est[1]) == 1.0
    # the family within 2% passes at 0.95, the 8% mutant and the
    # unrelated genome do not
    assert got_pass.tolist() == [True, True, True, False, False]


def _pair(rng, n=60_000, subs=600):
    acgt = np.frombuffer(b"ACGT", np.uint8)
    a = rng.choice(acgt, size=n)
    b = a.copy()
    idx = rng.integers(0, n, subs)
    b[idx] = rng.choice(acgt, size=subs)
    return a.tobytes(), b.tobytes()


@pytest.mark.parametrize("k", [11, 13, 16])
def test_seed_table_matches_oracle_small_k(k):
    """For 2k <= 32 the seed table is the canonical k-mers themselves:
    k-mers, positions and strands equal the numpy oracle's."""
    g, _ = _pair(np.random.default_rng(5))
    params = SketchParams(k=k)
    dev = tsk.sketch_genome_device("g", [g], params, device="cpu").device
    n = int(dev.n_seeds)
    oracle = oracle_sketch("g", [g], JaxParams(k=k))
    assert n == len(oracle.kmers)
    np.testing.assert_array_equal(dev.kmers[:n].numpy().astype(np.uint64),
                                  oracle.kmers & np.uint64(0xFFFFFFFF))
    np.testing.assert_array_equal(dev.positions[:n].numpy(),
                                  oracle.positions)
    np.testing.assert_array_equal(dev.strands[:n].numpy(), oracle.strands)


@pytest.mark.parametrize("k", [17, 21])
def test_ani_matches_jax_large_k(k):
    """k > 16 keys seeds by 32-bit hash fingerprints: hits (plain and
    with the bootstrap interval) equal the JAX package's within 1e-6."""
    a, b = _pair(np.random.default_rng(6))
    want_db = pyskani_tpu.Database(k=k)
    got_db = pyskani_tpu_torch.Database(k=k, device="cpu")
    for db in (want_db, got_db):
        db.sketch("a", a)
    for kw in ({}, dict(est_ci=True)):
        want = want_db.query("b", b, learned_ani=False, **kw)
        got = got_db.query("b", b, learned_ani=False, **kw)
        assert len(got) == 1
        _assert_hits_equal(got, want)


@pytest.fixture(scope="module")
def family_k21():
    """Three references and a query, ~60 kbp each."""
    rng = np.random.default_rng(64)
    base = random_genome(rng, 60_000)
    refs = [("near", [mutate(rng, base, 0.01)]),
            ("multi", [mutate(rng, base[:30_000], 0.02),
                       mutate(rng, base[30_000:], 0.02)]),
            ("unrelated", [random_genome(rng, 50_000)])]
    return refs, mutate(rng, base, 0.015)


def test_database_k21_open_roundtrip(tmp_path, family_k21):
    """Database(path, k=21) sketched, flushed and opened again: the
    streamed query hits its family, equal to the memory store's."""
    refs, q = family_k21
    mem = pyskani_tpu_torch.Database(k=21, device="cpu")
    with pyskani_tpu_torch.Database(tmp_path / "db", k=21,
                                    device="cpu") as db:
        for name, contigs in refs:
            db.sketch(name, *contigs)
            mem.sketch(name, *contigs)
    re = pyskani_tpu_torch.Database.open(tmp_path / "db", device="cpu")
    assert re._params.k == 21
    hits = re.query("q", q, learned_ani=False)
    assert [h.reference_name for h in hits] == ["near", "multi"]
    assert hits[0].identity > 0.97
    _assert_hits_equal(hits, mem.query("q", q, learned_ani=False))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_k21_store_crosses_packages(tmp_path, family_k21, writer):
    """A k = 21 store written by either package: markers.bin byte-equal,
    and opened (streamed) or loaded by the other with equal hits."""
    refs, q = family_k21
    for label, mod, kw in (("jax", pyskani_tpu, {}),
                           ("port", pyskani_tpu_torch, dict(device="cpu"))):
        with mod.Database(tmp_path / label, k=21, **kw) as db:
            for name, contigs in refs:
                db.sketch(name, *contigs)
    assert (tmp_path / "jax" / "markers.bin").read_bytes() == \
        (tmp_path / "port" / "markers.bin").read_bytes()
    folder = tmp_path / writer
    want = pyskani_tpu.Database.open(folder).query("q", q,
                                                   learned_ani=False)
    assert len(want) == 2
    for opener in (pyskani_tpu_torch.Database.open,
                   pyskani_tpu_torch.Database.load):
        got = opener(folder, device="cpu").query("q", q, learned_ani=False)
        _assert_hits_equal(got, want)


def test_sketch_many_and_triangle_k21_match_jax(family_k21):
    """sketch_genomes_device and the all-vs-all triangle at k = 21 (the
    chain config taking k: ANI exponent 1/21, intervals extended by 20)
    equal the JAX package's."""
    refs, q = family_k21
    named = refs + [("q", [q])]
    want = jsk.sketch_genomes_device(named, JaxParams(k=21))
    params = SketchParams(k=21)
    got = tsk.sketch_genomes_device(named, params, device="cpu")
    for g, w in zip(got, want):
        _assert_sketch_equal(g, w)
    cfg = _chain_cfg_for(params)
    assert cfg.k == 21 and cfg.extend_right == 20
    ri_w, qi_w, out_w = jax_batch.triangle(want, cfg=_jax_cfg(21))
    ri, qi, out = tbatch.triangle(got, cfg=cfg)
    np.testing.assert_array_equal(ri, ri_w)
    np.testing.assert_array_equal(qi, qi_w)
    for key, w in out_w.items():
        g = np.asarray(out[key])
        if key in FLOAT_KEYS:
            np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-6,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=key)
    assert (out["ani_mean"] > 0.95).sum() == 3


def test_chain_pairs_k21_with_ci_matches_jax(family_k21):
    """The full-range per-pair path at k = 21, with the bootstrap
    interval: every output key equal to JAX's (f32 within 1e-6)."""
    refs, q = family_k21
    sk = [jsk.sketch_genome_device(n, c, JaxParams(k=21),
                                   seed_budget=2048, marker_budget=512,
                                   length_bucket=BUCKET, max_contigs=8)
          for n, c in refs[:2] + [("q", [q])]]
    stack = jax_batch.stack_sketches(sk)
    port = convert.sketch_from_numpy(jax.device_get(stack), "stack", [], [],
                                     device="cpu").device
    budgets = dict(max_anchors=4096, max_fragments=64,
                   max_anchors_per_fragment=128)
    r_idx, q_idx = np.array([0, 1]), np.array([2, 2])
    want = jax.device_get(jch.chain_pairs(
        jax_batch.take_sketch(stack, r_idx),
        jax_batch.take_sketch(stack, q_idx),
        cfg=_jax_cfg(21, est_ci=True), budgets=jch.EngineBudgets(**budgets)))
    got = tch.chain_pairs(
        tbatch.take_sketch(port, torch.from_numpy(r_idx)),
        tbatch.take_sketch(port, torch.from_numpy(q_idx)),
        cfg=dataclasses.replace(_chain_cfg_for(SketchParams(k=21)),
                                est_ci=True),
        budgets=tch.EngineBudgets(**budgets))
    assert set(got) == set(want)
    for key, w in want.items():
        g, w = got[key].numpy(), np.asarray(w)
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)
    assert (got["ani_mean"] > 0.95).all()


def test_invalid_k_rejected(tmp_path):
    for k in (3, 33, 40):
        with pytest.raises(ValueError, match="outside"):
            pyskani_tpu_torch.Database(k=k, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        tsk.sketch_kernel(torch.zeros(256, dtype=torch.uint8),
                          torch.zeros(9, dtype=torch.int32), 0, k=15,
                          marker_k=33, c=125, marker_c=1000,
                          seed_budget=1024, marker_budget=512)
