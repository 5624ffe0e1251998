"""Port sketching vs the JAX package: every sketch output bit-equal.

The same numpy-made genomes go through the JAX ``sketch_kernel`` and the
port's; every output key (seed table, position view, multiplicities,
markers, counts, saturation counts) must be equal bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_genome
from pyskani_tpu.oracle.seeding import mm_hash64 as np_hash
from pyskani_tpu.ops import sketch as jsk
from pyskani_tpu.params import SketchParams
from pyskani_tpu_torch import convert
from pyskani_tpu_torch.ops import sketch as tsk

torch.set_num_threads(1)

P = SketchParams()
L = 1 << 16


def _genome(case: str):
    rng = np.random.default_rng({"multi": 1, "odd_bases": 2,
                                 "saturated": 3}[case])
    if case == "multi":
        # a 40 bp contig (under MIN_LENGTH_CONTIG) fed straight to the
        # kernel, between ordinary contigs
        return [random_genome(rng, 20_000), random_genome(rng, 40),
                random_genome(rng, 7_000), random_genome(rng, 3_000)]
    g = bytearray(random_genome(rng, 30_000))
    g[100:200] = b"N" * 100
    g[5000:5100] = bytes(g[5000:5100]).lower()
    g[9000:9050] = b"RYKMSWnx-." * 5
    return [bytes(g), random_genome(rng, 150)]


def _kernel_inputs(contigs):
    raw = np.zeros(L, np.uint8)
    starts = np.zeros(9, np.int32)
    off = 0
    for i, c in enumerate(contigs):
        raw[off:off + len(c)] = np.frombuffer(c, np.uint8)
        starts[i] = off
        off += len(c)
    starts[len(contigs):] = off
    return jsk.encode_pack_host(raw), starts


@pytest.mark.parametrize("case", ["multi", "odd_bases", "saturated"])
def test_sketch_kernel_bit_equal(case):
    contigs = _genome(case)
    packed, starts = _kernel_inputs(contigs)
    # "saturated": budgets far below the masks, so the union prefix clips
    sb, mb = (128, 16) if case == "saturated" else (2048, 512)
    kw = dict(k=15, marker_k=21, c=P.c, marker_c=P.marker_c,
              seed_budget=sb, marker_budget=mb)
    want = jax.device_get(jsk.sketch_kernel(
        jnp.asarray(packed), jnp.asarray(starts), jnp.int32(len(contigs)),
        **kw))
    got = tsk.sketch_kernel(torch.from_numpy(packed),
                            torch.from_numpy(starts), len(contigs), **kw)
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_array_equal(g.astype(np.int64),
                                      np.asarray(w).astype(np.int64),
                                      err_msg=key)
    if case == "saturated":
        assert int(want["n_seeds_want"]) > sb and int(want["n_markers_want"]) > mb


@pytest.mark.parametrize("seed", [True, False])
def test_sketch_genome_device_bit_equal(seed):
    rng = np.random.default_rng(4)
    contigs = [random_genome(rng, 25_000), b"ACGT" * 10,
               random_genome(rng, 9_000)]
    want = jsk.sketch_genome_device("g", contigs, P, length_bucket=L,
                                    seed=seed)
    got = tsk.sketch_genome_device("g", contigs, P, length_bucket=L,
                                   seed=seed, device="cpu")
    assert got.contig_names == want.contig_names == ["g_0", "g_2"]
    assert got.lengths == want.lengths
    got_np = convert.sketch_to_numpy(got)
    for f, w in jax.device_get(vars(want.device)).items():
        w = np.asarray(w)
        assert got_np[f].dtype == w.dtype, f
        np.testing.assert_array_equal(got_np[f], w, err_msg=f)


def test_encode_pack_matches_jax_host_encoding():
    """Every byte value, in every one of the four packed slots, and a
    random stream: the device encoding equals JAX ``encode_pack_host``."""
    every = np.repeat(np.arange(256, dtype=np.uint8), 4)
    shifted = np.roll(every, 1)
    rand = np.random.default_rng(0).integers(0, 256, 4096, dtype=np.uint8)
    for raw in (every, shifted, rand):
        got = tsk.encode_pack(torch.from_numpy(raw))
        np.testing.assert_array_equal(got.numpy(), jsk.encode_pack_host(raw))
    stack = np.stack([rand, rand[::-1]])
    got = tsk.encode_pack(torch.from_numpy(stack.copy()))
    assert got.shape == (2, 1024) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got[1].numpy(),
                                  jsk.encode_pack_host(rand[::-1].copy()))


def test_hash_matches_numpy_u64():
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 2**63, 4096, dtype=np.uint64) * np.uint64(2) + \
        rng.integers(0, 2, 4096, dtype=np.uint64)
    keys[:4] = [0, 1, 2**63, 2**64 - 1]
    got = tsk.mm_hash64(torch.from_numpy(keys.view(np.int64)))
    np.testing.assert_array_equal(got.numpy().view(np.uint64),
                                  np_hash(keys))


def test_unsupported_k_and_giants_raise():
    """k outside [4, 32] raises ``ValueError``, as in the JAX package; a
    giant genome streams through chunked calls unless the buffer cannot
    hold a k-mer overlap."""
    contigs = [b"ACGT" * 100]
    packed, starts = _kernel_inputs(contigs)
    with pytest.raises(ValueError, match="k=33"):
        tsk.sketch_kernel(torch.from_numpy(packed), torch.from_numpy(starts),
                          1, k=33, marker_k=21, c=125, marker_c=1000,
                          seed_budget=1024, marker_budget=512)
    with pytest.raises(ValueError, match="too small"):
        tsk.sketch_genome_device("g", contigs, P, max_buffer=64,
                                 device="cpu")


@pytest.mark.parametrize("kw", [dict(compression=1),
                                dict(marker_compression=1)],
                         ids=["compression", "marker_compression"])
def test_compression_one_matches_jax(kw):
    """c = 1 keeps every hash but all-ones (threshold 2^64 - 1, above the
    int64 range): the sketch is bit-equal to the JAX package's and a
    20 kbp genome queried against itself gives JAX's hits (count,
    identity and both fractions within 1e-6)."""
    from pyskani_tpu.database import Database as JaxDatabase
    from pyskani_tpu_torch import Database
    from pyskani_tpu_torch.params import SketchParams as TorchParams

    rng = np.random.default_rng(20)
    g = random_genome(rng, 20_000)
    params = dict(c=kw.get("compression", 125),
                  marker_c=kw.get("marker_compression", 1000))
    want = jsk.sketch_genome_device("g", [g], SketchParams(**params),
                                    length_bucket=L)
    got = tsk.sketch_genome_device("g", [g], TorchParams(**params),
                                   length_bucket=L, device="cpu")
    got_np = convert.sketch_to_numpy(got)
    for f, w in jax.device_get(vars(want.device)).items():
        np.testing.assert_array_equal(got_np[f], np.asarray(w), err_msg=f)
    n = int(got.device.n_seeds if "compression" in kw
            else got.device.n_markers)
    assert n >= 20_000 - 21
    hits = []
    for db in (JaxDatabase(**kw), Database(device="cpu", **kw)):
        db.sketch("g", g)
        hits.append(db.query("g", g, learned_ani=False))
    want_hits, got_hits = hits
    assert len(got_hits) == len(want_hits)
    for h, w in zip(got_hits, want_hits):
        assert h.reference_name == w.reference_name
        for attr in ("identity", "query_fraction", "reference_fraction"):
            assert getattr(h, attr) == pytest.approx(getattr(w, attr),
                                                     abs=1e-6), attr


GIANT_CONTIGS = (700_000, 300_000, 400_000)   # the first is split


@pytest.fixture(scope="module")
def giant_contigs():
    rng = np.random.default_rng(7)
    return [random_genome(rng, n) for n in GIANT_CONTIGS]


@pytest.mark.parametrize("seed", [True, False])
def test_chunked_sketch_equals_single_and_jax(giant_contigs, seed):
    """A genome above the call buffer streams through chunked calls (a
    split contig's continuation masks its K-1 overlap with
    ``valid_floor``): bit-equal to one call, and field for field to the
    JAX package's chunked sketch."""
    buf = 400_000
    assert max(GIANT_CONTIGS) >= buf > 4 * 21
    calls = tsk._plan_sketch_pieces(giant_contigs, 21, buf)
    assert calls == jsk._plan_sketch_pieces(giant_contigs, 21, buf)
    assert len(calls) >= 3 and calls[0][1:] == [] and calls[1][0][3] == 20
    one = tsk.sketch_genome_device("g", giant_contigs, P, seed=seed,
                                   device="cpu")
    chunked = tsk.sketch_genome_device("g", giant_contigs, P, seed=seed,
                                       max_buffer=buf, device="cpu")
    want = jsk.sketch_genome_device("g", giant_contigs, P, seed=seed,
                                    max_buffer=buf)
    got_np = convert.sketch_to_numpy(chunked)
    one_np = convert.sketch_to_numpy(one)
    for f, w in jax.device_get(vars(want.device)).items():
        w = np.asarray(w)
        assert got_np[f].dtype == w.dtype, f
        np.testing.assert_array_equal(got_np[f], w, err_msg=f)
    # one call equals the chunked calls on every table row (the padding
    # differs: one call's sentinel rows carry the sentinel run's length)
    n, m = int(one_np["n_seeds"]), int(one_np["n_markers"])
    assert (n, m) == (int(got_np["n_seeds"]), int(got_np["n_markers"]))
    assert (n > 10_000) == seed
    for f in ("kmers", "positions", "contig_ids", "strands", "own_mult",
              "p_positions", "p_contig_ids", "p_own_mult"):
        np.testing.assert_array_equal(one_np[f][:n], got_np[f][:n],
                                      err_msg=f)
    for f in ("markers_hi", "markers_lo"):
        np.testing.assert_array_equal(one_np[f][:m], got_np[f][:m],
                                      err_msg=f)
    for f in ("contig_lengths", "n_contigs", "total_len"):
        np.testing.assert_array_equal(one_np[f], got_np[f], err_msg=f)
    assert chunked.lengths == list(GIANT_CONTIGS)


def test_valid_floor_masks_window_ends():
    """``valid_floor`` raises the first window end of each contig, and a
    floor at every contig's start changes nothing (vs JAX)."""
    contigs = _genome("multi")
    packed, starts = _kernel_inputs(contigs)
    kw = dict(k=15, marker_k=21, c=P.c, marker_c=P.marker_c,
              seed_budget=2048, marker_budget=512)
    for extra in (0, 500):
        floors = starts.copy()
        floors[:len(contigs)] += extra
        want = jax.device_get(jsk.sketch_kernel(
            jnp.asarray(packed), jnp.asarray(starts),
            jnp.int32(len(contigs)), jnp.asarray(floors), **kw))
        got = tsk.sketch_kernel(torch.from_numpy(packed),
                                torch.from_numpy(starts), len(contigs),
                                torch.from_numpy(floors), **kw)
        for key, w in want.items():
            g = got[key]
            g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
            np.testing.assert_array_equal(g.astype(np.int64),
                                          np.asarray(w).astype(np.int64),
                                          err_msg=key)
        n = int(got["n_seeds"])
        assert (got["p_positions"][:n] >= extra).all()


def _mixed_genomes():
    """Genomes of mixed sizes (stacks of two pair them by size: d+b, a+f,
    e+c), one with a contig under MIN_LENGTH_CONTIG, one above a 150 kb
    call buffer."""
    rng = np.random.default_rng(8)
    return [("a", [random_genome(rng, 30_000)]),
            ("b", [random_genome(rng, 5_000), b"AC" * 20,
                   random_genome(rng, 9_000)]),
            ("giant", [random_genome(rng, 110_000),
                       random_genome(rng, 60_000)]),
            ("c", [random_genome(rng, 140_000)]),
            ("d", [random_genome(rng, 12_000)]),
            ("e", [random_genome(rng, 90_000), random_genome(rng, 300)]),
            ("f", [random_genome(rng, 60_000)])]


@pytest.mark.parametrize("seed,one_row_passes", [
    (True, False), (False, False), (True, True)])
def test_sketch_genomes_device_matches_jax(seed, one_row_passes,
                                           monkeypatch):
    """Batched sketching (stacks of 2 grouped by size, the giant through
    chunked calls) equals the JAX package's field for field, padded
    shapes included, in input order; also when the per-pass base budget
    splits every stack into one-row passes."""
    if one_row_passes:
        monkeypatch.setattr(tsk, "GIANT_SKETCH_BUFFER", 1 << 16)
    named = _mixed_genomes()
    kw = dict(length_bucket=1 << 16, device_batch=2, seed=seed,
              max_buffer=150_000)
    want = jsk.sketch_genomes_device(named, P, **kw)
    got = tsk.sketch_genomes_device(named, P, device="cpu", **kw)
    assert [g.name for g in got] == [n for n, _ in named]
    for w, g in zip(want, got):
        assert (g.contig_names, g.lengths) == (w.contig_names, w.lengths)
        got_np = convert.sketch_to_numpy(g)
        for f, a in jax.device_get(vars(w.device)).items():
            a = np.asarray(a)
            assert got_np[f].dtype == a.dtype, f
            assert got_np[f].shape == a.shape, (g.name, f)
            np.testing.assert_array_equal(got_np[f], a, err_msg=f)
    # a stack member takes its stack's budgets: "e" (90 kb) is padded to
    # those of "c" (140 kb), above what it would take alone
    alone = tsk.sketch_genome_device("e", named[5][1], P, device="cpu")
    assert got[5].device.seed_budget > alone.device.seed_budget


def test_sketch_kernel_batch_rows_equal_single():
    """Each row of one batched pass equals the one-genome kernel on that
    genome with the same budgets, window-end floors included."""
    genomes = [_genome("multi"), _genome("odd_bases"),
               [random_genome(np.random.default_rng(6), 2_000)]]
    inputs = [_kernel_inputs(c) for c in genomes]
    packed = torch.from_numpy(np.stack([p for p, _ in inputs]))
    starts = torch.from_numpy(np.stack([s for _, s in inputs]))
    floors = starts + torch.tensor([0, 300, 0, 0, 0, 0, 0, 0, 0],
                                   dtype=torch.int32)
    ncon = [len(c) for c in genomes]
    kw = dict(k=15, marker_k=21, c=P.c, marker_c=P.marker_c,
              seed_budget=512, marker_budget=64)
    batch = tsk.sketch_kernel_batch(packed, starts, ncon, floors, **kw)
    for b in range(len(genomes)):
        one = tsk.sketch_kernel(packed[b], starts[b], ncon[b], floors[b], **kw)
        for key, v in one.items():
            assert torch.equal(batch[key][b], torch.as_tensor(v)), (b, key)
