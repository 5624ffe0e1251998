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


def test_hash_matches_numpy_u64():
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 2**63, 4096, dtype=np.uint64) * np.uint64(2) + \
        rng.integers(0, 2, 4096, dtype=np.uint64)
    keys[:4] = [0, 1, 2**63, 2**64 - 1]
    got = tsk.mm_hash64(torch.from_numpy(keys.view(np.int64)))
    np.testing.assert_array_equal(got.numpy().view(np.uint64),
                                  np_hash(keys))


def test_unsupported_k_and_giants_raise():
    contigs = [b"ACGT" * 100]
    packed, starts = _kernel_inputs(contigs)
    with pytest.raises(NotImplementedError, match="k=16"):
        tsk.sketch_kernel(torch.from_numpy(packed), torch.from_numpy(starts),
                          1, k=16, marker_k=21, c=125, marker_c=1000,
                          seed_budget=1024, marker_budget=512)
    with pytest.raises(NotImplementedError, match="giant"):
        tsk.sketch_genome_device("g", contigs, P, max_buffer=256,
                                 device="cpu")
