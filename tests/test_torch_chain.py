"""Port ``chain_block`` vs the JAX package on the test_block_join family.

Every output key: integers bit-equal, f32 estimators and aligned
fractions within 1e-6 (summation order and f32 ``pow`` may differ in the
last ulp between PyTorch and XLA).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import mutate, random_genome
from pyskani_tpu.engine import batch as jax_batch
from pyskani_tpu.engine.batch import stack_sketches, take_sketch
from pyskani_tpu.oracle.chain import ChainConfig as JaxChainConfig
from pyskani_tpu.ops.chain import EngineBudgets as JaxBudgets
from pyskani_tpu.ops.chain import chain_block as jax_chain_block
from pyskani_tpu.ops.sketch import sketch_genome_device
from pyskani_tpu.params import SketchParams
from pyskani_tpu_torch import convert
from pyskani_tpu_torch.engine.batch import one_vs_many
from pyskani_tpu_torch.ops.chain import (ChainConfig, EngineBudgets,
                                         chain_block)

torch.set_num_threads(1)

SIZES = dict(max_anchors=4096, max_fragments=64, max_anchors_per_fragment=128)
FLOAT_KEYS = ("ani_mean", "ani_robust", "ani_median", "af_query", "af_ref")


@pytest.fixture(scope="module")
def family():
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
    sketches = [sketch_genome_device(n, c, SketchParams(), seed_budget=1024,
                                     marker_budget=512,
                                     length_bucket=1 << 16, max_contigs=8)
                for n, c in genomes]
    return stack_sketches(sketches)


def _port(stack):
    return convert.sketch_from_numpy(jax.device_get(stack), "stack", [], [],
                                     device="cpu").device


@pytest.mark.parametrize("refs,queries", [
    (list(range(5)), list(range(5))),      # all pairs, self pairs included
    ([0, 1], [1, 2, 3]),                   # rectangular block
    ([3, 4], [0]),                         # one query (Database's shape)
])
def test_chain_block_matches_jax(family, refs, queries):
    r = take_sketch(family, jnp.asarray(refs))
    q = take_sketch(family, jnp.asarray(queries))
    want = jax.device_get(jax_chain_block(
        r, q, cfg=JaxChainConfig(), budgets=JaxBudgets(**SIZES)))
    got = chain_block(_port(r), _port(q), cfg=ChainConfig(),
                      budgets=EngineBudgets(**SIZES))
    # the port's one key beyond JAX's: every genome fits the budget
    assert set(got) == set(want) | {"frag_overflow"}
    assert not got["frag_overflow"].any()
    for key, w in want.items():
        g = got[key].numpy()
        w = np.asarray(w)
        assert g.shape == w.shape == (len(refs), len(queries)), key
        if key in FLOAT_KEYS:
            assert g.dtype == np.float32, key
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)
    assert got["n_anchors"].sum() > 0 and got["n_chains"].sum() > 0


def test_chain_block_chain_table_overflow_matches_jax(family):
    """A chain table smaller than the kept chains: both packages keep the
    same first chains, so every output still agrees."""
    sizes = dict(SIZES, max_chains_per_pair=3)
    want = jax.device_get(jax_chain_block(
        family, family, cfg=JaxChainConfig(), budgets=JaxBudgets(**sizes)))
    got = chain_block(_port(family), _port(family), cfg=ChainConfig(),
                      budgets=EngineBudgets(**sizes))
    assert (np.asarray(want["n_chains"]) > 3).any()
    for key in FLOAT_KEYS:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=1e-6, err_msg=key)


def test_chain_block_rejects_unsupported(family):
    fam = _port(family)
    big = EngineBudgets(max_anchors=1024, max_fragments=1 << 16,
                        max_anchors_per_fragment=64)
    with pytest.raises(ValueError, match="block too large"):
        chain_block(fam, fam, cfg=ChainConfig(), budgets=big)


@pytest.mark.parametrize("max_anchors", [200, 4096])
def test_one_vs_many_pads_last_chunk_as_jax(max_anchors):
    """Three references in chunks of two: the last chunk is padded with
    reference 0 in both packages (store index 0 in JAX, the first of
    ``ref_idx`` here), and the padding pair shares the chunk's anchor
    pool.  With a 200-anchor pool that pool overflows, so
    the third pair keeps fewer anchors than it would alone, in both."""
    rng = np.random.default_rng(41)
    base = random_genome(rng, 60_000)
    genomes = [[mutate(rng, base, d)] for d in (0.01, 0.02, 0.03)]
    q = [mutate(rng, base, 0.015)]
    kw = dict(seed_budget=1024, marker_budget=512, length_bucket=1 << 16)
    stack = stack_sketches([sketch_genome_device(f"r{i}", g, SketchParams(),
                                                 **kw)
                            for i, g in enumerate(genomes)])
    qs = sketch_genome_device("q", q, SketchParams(), **kw).device
    sizes = dict(SIZES, max_anchors=max_anchors)
    idx = np.array([0, 1, 2], np.int32)
    want = jax.device_get(jax_batch.one_vs_many(
        stack, qs, idx, cfg=JaxChainConfig(), budgets=JaxBudgets(**sizes),
        chunk=2))
    tq = convert.sketch_from_numpy(jax.device_get(qs), "q", [], [],
                                   device="cpu").device
    got = one_vs_many(_port(stack), tq, idx, cfg=ChainConfig(),
                      budgets=EngineBudgets(**sizes), chunk=2)
    assert set(got) == set(want) | {"frag_overflow"}
    assert not got["frag_overflow"].any()
    for key, w in want.items():
        if key in FLOAT_KEYS:
            np.testing.assert_allclose(got[key].numpy(), np.asarray(w),
                                       rtol=0, atol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(w),
                                          err_msg=key)
    alone = chain_block(_port(stack).map(lambda x: x[2:]),
                        tq.map(lambda x: x[None]), cfg=ChainConfig(),
                        budgets=EngineBudgets(**sizes))
    clipped = int(alone["n_anchors"][0, 0]) != int(want["n_anchors"][2])
    assert clipped == (max_anchors == 200)
    assert bool(np.asarray(want["anchors_overflow"]).all()) == clipped
