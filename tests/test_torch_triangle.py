"""Port ``chain_triangle`` and ``engine.batch.triangle`` vs the JAX package.

Every output key: integers bit-equal, f32 estimators and aligned
fractions within 1e-6.  Covered: the test_block_join family (multi-contig
and unrelated genomes), a clipped anchor pool, query entries whose
fragment lies past the fragment budget, the engine's two genome groups
with padded cross tiles and a singleton group, and a >= 2^30 bp genome
rerouted to ``pairs_ani``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import mutate, random_genome
from pyskani_tpu.engine import batch as jax_batch
from pyskani_tpu.oracle.chain import ChainConfig as JaxChainConfig
from pyskani_tpu.ops import chain as jax_chain
from pyskani_tpu.ops.chain import EngineBudgets as JaxBudgets
from pyskani_tpu.ops.sketch import sketch_genome_device
from pyskani_tpu.params import SketchParams
from pyskani_tpu_torch import convert
from pyskani_tpu_torch.engine import batch as tbatch
from pyskani_tpu_torch.ops.chain import (ChainConfig, EngineBudgets,
                                         chain_triangle, triu_pairs)

torch.set_num_threads(1)

SIZES = dict(max_anchors=4096, max_fragments=64, max_anchors_per_fragment=128)
FLOAT_KEYS = ("ani_mean", "ani_robust", "ani_median", "af_query", "af_ref")


def _family_genomes(rng):
    base = random_genome(rng, 60_000)
    return base, [
        ("base", [base]),
        ("mut1", [mutate(rng, base, 0.01)]),
        ("mut2", [mutate(rng, base, 0.03)]),
        ("multi", [mutate(rng, base[:30_000], 0.02),
                   mutate(rng, base[30_000:], 0.02)]),
        ("unrelated", [random_genome(rng, 60_000)]),
    ]


@pytest.fixture(scope="module")
def family():
    _, genomes = _family_genomes(np.random.default_rng(5))
    sketches = [sketch_genome_device(n, c, SketchParams(), seed_budget=1024,
                                     marker_budget=512,
                                     length_bucket=1 << 16, max_contigs=8)
                for n, c in genomes]
    return jax_batch.stack_sketches(sketches)


def _port_stack(stack):
    return convert.sketch_from_numpy(jax.device_get(stack), "stack", [], [],
                                     device="cpu").device


def _port_sketch(h):
    return convert.sketch_from_numpy(jax.device_get(h.device), h.name,
                                     h.contig_names, h.lengths, device="cpu")


def _assert_outputs_equal(got: dict, want: dict, shape, frag_overflow=None):
    """Every key of JAX's equal, and the port's ``frag_overflow`` equal to
    ``frag_overflow`` (by default JAX's where a path of it has the key,
    else all False: the JAX packed paths lack it)."""
    assert set(got) == set(want) | {"frag_overflow"}
    if frag_overflow is None:
        frag_overflow = want.get("frag_overflow", np.zeros(shape, bool))
    np.testing.assert_array_equal(np.asarray(got["frag_overflow"]),
                                  np.asarray(frag_overflow))
    for key, w in want.items():
        g = got[key]
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape == shape, key
        if key in FLOAT_KEYS:
            assert g.dtype == np.float32, key
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


# (total_anchors, max_fragments): the default pool; a pool clipped
# mid-stream; NF = 3, past which the multi-contig genome's 4th fragment
# (its entries as a query) lies, so its pairs as the query set
# frag_overflow as JAX chain_pairs sets it; and both together
CASES = {"default": (None, 64), "clipped": (1500, 64),
         "frag_overflow": (None, 3), "clipped_frag_overflow": (1500, 3)}


@pytest.mark.parametrize("case", list(CASES))
def test_chain_triangle_matches_jax(family, case):
    total_anchors, nf = CASES[case]
    sizes = dict(SIZES, max_fragments=nf)
    want = jax.device_get(jax_chain.chain_triangle(
        family, cfg=JaxChainConfig(), budgets=JaxBudgets(**sizes),
        total_anchors=total_anchors))
    got = chain_triangle(_port_stack(family), cfg=ChainConfig(),
                         budgets=EngineBudgets(**sizes),
                         total_anchors=total_anchors)
    ri, qi = triu_pairs(5)
    pairs = jax.device_get(jax_chain.chain_pairs(
        jax_batch.take_sketch(family, ri), jax_batch.take_sketch(family, qi),
        cfg=JaxChainConfig(), budgets=JaxBudgets(**sizes)))
    flags = np.asarray(pairs["frag_overflow"])
    _assert_outputs_equal(got, want, (10,), frag_overflow=flags)
    # the multi-contig genome (index 3) as the query of 3 pairs
    assert flags.sum() == (3 if nf == 3 else 0)
    assert got["n_anchors"].sum() > 0 and got["n_chains"].sum() > 0
    clipped = total_anchors is not None
    assert bool(got["anchors_overflow"].all()) == clipped
    if clipped:
        # the pool ends mid-stream: the kept anchors fill it exactly
        assert int(got["n_anchors"].sum()) == total_anchors


def test_chain_triangle_too_large(family):
    big = EngineBudgets(max_anchors=1024, max_fragments=1 << 16,
                        max_anchors_per_fragment=64)
    with pytest.raises(ValueError, match="triangle too large"):
        chain_triangle(_port_stack(family), cfg=ChainConfig(), budgets=big)


def test_triu_pairs_and_budget_helpers(family):
    for G in (2, 3, 7, 32):
        for a, b in zip(triu_pairs(G), jax_chain.triu_pairs(G)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for nf in (64, 128, 384, 4096, 1 << 16):
        b = EngineBudgets(max_fragments=nf)
        jb = JaxBudgets(max_fragments=nf)
        for cap in (2, 7, 32):
            assert tbatch.max_triangle_group(b, cap) == \
                jax_batch.max_triangle_group(jb, cap)
    rng = np.random.default_rng(9)
    sk = [sketch_genome_device(f"g{i}", [random_genome(rng, n)],
                               SketchParams())
          for i, n in enumerate((30_000, 95_000, 41_000))]
    want = jax_batch.default_budgets(sk, jax_batch.stack_sketches(sk),
                                     JaxChainConfig())
    port = [_port_sketch(h) for h in sk]
    got = tbatch.default_budgets(port, tbatch.stack_sketches(port),
                                 ChainConfig())
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.fixture(scope="module")
def seven():
    """Seven genomes: the family, one more mutant and a two-contig draft
    of an unrelated root's mutant, sketched by the JAX package."""
    rng = np.random.default_rng(13)
    base, genomes = _family_genomes(rng)
    other = random_genome(rng, 50_000)
    genomes += [("mut3", [mutate(rng, base, 0.015)]),
                ("other", [mutate(rng, other[:20_000], 0.01),
                           mutate(rng, other[20_000:], 0.01)])]
    return [sketch_genome_device(n, c, SketchParams()) for n, c in genomes]


def test_triangle_engine_matches_jax(seven):
    """group=3 on 7 genomes: two chain_triangle groups, a singleton
    group, and cross tiles padded with their first genome."""
    kw = dict(budgets=None, group=3)
    ri_w, qi_w, want = jax_batch.triangle(seven, cfg=JaxChainConfig(), **kw)
    ri, qi, got = tbatch.triangle([_port_sketch(h) for h in seven],
                                  cfg=ChainConfig(), **kw)
    np.testing.assert_array_equal(ri, ri_w)
    np.testing.assert_array_equal(qi, qi_w)
    _assert_outputs_equal(got, want, (21,))
    assert (got["ani_mean"] > 0.9).sum() >= 10


def test_triangle_engine_ragged_tiles_match_jax(seven):
    """The test_block_join budgets, groups of 3 and tiles of 2 x 2: every
    cross rectangle ends in tiles padded on the reference side, the query
    side or both."""
    kw = dict(group=3, block=2, anchors_per_pair=1000)
    ri_w, qi_w, want = jax_batch.triangle(
        seven, cfg=JaxChainConfig(), budgets=JaxBudgets(**SIZES), **kw)
    ri, qi, got = tbatch.triangle(
        [_port_sketch(h) for h in seven], cfg=ChainConfig(),
        budgets=EngineBudgets(**SIZES), **kw)
    _assert_outputs_equal(got, want, (21,))


def test_triangle_giant_reroute_matches_jax():
    """A genome of >= 2^30 bp (a mutant's sketch placed among seedless
    pad contigs) takes ``pairs_ani`` for both of its pairs, the smaller
    index as the reference; the other pair is a chain_triangle group of
    two.  Fragments of 1 Mbp keep the giant's grid small."""
    from test_giant_query import _embed_giant

    rng = np.random.default_rng(19)
    base = random_genome(rng, 200_000)
    sk = [sketch_genome_device(f"g{i}", [mutate(rng, base, d)],
                               SketchParams())
          for i, d in enumerate((0.01, 0.02, 0.015))]
    sk[1] = _embed_giant(sk[1], pre=3, post=3, pad_len=200_000_000)
    assert sk[1].total_len >= 1 << 30
    cfg_j = dataclasses.replace(JaxChainConfig(), fragment_length=1_000_000)
    cfg_t = dataclasses.replace(ChainConfig(), fragment_length=1_000_000)
    ri_w, qi_w, want = jax_batch.triangle(sk, cfg=cfg_j)
    calls = []
    real = tbatch.pairs_ani

    def spy(batch, r, q, **kw):
        calls.append((list(r), list(q)))
        return real(batch, r, q, **kw)

    tbatch.pairs_ani = spy
    try:
        ri, qi, got = tbatch.triangle([_port_sketch(h) for h in sk],
                                      cfg=cfg_t)
    finally:
        tbatch.pairs_ani = real
    assert calls == [([0, 1], [1, 2])]
    _assert_outputs_equal(got, want, (3,))
    assert (got["ani_mean"] > 0.95).all()
    # the packed path's diagnostic key reads 0 on the rerouted pairs
    assert not got["pos_overflow"].any()
