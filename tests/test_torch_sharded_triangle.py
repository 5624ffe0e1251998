"""Port's mesh all-vs-all (``sharded_triangle``, ``ring_triangle``) vs the
JAX package's, on the JAX test's 32-genome family.

The JAX functions run here on the 8-virtual-device CPU mesh; the port's
on spawned gloo ranks (``dist.launch``, ``tests/torch_mesh_worker.py``)
on the same stacked sketches as numpy arrays.  Every output key of the
JAX mesh triangle is there, integers bit-equal, floats within 1e-6; and
the five estimators equal the JAX single-device triangle within 1e-6, as
the JAX test holds its own.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_mesh_worker as worker
from conftest import mutate, random_genome
from pyskani_tpu.engine.batch import stack_sketches, triangle
from pyskani_tpu.oracle.chain import ChainConfig
from pyskani_tpu.ops.chain import EngineBudgets
from pyskani_tpu.ops.sketch import HostSketch, sketch_genome_device
from pyskani_tpu.parallel import dist as jax_dist
from pyskani_tpu.parallel.mesh import make_mesh as jax_make_mesh
from pyskani_tpu.params import SketchParams
from pyskani_tpu_torch import convert
from pyskani_tpu_torch.ops.chain import ChainConfig as TChainConfig
from pyskani_tpu_torch.ops.chain import EngineBudgets as TBudgets
from pyskani_tpu_torch.ops.sketch import FIELDS
from pyskani_tpu_torch.parallel import dist as tdist
from pyskani_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

CFG = ChainConfig()
BUDGETS = dict(max_anchors=2048, max_fragments=64,
               max_anchors_per_fragment=128)
FLOAT_KEYS = ("ani_mean", "ani_robust", "ani_median", "af_query", "af_ref")
KW = dict(anchors_per_pair=2048)
# fragments of 5 kb: each 20 kb genome has 4, two past this budget
FRAG_CFG = dict(fragment_length=5_000)
FRAG_BUDGETS = dict(BUDGETS, max_fragments=2)


def _fields(sketches) -> dict:
    host = jax.device_get(stack_sketches(sketches))
    return {f: np.asarray(getattr(host, f)) for f in FIELDS}


@pytest.fixture(scope="module")
def family32():
    rng = np.random.default_rng(13)
    base = random_genome(rng, 20_000)
    params = SketchParams()
    sketches = []
    for i in range(32):
        g = mutate(rng, base, 0.01 + 0.001 * (i % 7)) if i % 5 else \
            random_genome(rng, 20_000)
        sketches.append(sketch_genome_device(
            f"g{i}", [g], params, seed_budget=512, marker_budget=512,
            length_bucket=1 << 15))
    return sketches


@pytest.fixture(scope="module")
def with_giant(family32):
    """The first 8 genomes, genome 0 past 2^30 bp total (two fat seedless
    contigs), as in the JAX test."""
    sketches = list(family32[:8])
    dev = jax.device_get(sketches[0].device)
    nc = int(dev.n_contigs)
    pad_len = 550_000_000
    clens = np.zeros(8, np.int32)
    clens[:nc] = np.asarray(dev.contig_lengths)[:nc]
    clens[nc:nc + 2] = pad_len
    lengths = list(sketches[0].lengths) + [pad_len, pad_len]
    dev2 = dataclasses.replace(
        dev, contig_lengths=clens, n_contigs=np.int32(nc + 2),
        total_len=np.uint32(sum(lengths)))
    sketches[0] = HostSketch(name="giant",
                             contig_names=sketches[0].contig_names,
                             device=dev2, lengths=lengths)
    assert sketches[0].total_len >= (1 << 30)
    return sketches


@pytest.fixture(scope="module")
def port(family32, with_giant):
    """The port's triangles on 4 ranks ((4, 1) and (2, 2) meshes)."""
    b32, b29, b8, bg = (_fields(s) for s in (family32, family32[:29],
                                             family32[:8], with_giant))
    jobs = {
        ("sharded", 32, (4, 1)): ("triangle", ((4, 1), "sharded_triangle",
                                               b32, BUDGETS,
                                               dict(KW, block=4))),
        ("sharded", 32, (2, 2)): ("triangle", ((2, 2), "sharded_triangle",
                                               b32, BUDGETS,
                                               dict(KW, block=4))),
        ("ring", 32, (2, 2)): ("triangle", ((2, 2), "ring_triangle", b32,
                                            BUDGETS, KW)),
        ("ring", 29, (2, 2)): ("triangle", ((2, 2), "ring_triangle", b29,
                                            BUDGETS, KW)),
        ("sharded", "giant", (2, 2)): ("triangle", (
            (2, 2), "sharded_triangle", bg, BUDGETS, KW)),
        ("ring", "giant", (2, 2)): ("triangle", (
            (2, 2), "ring_triangle", bg, BUDGETS, KW)),
        ("sharded", "frag", (2, 2)): ("triangle_error", (
            (2, 2), "sharded_triangle", b8, FRAG_BUDGETS, dict(KW, block=4),
            FRAG_CFG)),
        ("ring", "frag", (2, 2)): ("triangle_error", (
            (2, 2), "ring_triangle", b8, FRAG_BUDGETS, KW, FRAG_CFG)),
    }
    ranks = tdist.launch(worker.run_all, 4, (jobs,), device="cpu",
                         timeout=400)
    for r in ranks[1:]:
        np.testing.assert_equal(r, ranks[0])
    return ranks[0]


@pytest.fixture(scope="module")
def single(family32, with_giant):
    """The JAX single-device triangle of each input, computed once."""
    cache = {}

    def get(n):
        if n not in cache:
            sk = with_giant if n == "giant" else family32[:n]
            cache[n] = triangle(sk, CFG, EngineBudgets(**BUDGETS), block=4,
                                group=8, anchors_per_pair=2048)
        return cache[n]
    return get


def _assert_same(got, want, single):
    """``got`` (port, mesh) vs ``want`` (JAX, same mesh function): every
    key, integers bit-equal, floats within 1e-6; the estimators vs the
    JAX single-device triangle ``single`` within 1e-6."""
    ri, qi, out = got
    wri, wqi, wout = want
    np.testing.assert_array_equal(ri, wri)
    np.testing.assert_array_equal(qi, wqi)
    np.testing.assert_array_equal(ri, single[0])
    # the port's packed tiles add frag_overflow, which the JAX mesh
    # triangle has only from its giant pairs: every genome fits here
    assert set(out) == set(wout) | {"frag_overflow"}
    np.testing.assert_array_equal(
        out["frag_overflow"], wout.get("frag_overflow",
                                       np.zeros(len(ri), bool)))
    for key, w in wout.items():
        val, w = out[key], np.asarray(w)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(val, w, rtol=0, atol=1e-6,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(val, w, err_msg=key)
    for key in FLOAT_KEYS:
        np.testing.assert_allclose(out[key], single[2][key], rtol=0,
                                   atol=1e-6, err_msg=key)


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_triangle_matches_jax(family32, port, single, shape):
    want = jax_dist.sharded_triangle(
        stack_sketches(family32),
        jax_make_mesh(*shape, devices=jax.devices()[:4]), cfg=CFG,
        budgets=EngineBudgets(**BUDGETS), block=4, **KW)
    got = port[("sharded", 32, shape)]
    assert len(got[0]) == 32 * 31 // 2
    _assert_same(got, want, single(32))


@pytest.mark.parametrize("n", [32, 29])
def test_ring_triangle_matches_jax(family32, port, single, n):
    """Blocks of ceil(n / 4) genomes round a ring of 4 ranks (the last
    round computed twice); n = 29 pads the last block with genome 0."""
    sketches = family32[:n]
    want = jax_dist.ring_triangle(
        stack_sketches(sketches),
        jax_make_mesh(2, 2, devices=jax.devices()[:4]), cfg=CFG,
        budgets=EngineBudgets(**BUDGETS), **KW)
    got = port[("ring", n, (2, 2))]
    assert len(got[0]) == n * (n - 1) // 2
    _assert_same(got, want, single(n))


@pytest.mark.parametrize("fn", ["sharded_triangle", "ring_triangle"])
def test_triangle_with_giant_genome_matches_jax(with_giant, port, single,
                                                fn):
    """A genome past 2^30 bp takes pairs_ani for its pairs, the others the
    mesh path; merged in triu order, a key one path lacks reads 0."""
    want = getattr(jax_dist, fn)(
        stack_sketches(with_giant),
        jax_make_mesh(2, 2, devices=jax.devices()[:4]), cfg=CFG,
        budgets=EngineBudgets(**BUDGETS), **KW)
    got = port[(fn.split("_")[0], "giant", (2, 2))]
    assert len(got[0]) == 8 * 7 // 2
    _assert_same(got, want, single("giant"))


@pytest.mark.parametrize("fn", ["sharded_triangle", "ring_triangle"])
def test_frag_budget_overflow_raises_where_jax_is_silent(family32, port, fn):
    """Genomes past ``max_fragments``: every rank of the port's mesh
    triangle raises through ``check_overflow`` (the tiles' planes carry
    ``frag_overflow``); the JAX mesh triangle returns results."""
    msg = port[(fn.split("_")[0], "frag", (2, 2))]
    assert msg is not None and "fragment budget overflow" in msg
    kw = dict(KW, block=4) if fn == "sharded_triangle" else KW
    ri, _, out = getattr(jax_dist, fn)(
        stack_sketches(family32[:8]),
        jax_make_mesh(2, 2, devices=jax.devices()[:4]),
        cfg=dataclasses.replace(CFG, **FRAG_CFG),
        budgets=EngineBudgets(**FRAG_BUDGETS), **kw)
    assert len(ri) == 28 and "frag_overflow" not in out


def test_ring_block_limit_raises_as_jax(family32):
    """One rank holds all 32 genomes: 32 * 32 * 256 fragment rows pass
    the 2^17 pair-grid limit, and both packages raise ValueError."""
    budgets = dict(BUDGETS, max_fragments=256)
    host = convert.sketch_from_numpy(_fields(family32), "stack", [], [],
                                     device="cpu").device
    with pytest.raises(ValueError, match="pair-grid limit"):
        tdist.ring_triangle(host, make_mesh(device="cpu"),
                            cfg=TChainConfig(), budgets=TBudgets(**budgets))
    with pytest.raises(ValueError, match="pair-grid limit"):
        jax_dist.ring_triangle(
            stack_sketches(family32),
            jax_make_mesh(1, 1, devices=jax.devices()[:1]), cfg=CFG,
            budgets=EngineBudgets(**budgets))


def test_one_rank_triangles_match_jax(family32, single):
    """On a 1 x 1 mesh in this process (no process group) both mesh
    triangles equal the JAX package's."""
    host = convert.sketch_from_numpy(_fields(family32[:8]), "stack", [],
                                     [], device="cpu").device
    mesh1 = jax_make_mesh(1, 1, devices=jax.devices()[:1])
    for fn in ("sharded_triangle", "ring_triangle"):
        kw = dict(KW, block=4) if fn == "sharded_triangle" else KW
        got = getattr(tdist, fn)(host, make_mesh(device="cpu"),
                                 cfg=TChainConfig(),
                                 budgets=TBudgets(**BUDGETS), **kw)
        want = getattr(jax_dist, fn)(stack_sketches(family32[:8]), mesh1,
                                     cfg=CFG,
                                     budgets=EngineBudgets(**BUDGETS), **kw)
        _assert_same(got, want, single(8))
