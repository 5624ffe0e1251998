"""Port ``engine/stream.py::stream_one_vs_many`` vs the JAX package.

The streamed search must give the in-memory ``one_vs_many`` results and
the JAX package's ``stream_one_vs_many`` for any chunking, a ragged last
chunk included, with every name loaded once; and a disk store's
``open()`` query whose shortlist holds a reference rerouted to the
per-pair path must equal the JAX package's ``open()`` query.
"""

import jax
import numpy as np
import pytest
import torch

import pyskani_tpu
import pyskani_tpu_torch
from conftest import mutate, random_genome
from pyskani_tpu.engine import batch as jax_batch
from pyskani_tpu.engine import stream as jax_stream
from pyskani_tpu.oracle.chain import ChainConfig as JaxChainConfig
from pyskani_tpu.ops.chain import EngineBudgets as JaxBudgets
from pyskani_tpu.ops.sketch import sketch_genome_device
from pyskani_tpu.params import SketchParams
from pyskani_tpu_torch import convert
from pyskani_tpu_torch import database as tdb
from pyskani_tpu_torch.engine import batch as tbatch
from pyskani_tpu_torch.engine.stream import stream_one_vs_many
from pyskani_tpu_torch.ops.chain import ChainConfig, EngineBudgets
from pyskani_tpu_torch.ops.sketch import FIELDS

torch.set_num_threads(1)

SIZES = dict(max_anchors=4096, max_fragments=64, max_anchors_per_fragment=128)
FLOAT_KEYS = ("ani_mean", "ani_robust", "ani_median", "af_query", "af_ref")


@pytest.fixture(scope="module")
def family():
    """tests/test_stream.py's family: 5 mutants of a 60 kb base at 0.5-2.5%
    and the base as the query, in both packages."""
    rng = np.random.default_rng(17)
    base = random_genome(rng, 60_000)
    kw = dict(seed_budget=1024, marker_budget=512, length_bucket=1 << 16,
              max_contigs=8)
    jsk = {f"g{i}": sketch_genome_device(f"g{i}", [mutate(rng, base,
                                                          0.005 * (i + 1))],
                                         SketchParams(), **kw)
           for i in range(5)}
    jq = sketch_genome_device("q", [base], SketchParams(), **kw)

    def port(h):
        return convert.sketch_from_numpy(jax.device_get(h.device), h.name,
                                         h.contig_names, h.lengths,
                                         device="cpu")

    return jsk, jq, {n: port(h) for n, h in jsk.items()}, port(jq)


@pytest.mark.parametrize("chunk", [1, 2, 5, 16])
@pytest.mark.parametrize("cfg_kw", [{}, dict(est_ci=True)],
                         ids=["plain", "est_ci"])
def test_stream_matches_memory_and_jax(family, chunk, cfg_kw):
    jsk, jq, tsk, tq = family
    names = list(tsk)
    budgets = EngineBudgets(**SIZES)
    cfg = ChainConfig(**cfg_kw)
    qpad = tbatch.repad_sketch(tq, 1024, 512, max_contigs=8)
    stack = tbatch.stack_sketches(list(tsk.values()), 1024, 512)
    mem = tbatch.one_vs_many(stack, qpad, np.arange(len(names)), cfg=cfg,
                             budgets=budgets, chunk=2)
    want = jax_stream.stream_one_vs_many(
        lambda n: jsk[n], names, jax_batch.repad_sketch(jq, 1024, 512,
                                                        max_contigs=8),
        cfg=JaxChainConfig(**cfg_kw), budgets=JaxBudgets(**SIZES),
        seed_budget=1024, marker_budget=512, chunk=chunk)
    loads = []

    def load(name):
        loads.append(name)
        return tsk[name]

    got = stream_one_vs_many(load, names, qpad, cfg=cfg, budgets=budgets,
                             seed_budget=1024, marker_budget=512,
                             chunk=chunk)
    assert sorted(loads) == sorted(names)
    # the port's one key beyond JAX's: every genome fits the budget
    assert set(got) == set(mem) == set(want) | {"frag_overflow"}
    assert not got["frag_overflow"].any()
    np.testing.assert_array_equal(got["frag_overflow"],
                                  mem["frag_overflow"].numpy())
    for key, w in want.items():
        g = got[key]
        assert isinstance(g, np.ndarray) and g.shape == (len(names),), key
        if key in FLOAT_KEYS or key.startswith("ani_ci"):
            np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-6,
                                       err_msg=f"{key} chunk={chunk}")
            np.testing.assert_allclose(g, mem[key].numpy(), rtol=0,
                                       atol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=key)
            np.testing.assert_array_equal(g, mem[key].numpy(), err_msg=key)


def test_stream_ragged_chunk_pads_with_its_own_first(family):
    """A pool small enough to clip: the ragged last chunk's padding pairs
    share its pool, so padding with the chunk's own first reference (as
    the JAX package does) is what keeps the anchors equal."""
    jsk, jq, tsk, tq = family
    names = list(tsk)
    small = dict(SIZES, max_anchors=200)
    want = jax_stream.stream_one_vs_many(
        lambda n: jsk[n], names, jax_batch.repad_sketch(jq, 1024, 512,
                                                        max_contigs=8),
        cfg=JaxChainConfig(), budgets=JaxBudgets(**small), seed_budget=1024,
        marker_budget=512, chunk=2)
    got = stream_one_vs_many(
        tsk.__getitem__, names, tbatch.repad_sketch(tq, 1024, 512,
                                                    max_contigs=8),
        cfg=ChainConfig(), budgets=EngineBudgets(**small), seed_budget=1024,
        marker_budget=512, chunk=2)
    assert np.asarray(want["anchors_overflow"]).any()
    for key in ("n_anchors", "anchors_overflow", "n_fragments"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    for key in FLOAT_KEYS:
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=0,
                                   atol=1e-6, err_msg=key)


def test_stream_empty():
    assert stream_one_vs_many(lambda n: None, [], None, cfg=ChainConfig(),
                              budgets=EngineBudgets(**SIZES), seed_budget=64,
                              marker_budget=64) == {}


def test_stack_sketches_host_matches_jax(family):
    """The host stack equals JAX's ``stack_sketches_host`` field by field
    (a given contig budget), and ``stack_sketches`` (the default one)."""
    jsk, _, tsk, _ = family
    want = jax_batch.stack_sketches_host(list(jsk.values()), 1024, 512, 16)
    host = tbatch.stack_sketches_host(list(tsk.values()), 1024, 512, 16)
    assert host.device == torch.device("cpu")
    assert host.contig_lengths.shape == (5, 16)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(host, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    host = tbatch.stack_sketches_host(list(tsk.values()), 1024, 512)
    dev = tbatch.stack_sketches(list(tsk.values()), 1024, 512)
    for f in FIELDS:
        assert torch.equal(getattr(host, f), getattr(dev, f)), f


def _split(genome: bytes, n: int):
    step = -(-len(genome) // n)
    return [genome[i:i + step] for i in range(0, len(genome), step)]


@pytest.mark.parametrize("fmt", ["consolidated", "separated"])
def test_open_query_with_rerouted_reference_matches_jax(tmp_path, fmt):
    """A store of a complete 600 kb genome past the packed range of a
    related 4100-contig draft, written by the JAX package: ``open()``
    streams the draft (block path) and stacks the complete genome on the
    per-pair path; the hits equal the JAX package's ``open()`` query."""
    rng = np.random.default_rng(23)
    base = random_genome(rng, 600_000)
    draft = _split(mutate(rng, base, 0.04), 600) + \
        [random_genome(rng, 1000) for _ in range(3500)]
    q = mutate(rng, base, 0.01)
    with pyskani_tpu.Database(tmp_path, format=fmt) as jdb:
        jdb.sketch("giant", base)
        jdb.sketch("draft", *draft)
    want = pyskani_tpu.Database.open(tmp_path).query("q", q)
    port = pyskani_tpu_torch.Database.open(tmp_path, device="cpu")
    by_name = {m.name: m for m in port._markers}
    assert tdb._partition_blockable(by_name, ["giant", "draft"])[:2] == \
        (["draft"], ["giant"])
    got = port.query("q", q)
    assert [h.reference_name for h in got] == \
        [h.reference_name for h in want] == ["giant", "draft"]
    for g, w in zip(got, want):
        for attr in ("identity", "query_fraction", "reference_fraction"):
            assert getattr(g, attr) == pytest.approx(getattr(w, attr),
                                                     abs=1e-6), attr


@pytest.mark.cuda
def test_cuda_stream_matches_cpu(family):
    """On the card the chunks go through pinned buffers and non-blocking
    copies; the results equal the CPU run."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    _, _, tsk, tq = family
    names = list(tsk)
    kw = dict(cfg=ChainConfig(est_ci=True), budgets=EngineBudgets(**SIZES),
              seed_budget=1024, marker_budget=512, chunk=2)
    qpad = tbatch.repad_sketch(tq, 1024, 512, max_contigs=8)
    want = stream_one_vs_many(tsk.__getitem__, names, qpad, **kw)
    got = stream_one_vs_many(tsk.__getitem__, names,
                             qpad.map(lambda t: t.cuda()), **kw)
    for key, w in want.items():
        if w.dtype == np.float32:
            np.testing.assert_allclose(got[key], w, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(got[key], w)
