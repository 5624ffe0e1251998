"""Port ``chain_pairs`` (the full-range per-pair path) vs the JAX package.

The same numpy-made genomes are sketched by the JAX package and carried
across with ``convert``.  Pre-DP grids and integer outputs must be equal
bit for bit; f32 estimators and aligned fractions within 1e-6 absolute
(summation order and f32 ``pow`` may differ in the last ulp).
"""

import jax
import numpy as np
import pytest
import torch

from conftest import mutate, random_genome
from pyskani_tpu.engine.batch import stack_sketches, take_sketch
from pyskani_tpu.oracle.chain import ChainConfig as JaxChainConfig
from pyskani_tpu.ops import chain as jch
from pyskani_tpu.ops import sketch as jsk
from pyskani_tpu.params import SketchParams
from pyskani_tpu_torch import convert
from pyskani_tpu_torch.engine.batch import check_overflow
from pyskani_tpu_torch.ops import chain as tch
from pyskani_tpu_torch.ops.sketch import I32_SENTINEL

torch.set_num_threads(1)

SIZES = dict(max_anchors=4096, max_fragments=64, max_anchors_per_fragment=128)
FLOAT_KEYS = ("ani_mean", "ani_robust", "ani_median", "af_query", "af_ref")
NAMES = ("base", "multi", "seedless", "draft300", "mut")


def _revcomp(s: bytes) -> bytes:
    return s[::-1].translate(bytes.maketrans(b"ACGT", b"TGCA"))


def _split(genome: bytes, n: int):
    step = -(-len(genome) // n)
    return [genome[i:i + step] for i in range(0, len(genome), step)]


@pytest.fixture(scope="module")
def family():
    """(JAX stack, port stack) of 5 genomes: a 60 kb base, a 3-contig
    mutant with a reverse-complemented middle contig, a seedless sketch,
    a 300-contig draft and a plain mutant."""
    rng = np.random.default_rng(5)
    base = random_genome(rng, 60_000)
    m = mutate(rng, base, 0.02)
    genomes = [
        ([base], True),
        ([m[:20_000], _revcomp(m[20_000:45_000]), m[45_000:]], True),
        ([mutate(rng, base, 0.01)], False),
        (_split(mutate(rng, base, 0.01), 300), True),
        ([mutate(rng, base, 0.03)], True),
    ]
    sk = [jsk.sketch_genome_device(n, c, SketchParams(), seed_budget=1024,
                                   marker_budget=512, length_bucket=1 << 16,
                                   max_contigs=512, seed=s)
          for n, (c, s) in zip(NAMES, genomes)]
    stack = stack_sketches(sk)
    assert stack.contig_lengths.shape[1] == 512
    return stack, _port(stack)


def _port(stack):
    return convert.sketch_from_numpy(jax.device_get(stack), "stack", [], [],
                                     device="cpu").device


def _assert_outputs_equal(got, want, atol=1e-6, ref_overflow=None):
    """Every key equal to JAX's; ``frag_overflow`` is JAX's query-side flag
    ORed with ``ref_overflow``, the pairs whose reference grid the port
    flags and JAX truncates silently."""
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key].numpy()
        w = np.asarray(w)
        if key == "frag_overflow" and ref_overflow is not None:
            w = w | np.asarray(ref_overflow)
        assert g.shape == w.shape and g.dtype == w.dtype, key
        if key in FLOAT_KEYS:
            np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


@pytest.mark.parametrize("ri,qi,sizes", [
    (0, 1, SIZES),                                   # multi-contig, revcomp
    (3, 0, SIZES),                                   # 300-contig reference
    (0, 3, SIZES),                                   # 300-contig query
    (2, 0, SIZES),                                   # seedless reference
    (4, 1, dict(SIZES, max_anchors=128)),            # anchor pool clips
    (0, 3, dict(SIZES, max_fragments=8)),            # fragments overflow
    (1, 4, dict(SIZES, max_anchors_per_fragment=8)),  # rows cut to PF
])
def test_pre_dp_grids_bit_equal(family, ri, qi, sizes):
    jstack, tstack = family
    want = jax.device_get(jch._pre_dp(
        take_sketch(jstack, ri), take_sketch(jstack, qi), JaxChainConfig(),
        jch.EngineBudgets(**sizes)))
    grid, n_anchors, overflow, frag_overflow = tch._pre_dp(
        tch._take(tstack, ri), tch._take(tstack, qi), tch.ChainConfig(),
        tch.EngineBudgets(**sizes))
    for key in ("qpos", "rpos", "meta"):
        assert grid[key].dtype == torch.int32
        np.testing.assert_array_equal(grid[key].numpy(),
                                      np.asarray(want[0][key]), err_msg=key)
    assert n_anchors == int(want[1])
    assert overflow == bool(want[2])
    assert frag_overflow == bool(want[3])
    if ri != 2:
        assert n_anchors > 0
    if sizes["max_anchors"] == 128:
        assert overflow
    if sizes["max_fragments"] == 8:
        assert frag_overflow


def test_chain_pairs_matches_jax(family):
    """A stacked batch of pairs: multi-contig and reverse-complemented
    contigs, a seedless reference, a 300-contig draft on either side."""
    jstack, tstack = family
    ri = [0, 1, 2, 3, 0, 4]
    qi = [1, 0, 1, 0, 3, 3]
    want = jax.device_get(jch.chain_pairs(
        take_sketch(jstack, np.array(ri)), take_sketch(jstack, np.array(qi)),
        cfg=JaxChainConfig(), budgets=jch.EngineBudgets(**SIZES)))
    got = tch.chain_pairs(tstack.map(lambda x: x[torch.tensor(ri)]),
                          tstack.map(lambda x: x[torch.tensor(qi)]),
                          cfg=tch.ChainConfig(),
                          budgets=tch.EngineBudgets(**SIZES))
    # pair 3's reference is the 300-contig draft: 300 fragments, past
    # max_fragments = 64, so its reference grid drops kept anchors; JAX
    # drops them too and reports nothing there
    assert not bool(want["frag_overflow"][3])
    _assert_outputs_equal(got, want,
                          ref_overflow=[False, False, False, True, False,
                                        False])
    n = got["n_anchors"].numpy()
    assert (n[[0, 1, 3, 4, 5]] > 0).all() and n[2] == 0
    assert (got["ani_mean"].numpy()[[0, 1, 3, 4, 5]] > 0.9).all()


def _segments_case(rng):
    """Intervals over 5 contigs: nested, equal starts, touching, disjoint,
    empty (hi < lo), contig 3 absent, positions near 2^31."""
    cid = rng.integers(0, 5, 300)
    cid[cid == 3] = 4
    lo = rng.integers(0, 5000, 300)
    hi = lo + rng.integers(-3, 400, 300)
    lo[:20] = 100
    hi[:20] = 100 + np.arange(20) * 7
    lo[20:40] = (1 << 31) - 5000 + np.arange(20) * 100
    hi[20:40] = np.minimum(lo[20:40] + 300, (1 << 31) - 2)
    valid = rng.random(300) < 0.8
    return cid, lo, hi, valid


@pytest.mark.parametrize("case", ["mixed", "all_invalid", "one", "wide"])
def test_union_length_seg_matches_jax(case):
    rng = np.random.default_rng(9)
    cid, lo, hi, valid = _segments_case(rng)
    if case == "all_invalid":
        valid[:] = False
    elif case == "one":
        valid[:] = False
        valid[7] = True
    elif case == "wide":
        # a union above 2^24 bp: JAX sums in f32, the port in int64
        lo[:] = rng.integers(0, 1 << 30, 300)
        hi[:] = lo + rng.integers(0, 1 << 22, 300)
    want = float(jch._union_length_seg(
        jax.numpy.asarray(cid, np.int32), jax.numpy.asarray(lo, np.int32),
        jax.numpy.asarray(hi, np.int32), jax.numpy.asarray(valid)))
    got = tch._union_length_seg(*(torch.from_numpy(a) for a in
                                  (cid, lo, hi, valid)))
    assert got.dtype == torch.float32
    if case == "wide":
        assert want > 2**24
        assert float(got) == pytest.approx(want, rel=1e-6)
    else:
        assert float(got) == want
    # against a plain per-contig count of covered positions
    if case in ("mixed", "one"):
        cover = 0
        for c in np.unique(cid[valid]):
            sel = valid & (cid == c)
            pts = set()
            for a, b in zip(lo[sel], hi[sel]):
                pts.update(range(int(a), int(b) + 1))
            cover += len(pts)
        assert float(got) == cover


def _p_view(seeded: bool):
    """JAX DeviceSketch fields of an 8-contig table: contig 2 has no seeds,
    contig 4 has seeds near 2^31, contigs 5-7 are padding.  ``seeded=False``
    gives an empty seed table (a seed=False sketch)."""
    rng = np.random.default_rng(21)
    S = 64
    lens = np.array([900, 500, 300, 700, (1 << 31) - 1, 0, 0, 0], np.int32)
    n_per = [14, 9, 0, 11, 6] if seeded else [0] * 5
    cids, pos = [], []
    for c, k in enumerate(n_per):
        hi = int(lens[c])
        p = np.sort(rng.choice(np.arange(max(hi - 3000, 0), hi), k, False))
        cids += [c] * k
        pos += list(p)
    n = len(cids)
    p_cid = np.full(S, I32_SENTINEL, np.int32)
    p_pos = np.full(S, I32_SENTINEL, np.int32)
    p_cid[:n], p_pos[:n] = cids, pos
    own = np.zeros(S, np.int32)
    own[:n] = rng.integers(1, 25, n)
    return jsk.DeviceSketch(
        kmers=np.full(S, 0xFFFFFFFF, np.uint32), positions=p_pos,
        contig_ids=p_cid, strands=np.zeros(S, bool), own_mult=own,
        p_positions=p_pos, p_contig_ids=p_cid, p_own_mult=own,
        markers_hi=np.full(8, 0xFFFFFFFF, np.uint32),
        markers_lo=np.full(8, 0xFFFFFFFF, np.uint32),
        n_seeds=np.int32(n), n_markers=np.int32(0), contig_lengths=lens,
        n_contigs=np.int32(5), total_len=np.uint32(0xFFFFFFFF))


@pytest.mark.parametrize("seeded", [True, False])
@pytest.mark.parametrize("mask", ["own", "none"])
def test_count_seeds_in_spans_matches_jax(seeded, mask):
    """Edge cases: an empty contig, lo > hi, hi + 1 past the last seed,
    hi = NEG_BIG (no kept chain), positions near 2^31, contig ids out of
    range (clipped), and a seedless table."""
    jfields = _p_view(seeded)
    cfg_kw = dict(mask_repetitive_denom=mask)
    port = convert.sketch_from_numpy(vars(jfields), "p", [], [],
                                     device="cpu").device
    rng = np.random.default_rng(4)
    m = 400
    cid = rng.integers(-1, 9, m)
    lo = rng.integers(0, 1000, m)
    hi = lo + rng.integers(-50, 900, m)
    big = cid == 4
    lo[big] += (1 << 31) - 3000
    hi[big] = np.minimum(hi[big] + (1 << 31) - 3000, (1 << 31) - 2)
    hi[:10] = tch.NEG_BIG
    lo[10:20], hi[10:20] = 800, 100
    hi[20:30] = (1 << 31) - 2

    seg, prefix = jch._denom_tables(jfields, JaxChainConfig(**cfg_kw))
    want = np.asarray(jch._count_seeds_in_spans(
        jfields, seg, prefix, jax.numpy.asarray(cid, np.int32),
        jax.numpy.asarray(lo, np.int32), jax.numpy.asarray(hi, np.int32)))
    keys, tprefix = tch._denom_tables(port, tch.ChainConfig(**cfg_kw))
    got = tch._count_seeds_in_spans(port, keys, tprefix, torch.from_numpy(cid),
                                    torch.from_numpy(lo), torch.from_numpy(hi))
    np.testing.assert_array_equal(got.numpy(), want)
    if seeded:
        assert want.max() > 0
    else:
        assert (want == 0).all()

    # the bounded search itself, on every contig's segment
    c = np.clip(cid, 0, 7)
    for vals in (lo, hi + 1):
        want_i = np.asarray(jch._searchsorted_bounded(
            jax.numpy.asarray(jfields.p_positions), np.asarray(seg)[c],
            np.asarray(seg)[c + 1], jax.numpy.asarray(vals, np.int32)))
        got_i = tch._searchsorted_bounded(keys, torch.from_numpy(c),
                                          torch.from_numpy(vals))
        np.testing.assert_array_equal(got_i.numpy(), want_i)


def _shift_positions(fields: dict, contig: int, shift: int) -> dict:
    n = int(fields["n_seeds"])
    out = dict(fields)
    for pos_key, cid_key in (("positions", "contig_ids"),
                             ("p_positions", "p_contig_ids")):
        sel = (np.arange(len(fields[pos_key])) < n) & \
            (fields[cid_key] == contig)
        out[pos_key] = np.where(sel, fields[pos_key] + shift,
                                fields[pos_key]).astype(np.int32)
    clens = fields["contig_lengths"].copy()
    clens[contig] += shift
    out["contig_lengths"] = clens
    out["total_len"] = np.uint32(int(fields["total_len"]) + shift)
    return out


def test_contig_positions_beyond_2pow30():
    """In-contig positions above 2^30 (only the full-range path holds
    them) chain as the unshifted pair does, and as the JAX package does."""
    rng = np.random.default_rng(31)
    base = random_genome(rng, 200_000)
    params = SketchParams()
    ref = jsk.sketch_genome_device("r", [mutate(rng, base, 0.01)], params,
                                   length_bucket=1 << 18)
    query = jsk.sketch_genome_device("q", [base], params,
                                     length_bucket=1 << 18)
    SHIFT = 1_500_000_000              # a multiple of fragment_length
    rf, qf = ({k: np.asarray(v) for k, v in vars(d).items()}
              for d in jax.device_get([ref.device, query.device]))
    rf_shift = _shift_positions(rf, 0, SHIFT)
    cfg = dict(k=params.k, extend_right=params.k - 1,
               fragment_length=2_000_000)
    sizes = dict(max_fragments=1024, max_anchors_per_fragment=256)
    tq = convert.sketch_from_numpy(qf, "q", [], [], device="cpu").device
    outs = [tch.chain_pair(
        convert.sketch_from_numpy(f, "r", [], [], device="cpu").device, tq,
        cfg=tch.ChainConfig(**cfg), budgets=tch.EngineBudgets(**sizes))
        for f in (rf, rf_shift)]
    want = jax.device_get(jch.chain_pair(
        jsk.DeviceSketch(**rf_shift), query.device, cfg=JaxChainConfig(**cfg),
        budgets=jch.EngineBudgets(**sizes)))
    _assert_outputs_equal(outs[1], want)
    assert float(outs[0]["ani_mean"]) > 0.8
    for key in ("ani_mean", "ani_robust", "ani_median", "af_query"):
        assert abs(float(outs[0][key]) - float(outs[1][key])) < 1e-6, key
    scale = int(rf["total_len"]) / (int(rf["total_len"]) + SHIFT)
    assert float(outs[1]["af_ref"]) == pytest.approx(
        float(outs[0]["af_ref"]) * scale, rel=1e-5)


def test_block_matches_pairwise_beyond_256_contigs():
    """The packed block grid with rcid_bits > 8 equals the per-pair path
    (port against port)."""
    rng = np.random.default_rng(11)
    base = random_genome(rng, 400_000)
    params = SketchParams()
    genomes = [[base], _split(mutate(rng, base, 0.01), 300),
               [mutate(rng, base, 0.03)]]
    sk = [jsk.sketch_genome_device(f"g{i}", c, params, seed_budget=8192,
                                   marker_budget=512, length_bucket=1 << 18)
          for i, c in enumerate(genomes)]
    stack = _port(stack_sketches(sk))
    assert stack.contig_lengths.shape[1] == 512
    cfg = tch.ChainConfig()
    budgets = tch.EngineBudgets(max_anchors=16384, max_fragments=384,
                                max_anchors_per_fragment=256)
    out = tch.chain_block(stack, stack, cfg=cfg, budgets=budgets)
    assert not out["pos_overflow"].any()
    pairs = [(i, j) for i in range(3) for j in range(3) if i != j]
    single = tch.chain_pairs(
        stack.map(lambda x: x[torch.tensor([p[0] for p in pairs])]),
        stack.map(lambda x: x[torch.tensor([p[1] for p in pairs])]),
        cfg=cfg, budgets=budgets)
    for n, (i, j) in enumerate(pairs):
        for key in FLOAT_KEYS:
            assert abs(float(out[key][i, j]) - float(single[key][n])) <= \
                1e-6, (key, i, j)
    assert (single["ani_mean"] > 0.9).all()


def test_frag_overflow_raises(family):
    """Anchors past the fragment budget are dropped on the per-pair path:
    ``frag_overflow`` is set and ``check_overflow`` raises."""
    _, tstack = family
    budgets = tch.EngineBudgets(max_anchors=4096, max_fragments=1,
                                max_anchors_per_fragment=128)
    out = tch.chain_pairs(tstack.map(lambda x: x[:1]),
                          tstack.map(lambda x: x[4:5]),
                          cfg=tch.ChainConfig(), budgets=budgets)
    assert bool(out["frag_overflow"].any())
    with pytest.raises(RuntimeError, match="fragment budget overflow"):
        check_overflow({k: v.numpy() for k, v in out.items()}, budgets)


@pytest.mark.cuda
def test_cuda_chain_pairs_matches_cpu(family):
    """``chain_pairs`` on the card (the CUDA DP kernel) equals the CPU
    port (the plain DP)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from pyskani_tpu_torch.ops.chain_dp import chain_dp
    _, tstack = family
    ri, qi = torch.tensor([0, 1, 3, 2]), torch.tensor([1, 0, 0, 1])
    budgets = tch.EngineBudgets(**SIZES)
    want = tch.chain_pairs(tstack.map(lambda x: x[ri]),
                           tstack.map(lambda x: x[qi]),
                           cfg=tch.ChainConfig(), budgets=budgets)
    card = tstack.map(lambda x: x.cuda())
    before = chain_dp.launches
    got = tch.chain_pairs(card.map(lambda x: x[ri.cuda()]),
                          card.map(lambda x: x[qi.cuda()]),
                          cfg=tch.ChainConfig(), budgets=budgets)
    assert chain_dp.launches == before + 1
    for key, w in want.items():
        g = got[key].cpu()
        if key in FLOAT_KEYS:
            torch.testing.assert_close(g, w, rtol=0, atol=1e-6)
        else:
            assert torch.equal(g, w), key

