"""Per-chain stage of the packed post-DP (``ops/chain_post.py``).

``chain_post_plain`` (what ``chain_post`` runs for CPU tensors) is held
to a NumPy loop over rows and roots on hand-built [P*NF, PF] grids: rows
empty and full, roots at 0 and PF - 1, the score and long-span keep
rules, both ``est_side`` modes, kept anchors past the reference grid, and
more kept chains than ``max_chains_per_pair``.  The wrapper's refusals
and the CPU paths' silent ``post_kernel_pairs`` counter are checked here
too.  Where a card is present, the CUDA kernel is held bit-equal to the
plain version on DP-made grids at the triangle's shapes, and the
triangle and one-vs-many paths give bit-equal results through it.
The file imports neither JAX nor ``conftest``'s helpers, so it runs on a
card's machine with ``--noconftest``.
"""

import numpy as np
import pytest
import torch

from pyskani_tpu_torch.ops import chain as chain_mod
from pyskani_tpu_torch.ops.chain import NEG_BIG, POS_BIG, ChainConfig
from pyskani_tpu_torch.ops.chain_dp import chain_dp
from pyskani_tpu_torch.ops.chain_post import (KEYS, MAX_PF, chain_post,
                                              chain_post_plain)
from pyskani_tpu_torch.ops.sketch import I32_SENTINEL
from pyskani_tpu_torch.utils import profiling

torch.set_num_threads(1)

RBITS = 3
CR = 1 << RBITS          # reference contig slots
FL = 1000                # fragment length of the hand-built grids


def _grid(P, NF, PF, *, seed, full=0.1, empty=0.3, root0=0.0, new=0.3,
          rpos_hi=30_000, G=3, dev="cpu"):
    """Hand-built stage inputs: rows of random counts (a share ``empty``
    with none, a share ``full`` with PF or more), the valid prefix packed
    as the grid words, scores in [50, 400], and roots that start a chain
    with probability ``new`` or join an earlier anchor's chain (every
    anchor of a share ``root0`` of the rows joins column 0's)."""
    rng = np.random.default_rng(seed)
    R = P * NF
    counts = rng.integers(1, PF + 1, R)
    counts[rng.random(R) < full] = PF + rng.integers(0, 4)
    counts[rng.random(R) < empty] = 0
    n = np.minimum(counts, PF)
    valid = np.arange(PF)[None, :] < n[:, None]
    qpos = rng.integers(0, 1 << 29, (R, PF))
    rpos = rng.integers(0, rpos_hi, (R, PF))
    rcid = rng.integers(0, CR, (R, PF))
    rev = rng.integers(0, 2, (R, PF))
    w1 = np.where(valid, (qpos << 2) | (rev << 1) | 1, 0)
    w2 = np.where(valid, (rpos << RBITS) | rcid, 0)
    roots = np.zeros((R, PF), np.int64)
    all0 = rng.random(R) < root0
    for r in range(R):
        for j in range(1, PF):
            if all0[r]:
                roots[r, j] = 0
            elif rng.random() >= new:
                roots[r, j] = roots[r, rng.integers(0, j)]
            else:
                roots[r, j] = j
    scores = rng.uniform(50, 400, (R, PF)).astype(np.float32)
    # reference fragment offsets of G genomes, CR contigs of 1-12
    # fragments each
    fo = np.zeros((G, CR + 1), np.int64)
    fo[:, 1:] = np.cumsum(rng.integers(1, 13, (G, CR)), 1)
    as_t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    return dict(
        w1g=as_t(w1), w2g=as_t(w2), scores=as_t(scores),
        roots=as_t(roots.astype(np.int32)),
        row_bounds=as_t(np.concatenate([[0], np.cumsum(counts)])),
        tail_r=as_t(rng.integers(0, G, P)), r_frag_offs=as_t(fo))


def _oracle(g, cfg, NF, CE):
    """The stage as a loop over rows and roots in NumPy."""
    w1, w2, sc, rt = (g[k].numpy() for k in ("w1g", "w2g", "scores",
                                             "roots"))
    tail_r, fo = g["tail_r"].numpy(), g["r_frag_offs"].numpy()
    R, PF = w1.shape
    P = R // NF
    Cr = fo.shape[1] - 1
    rmask = (1 << RBITS) - 1
    fl = cfg.fragment_length
    o = dict(numer=np.zeros(R, np.int64), span_lo=np.full(R, POS_BIG),
             span_hi=np.full(R, NEG_BIG), n_chains=np.zeros(P, np.int32),
             row_sel=np.zeros((P, CE), np.int64),
             end_valid=np.zeros((P, CE), bool),
             end_qmn=np.full((P, CE), I32_SENTINEL),
             end_qmx=np.full((P, CE), I32_SENTINEL),
             end_rmn=np.full((P, CE), I32_SENTINEL),
             end_rmx=np.full((P, CE), I32_SENTINEL),
             end_rcid=np.zeros((P, CE), np.int64),
             numer_r=np.zeros((P, NF), np.int64),
             ref_over=np.zeros(P, bool))
    for p in range(P):
        for f in range(NF):
            r = p * NF + f
            chains = {}
            for j in np.nonzero(w1[r] & 1)[0]:
                chains.setdefault(min(max(int(rt[r, j]), 0), PF - 1),
                                  []).append(j)
            kept = set()
            for b in sorted(chains):
                js = chains[b]
                qmn, qmx = w1[r, js].min() >> 2, w1[r, js].max() >> 2
                k = len(js) >= cfg.min_anchors_chain
                if cfg.min_chain_score > 0:
                    k &= bool(sc[r, js].max() >=
                              np.float32(cfg.min_chain_score))
                if cfg.keep_long_span > 0:
                    k |= len(js) >= 2 and qmx - qmn >= cfg.keep_long_span
                if not k:
                    continue
                kept.add(b)
                o["numer"][r] += len(js)
                o["span_lo"][r] = min(o["span_lo"][r], qmn - cfg.extend_left)
                o["span_hi"][r] = max(o["span_hi"][r],
                                      qmx + cfg.extend_right)
                s = o["n_chains"][p]
                o["n_chains"][p] += 1
                if s < CE:
                    rmn, rmx = w2[r, js].min(), w2[r, js].max()
                    o["row_sel"][p, s] = f
                    o["end_valid"][p, s] = True
                    o["end_qmn"][p, s], o["end_qmx"][p, s] = qmn, qmx
                    o["end_rmn"][p, s] = rmn >> RBITS
                    o["end_rmx"][p, s] = rmx >> RBITS
                    o["end_rcid"][p, s] = rmn & rmask
            if cfg.est_side != "both":
                continue
            for b in kept:
                for j in chains[b]:
                    rcid = min(max(int(w2[r, j] & rmask), 0), Cr - 1)
                    frag = fo[tail_r[p], rcid] + (w2[r, j] >> RBITS) // fl
                    if frag < NF:
                        o["numer_r"][p, frag] += 1
                    else:
                        o["ref_over"][p] = True
    return o


BASE = dict(P=3, NF=8, PF=48)
CASES = {
    # name: (grid arguments, config fields, max_chains_per_pair)
    "empty_and_full": (dict(full=0.4, empty=0.4), {}, 64),
    "roots_at_0": (dict(root0=0.5, full=0.3), {}, 64),
    "roots_at_pf_minus_1": (dict(full=0.9, empty=0.0, new=0.9), {}, 512),
    "keep_long_span": (dict(new=0.2), dict(min_chain_score=1e9,
                                           keep_long_span=2_500), 64),
    "min_chain_score": (dict(), dict(min_chain_score=300.5,
                                     keep_long_span=0), 64),
    "no_score_rule": (dict(), dict(min_chain_score=0.0,
                                   min_anchors_chain=3), 64),
    "est_chunk": (dict(rpos_hi=400_000), dict(est_side="chunk"), 64),
    "est_both": (dict(), dict(est_side="both"), 64),
    "ref_over": (dict(rpos_hi=400_000), dict(est_side="both"), 64),
    "truncated_at_ce": (dict(new=0.6, empty=0.0), dict(min_chain_score=0.0),
                        5),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_oracle(case):
    kw, fields, CE = CASES[case]
    g = _grid(**BASE, seed=sorted(CASES).index(case), **kw)
    cfg = ChainConfig(fragment_length=FL, **fields)
    NF = BASE["NF"]
    got = chain_post(*g.values(), cfg, NF=NF, CE=CE, rcid_bits=RBITS)
    want = _oracle(g, cfg, NF, CE)
    assert tuple(got) == KEYS
    for k in KEYS:
        assert got[k].dtype == torch.from_numpy(want[k]).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    # each case exercises what it names
    n = torch.clamp(g["row_bounds"].diff(), max=BASE["PF"])
    kept = int(got["n_chains"].sum())
    assert kept > 0
    if case == "empty_and_full":
        assert (n == 0).any() and (g["row_bounds"].diff() > n).any()
    if case == "roots_at_0":
        assert (g["roots"][n > 1, 1:] == 0).all(1).any()
    if case == "roots_at_pf_minus_1":
        full = n == BASE["PF"]
        assert (g["roots"][full, -1] == BASE["PF"] - 1).any()
    if case == "keep_long_span":
        assert (got["end_qmx"] - got["end_qmn"])[got["end_valid"]].min() \
            >= 2_500
    if case in ("est_chunk", "ref_over"):
        assert got["ref_over"].any() == (case == "ref_over")
    if case == "est_chunk":
        assert not got["numer_r"].any()
    if case == "est_both":
        assert got["numer_r"].sum() > 0
    if case == "truncated_at_ce":
        assert (got["n_chains"] > CE).all() and got["end_valid"].all()


def test_dp_grid_matches_oracle():
    """Grids whose scores and roots are the chain DP's (plain version),
    as the pipeline feeds the stage."""
    g = _dp_grid(2, 16, 64, seed=7, dev="cpu")
    # fragments long enough that some kept anchors fall inside NF = 16
    cfg = ChainConfig(fragment_length=500_000)
    got = chain_post(*g.values(), cfg, NF=16, CE=128, rcid_bits=RBITS)
    want = _oracle(g, cfg, 16, 128)
    assert int(got["n_chains"].sum()) > 0 and got["numer_r"].sum() > 0
    for k in KEYS:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def _small():
    return _grid(P=1, NF=2, PF=8, seed=0)


@pytest.mark.parametrize("which,bad,match", [
    ("w1g", lambda t: t.to(torch.int32), "w1g must be"),
    ("scores", lambda t: t.to(torch.float64), "scores must be"),
    ("roots", lambda t: t.to(torch.int64), "roots must be"),
    ("row_bounds", lambda t: t[:-1], "row_bounds must be"),
    ("tail_r", lambda t: t.to(torch.int32), "tail_r must be"),
    ("w2g", lambda t: t.to("meta"), "CUDA device"),
])
def test_wrapper_refuses(which, bad, match):
    g = _small()
    g[which] = bad(g[which])
    with pytest.raises(ValueError, match=match):
        chain_post(*g.values(), ChainConfig(), NF=2, CE=8, rcid_bits=RBITS)


def test_wrapper_refuses_pf_past_limit():
    PF = MAX_PF + 2
    z = torch.zeros((1, PF), dtype=torch.int64)
    with pytest.raises(ValueError, match="exceeds the kernel's limit"):
        chain_post(z, z, z.float(), z.int(), torch.zeros(2, dtype=torch.int64),
                   torch.zeros(1, dtype=torch.int64),
                   torch.zeros((1, 2), dtype=torch.int64), ChainConfig(),
                   NF=1, CE=8, rcid_bits=RBITS)


def test_cpu_paths_count_no_kernel_pairs():
    import pyskani_tpu_torch
    (_, a), (_, b), (_, q) = _genomes(3, 40_000, 3)
    before = chain_post.launches
    profiling.reset_stats()
    profiling.enable()
    try:
        chain_post(*_small().values(), ChainConfig(), NF=2, CE=8,
                   rcid_bits=RBITS)
        db = pyskani_tpu_torch.Database(device="cpu")
        db.sketch("a", *a)
        db.sketch("b", *b)
        hits = db.query("q", *q)
        snap = profiling.stats().snapshot()
    finally:
        profiling.disable()
        profiling.reset_stats()
    assert len(hits) == 2
    assert snap["counters"]["pairs_chained"] == 2
    assert "post_kernel_pairs" not in snap["counters"]
    assert chain_post.launches == before


# ---------------------------------------------------------------- card


def _dp_grid(P, NF, PF, *, seed, dev):
    """Stage inputs as the pipeline makes them: near-diagonal anchor rows
    (breaks every ~30 anchors, either strand, 1-3 ref contigs a row,
    a third of the rows empty, some past PF), packed, and the chain DP's
    scores and roots on ``dev``."""
    rng = np.random.default_rng(seed)
    R = P * NF
    counts = rng.integers(1, PF + PF // 4, R)
    counts[rng.random(R) < 0.33] = 0
    n = np.minimum(counts, PF)
    valid = np.arange(PF)[None, :] < n[:, None]
    rcid = np.cumsum(rng.random((R, PF)) < 0.01, 1) % 3
    rpos = np.cumsum(rng.integers(1, 250, (R, PF)), 1) + \
        rng.integers(0, 7_000_000, (R, 1))
    brk = np.cumsum(rng.random((R, PF)) < 0.03, 1) * 7_919
    rev = rng.integers(0, 2, (R, 1))
    jit = rng.integers(-3, 4, (R, PF))
    base = rng.integers(10_000_000, 20_000_000, (R, 1))
    qpos = np.where(rev == 1, base - rpos, base + rpos) + jit + brk
    w1 = np.where(valid, (qpos << 2) | (rev << 1) | 1, 0)
    w2 = np.where(valid, (rpos << RBITS) | rcid, 0)
    fo = np.zeros((4, CR + 1), np.int64)
    fo[:, 1:] = np.cumsum(rng.integers(10, 30, (4, CR)), 1)
    as_t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    w1g, w2g = as_t(w1), as_t(w2)
    grid = chain_mod._dp_grid_from_words(w1g, w2g, RBITS)
    scores, roots = chain_dp(grid["qpos"], grid["rpos"], grid["meta"],
                             ChainConfig())
    return dict(w1g=w1g, w2g=w2g, scores=scores, roots=roots,
                row_bounds=as_t(np.concatenate([[0], np.cumsum(counts)])),
                tail_r=as_t(rng.integers(0, 4, P)), r_frag_offs=as_t(fo))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("P,NF,PF,fields", [
    (28, 384, 256, {}),
    (325, 384, 256, {}),
    (325, 384, 256, dict(est_side="chunk")),
    (28, 384, 256, dict(min_chain_score=0.0, keep_long_span=0)),
    (16, 384, 512, {}),
    (8, 64, 101, {}),          # odd PF: the kernel's scalar loads
    # two pairs of a large genome: a pair's [NF] numerators do not fit in
    # shared memory beside the bins, so the kernel adds them by global
    # atomics into the pair's own row
    (2, 50_000, 256, {}),
])
def test_cuda_kernel_matches_plain(P, NF, PF, fields):
    _need_card()
    if NF == 50_000:
        props = torch.cuda.get_device_properties(0)
        optin = getattr(props, "shared_memory_per_block_optin", 227 * 1024)
        # the launcher's bins (8 warps x 24 B x PF) and [NF] int32
        # histogram past its room (the opt-in less 1 KB of static memory)
        assert 8 * 24 * PF + 4 * NF > optin - 1024
    g = _dp_grid(P, NF, PF, seed=P + PF, dev="cuda")
    cfg = ChainConfig(**fields)
    for CE in (2048, 7):
        before = chain_post.launches
        got = chain_post(*g.values(), cfg, NF=NF, CE=CE, rcid_bits=RBITS)
        assert chain_post.launches == before + 1
        want = chain_post_plain(g["w1g"], g["w2g"], g["scores"], g["roots"],
                                g["tail_r"], g["r_frag_offs"], cfg, NF=NF,
                                CE=CE, rcid_bits=RBITS)
        torch.cuda.synchronize()
        assert int(want["n_chains"].sum()) > 0
        for k in KEYS:
            assert torch.equal(got[k], want[k]), (k, P, NF, PF, CE)


@pytest.fixture
def plain_on_card(monkeypatch):
    """Route ``ops/chain.py``'s per-chain stage through the plain version
    (on the card's tensors)."""
    def plain(w1g, w2g, scores, roots, row_bounds, tail_r, r_frag_offs,
              cfg, *, NF, CE, rcid_bits):
        return chain_post_plain(w1g, w2g, scores, roots, tail_r,
                                r_frag_offs, cfg, NF=NF, CE=CE,
                                rcid_bits=rcid_bits)
    return lambda: monkeypatch.setattr(chain_mod, "chain_post", plain)


def _genomes(n, length, seed):
    """``n`` genomes of one random root with 0.2-4.2% substitutions."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = rng.choice(acgt, length)
    out = []
    for i in range(n):
        g = base.copy()
        at = rng.integers(0, length, int(length * (0.002 + 0.005 * i)))
        g[at] = rng.choice(acgt, at.size)
        out.append((f"g{i}", [g.tobytes()]))
    return out


@pytest.mark.cuda
def test_cuda_triangle_bit_equal(plain_on_card):
    _need_card()
    from pyskani_tpu_torch.database import _chain_cfg_for
    from pyskani_tpu_torch.engine.batch import triangle
    from pyskani_tpu_torch.ops.sketch import sketch_genomes_device
    from pyskani_tpu_torch.params import SketchParams
    params = SketchParams()
    sketches = sketch_genomes_device(_genomes(9, 300_000, 1), params,
                                     device="cuda")
    cfg = _chain_cfg_for(params)
    before = chain_post.launches
    profiling.reset_stats()
    profiling.enable()
    try:
        _, _, got = triangle(sketches, cfg=cfg, group=6)
        counters = profiling.stats().snapshot()["counters"]
    finally:
        profiling.disable()
        profiling.reset_stats()
    # two groups (6 and 3 genomes) and one 6 x 6 cross tile
    assert chain_post.launches == before + 3
    assert counters["post_kernel_pairs"] == 15 + 3 + 36
    plain_on_card()
    _, _, want = triangle(sketches, cfg=cfg, group=6)
    assert chain_post.launches == before + 3
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["ani_mean"] > 0.9).all()


@pytest.mark.cuda
def test_cuda_one_vs_many_bit_equal(plain_on_card):
    _need_card()
    import pyskani_tpu_torch
    genomes = _genomes(6, 300_000, 2)
    db = pyskani_tpu_torch.Database()
    for name, contigs in genomes[1:]:
        db.sketch(name, *contigs)
    query = genomes[0][1][0]
    before = chain_post.launches
    got = db.query("q", query)
    assert chain_post.launches > before
    plain_on_card()
    launched = chain_post.launches
    want = db.query("q", query)
    assert chain_post.launches == launched
    assert len(got) == 5
    fields = lambda h: (h.reference_name, h.identity, h.query_fraction,
                        h.reference_fraction)
    assert [fields(h) for h in got] == [fields(h) for h in want]
