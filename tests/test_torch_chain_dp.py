"""Port chain DP vs the JAX package: bit-equal scores and roots.

The plain PyTorch DP (what ``chain_dp`` runs for CPU tensors) must equal
the JAX ``_dp_scan`` on the same row-major [R, PF] grids, and the Pallas
kernel in interpret mode through a transpose, on the fixture of
``test_device_chain.py::test_pallas_dp_matches_scan`` and on a tie-heavy
grid.  Edge grids pin what the warp-per-row CUDA kernel is prone to: PF
not a multiple of 32, bands 1, 25 and 32, anchors that resume after 32 or
more invalid columns, empty rows, and a tie whose two predecessors lie in
different 32-column chunks.  The CUDA kernel is held against the plain
version on all of them where a card is present.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyskani_tpu.oracle.chain import ChainConfig as JaxChainConfig
from pyskani_tpu.ops.chain import (EngineBudgets, _dp_grid_from_words,
                                   _dp_scan, _pack_grid_words)
from pyskani_tpu.ops.chain_dp_pallas import dp_pallas
from pyskani_tpu_torch.ops.chain import ChainConfig
from pyskani_tpu_torch.ops.chain_dp import chain_dp, chain_dp_plain

torch.set_num_threads(1)

RBITS = 3


def _pack(qpos, rpos, rcid, rev, ok):
    w1, w2 = _pack_grid_words(jnp.asarray(qpos), jnp.asarray(rpos),
                              jnp.asarray(rcid), jnp.asarray(rev),
                              jnp.asarray(ok), RBITS)
    return _dp_grid_from_words(w1, w2, RBITS), rcid, rev, ok


def _grid(kind: str, NF: int = 24, PF: int = 64):
    """[NF, PF] anchor rows sorted by (rcid, rpos) like the engine's.
    "random": near-diagonal anchors (test_device_chain's fixture);
    "ties": small coordinates, so many predecessors tie."""
    rng = np.random.default_rng(99 if kind == "random" else 7)
    qpos = np.zeros((NF, PF), np.int32)
    rpos = np.zeros((NF, PF), np.int32)
    rcid = np.zeros((NF, PF), np.int32)
    rev = np.zeros((NF, PF), bool)
    ok = np.zeros((NF, PF), bool)
    for r in range(NF):
        k = int(rng.integers(0, PF + 1))
        if kind == "random":
            rp = np.sort(rng.integers(0, 1 << 14, k))
            qp = np.clip(rp + rng.integers(-2000, 2000, k), 0, (1 << 14) - 1)
            cid = np.sort(rng.integers(0, 6, k))
        else:
            rp = np.sort(rng.integers(0, 160, k))
            qp = np.clip(rp + rng.integers(-3, 4, k), 0, None)
            cid = np.sort(rng.integers(0, 2, k))
        order = np.lexsort((rp, cid))
        rpos[r, :k] = rp[order]
        qpos[r, :k] = qp[order]
        rcid[r, :k] = cid[order]
        rev[r, :k] = rng.random(k) < 0.3
        ok[r, :k] = True
    return _pack(qpos, rpos, rcid, rev, ok)


# edge case -> (valid pattern, PF, chain_band)
EDGES = {
    "pf100": ("prefix", 100, 25),
    "band1": ("runs", 96, 1),
    "band25": ("runs", 96, 25),
    "band32": ("runs", 96, 32),
    "resume": ("resume", 128, 32),
    "empty": ("empty", 64, 25),
    "cross_chunk_tie": ("tie", 64, 25),
}


def _edge_grid(case: str, NF: int = 16):
    """[NF, PF] tie-heavy rows (small near-diagonal coordinates) whose
    valid anchors follow the case's pattern: a prefix, alternating valid
    and invalid runs of 1-44 columns, valid columns resuming after 40
    invalid ones, every other row empty, or a planted tie (below)."""
    pattern, PF, band = EDGES[case]
    rng = np.random.default_rng(sorted(EDGES).index(case))
    rpos = np.sort(rng.integers(0, 400, (NF, PF)), 1).astype(np.int32)
    qpos = np.clip(rpos + rng.integers(-4, 5, (NF, PF)), 0,
                   None).astype(np.int32)
    rcid = (rng.random((NF, PF)) < 0.1).cumsum(1).astype(np.int32) % 8
    rev = rng.random((NF, PF)) < 0.3
    cols = np.arange(PF)
    ok = np.zeros((NF, PF), bool)
    for r in range(NF):
        if pattern == "prefix":
            ok[r] = cols < rng.integers(0, PF + 1)
        elif pattern == "runs":
            c, v = 0, bool(r % 2)
            while c < PF:
                n = int(rng.integers(1, 45))
                ok[r, c:c + n] = v
                c, v = c + n, not v
        elif pattern == "resume":
            stop = int(rng.integers(1, 40))
            ok[r] = (cols < stop) | (cols >= stop + 40)
        elif pattern == "empty":
            ok[r] = (r % 2 == 0) & (cols < rng.integers(0, PF + 1))
        else:
            ok[r] = True
    if pattern == "tie":
        # anchor 33 (diagonal r-q = 0) has two chain heads at gap 5 with
        # equal candidates: column 30 (diagonal -5, previous chunk) and
        # column 32 (diagonal +5, this chunk); it must take the more recent
        # column 32.  Column 31 is invalid, and columns 30 and 32 do not
        # chain to each other (q falls as r rises).
        r = 0
        ok[r, 31] = False
        for col, (rp, qp) in {30: (90, 95), 32: (91, 86),
                              33: (100, 100)}.items():
            rpos[r, col], qpos[r, col] = rp, qp
            rcid[r, col], rev[r, col] = 0, False
        rpos[r, :30] = np.arange(30) * 3          # no predecessor
        qpos[r, :30] = 1000 - np.arange(30)       # of column 30 chains
        rcid[r, :30], rev[r, :30] = 0, False
    return _pack(qpos, rpos, rcid, rev, ok)


def _scan(grid, rcid, rev, ok, band):
    NF, PF = ok.shape
    return _dp_scan(
        dict(qpos=grid["qpos"], rpos=grid["rpos"],
             qcid=jnp.zeros((NF, PF), jnp.int32),
             rcid=jnp.asarray(np.where(ok, rcid, 0x7FFFFFFF)),
             rev=jnp.asarray(rev), valid=jnp.asarray(ok)),
        JaxChainConfig(chain_band=band),
        EngineBudgets(max_fragments=NF, max_anchors_per_fragment=PF))


def _planes(grid, device="cpu"):
    return [torch.from_numpy(np.array(grid[k])).to(device)
            for k in ("qpos", "rpos", "meta")]


def _assert_same(s, r, s_ref, r_ref):
    np.testing.assert_array_equal(
        s.numpy().view(np.int32),
        np.ascontiguousarray(np.asarray(s_ref)).view(np.int32))
    np.testing.assert_array_equal(r.numpy(), np.asarray(r_ref))


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_plain_dp_matches_scan_and_pallas(kind):
    grid, rcid, rev, ok = _grid(kind)
    s_scan, r_scan = _scan(grid, rcid, rev, ok, 25)
    s_pal, r_pal = dp_pallas(grid["qpos"].T, grid["rpos"].T,
                             grid["meta"].T, JaxChainConfig(chain_band=25),
                             interpret=True)
    s_t, r_t = chain_dp(*_planes(grid), ChainConfig(chain_band=25))
    assert s_t.dtype == torch.float32 and r_t.dtype == torch.int32
    assert s_t.shape == ok.shape
    _assert_same(s_t, r_t, s_scan, r_scan)
    _assert_same(s_t, r_t, np.asarray(s_pal).T, np.asarray(r_pal).T)
    if kind == "ties":
        # the fixture really exercises the tie-break: some anchor has two
        # predecessors with the best candidate
        assert (s_t.numpy() > 50).any()


@pytest.mark.parametrize("case", list(EDGES))
def test_plain_dp_edges_match_scan(case):
    grid, rcid, rev, ok = _edge_grid(case)
    band = EDGES[case][2]
    s_scan, r_scan = _scan(grid, rcid, rev, ok, band)
    s_t, r_t = chain_dp(*_planes(grid), ChainConfig(chain_band=band))
    _assert_same(s_t, r_t, s_scan, r_scan)
    assert (s_t.numpy() > 50).any()      # some anchor extends a chain
    if case == "cross_chunk_tie":
        assert r_t[0, 33] == 32 and s_t[0, 33] == s_t[0, 30] + 49.5
    if case == "resume":
        assert not ok[:, 39:41].any() and ok[:, 79:].all()


def test_plain_dp_band_zero_never_extends():
    grid, *_ = _edge_grid("band25")
    s_t, r_t = chain_dp(*_planes(grid), ChainConfig(chain_band=0))
    assert (s_t == 50).all()
    assert torch.equal(r_t, torch.arange(96, dtype=torch.int32).expand(
        r_t.shape[0], 96))


def test_wrapper_rejects_non_cpu_non_cuda():
    grid = [torch.zeros((4, 8), dtype=torch.int32, device="meta")] * 3
    with pytest.raises(ValueError, match="CUDA device"):
        chain_dp(*grid, ChainConfig())


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    cases = [(_grid(kind, NF=300, PF=128)[0], 25)
             for kind in ("random", "ties")]
    cases += [(_edge_grid(c, NF=300)[0], EDGES[c][2]) for c in EDGES]
    cases.append((_edge_grid("band25", NF=300)[0], 0))
    for grid, band in cases:
        cfg = ChainConfig(chain_band=band)
        planes = _planes(grid, "cuda")
        before = chain_dp.launches
        s_k, r_k = chain_dp(*planes, cfg)
        assert chain_dp.launches == before + 1
        s_p, r_p = chain_dp_plain(*planes, cfg)
        torch.cuda.synchronize()
        assert torch.equal(s_k.view(torch.int32), s_p.view(torch.int32))
        assert torch.equal(r_k, r_p)
