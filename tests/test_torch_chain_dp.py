"""Port chain DP vs the JAX package: bit-equal scores and roots.

The plain PyTorch DP (what ``chain_dp`` runs for CPU tensors) must equal
both the JAX ``_dp_scan`` and the Pallas kernel in interpret mode, on the
fixture of ``test_device_chain.py::test_pallas_dp_matches_scan`` and on a
tie-heavy grid.  The CUDA kernel is held against the plain version where
a card is present.
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
    w1, w2 = _pack_grid_words(jnp.asarray(qpos), jnp.asarray(rpos),
                              jnp.asarray(rcid), jnp.asarray(rev),
                              jnp.asarray(ok), RBITS)
    return _dp_grid_from_words(w1, w2, RBITS), rcid, rev, ok


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_plain_dp_matches_scan_and_pallas(kind):
    grid, rcid, rev, ok = _grid(kind)
    NF, PF = ok.shape
    jcfg = JaxChainConfig(chain_band=25)
    s_scan, r_scan = _dp_scan(
        dict(qpos=grid["qpos"], rpos=grid["rpos"],
             qcid=jnp.zeros((NF, PF), jnp.int32),
             rcid=jnp.asarray(np.where(ok, rcid, 0x7FFFFFFF)),
             rev=jnp.asarray(rev), valid=jnp.asarray(ok)), jcfg,
        EngineBudgets(max_fragments=NF, max_anchors_per_fragment=PF))
    s_pal, r_pal = dp_pallas(grid["qpos"].T, grid["rpos"].T,
                             grid["meta"].T, jcfg, interpret=True)
    planes = [torch.from_numpy(np.ascontiguousarray(np.asarray(grid[k]).T))
              for k in ("qpos", "rpos", "meta")]
    s_t, r_t = chain_dp(*planes, ChainConfig(chain_band=25))
    assert s_t.dtype == torch.float32 and r_t.dtype == torch.int32
    for s_ref, r_ref in ((np.asarray(s_scan).T, np.asarray(r_scan).T),
                         (np.asarray(s_pal), np.asarray(r_pal))):
        np.testing.assert_array_equal(s_t.numpy().view(np.int32),
                                      np.ascontiguousarray(s_ref)
                                      .view(np.int32))
        np.testing.assert_array_equal(r_t.numpy(), r_ref)
    if kind == "ties":
        # the fixture really exercises the tie-break: some anchor has two
        # predecessors with the best candidate
        assert (s_t.numpy() > 50).any()


def test_wrapper_rejects_non_cpu_non_cuda():
    grid = [torch.zeros((4, 8), dtype=torch.int32, device="meta")] * 3
    with pytest.raises(ValueError, match="CUDA device"):
        chain_dp(*grid, ChainConfig())


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    cfg = ChainConfig()
    for kind in ("random", "ties"):
        grid, *_ = _grid(kind, NF=300, PF=128)
        planes = [torch.from_numpy(np.ascontiguousarray(
            np.asarray(grid[k]).T)).cuda() for k in ("qpos", "rpos", "meta")]
        before = chain_dp.launches
        s_k, r_k = chain_dp(*planes, cfg)
        assert chain_dp.launches == before + 1
        s_p, r_p = chain_dp_plain(*planes, cfg)
        torch.cuda.synchronize()
        assert torch.equal(s_k.view(torch.int32), s_p.view(torch.int32))
        assert torch.equal(r_k, r_p)
