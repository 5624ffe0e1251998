"""Banded chain DP: the CUDA kernel's wrapper, its plain version and its
launch count.

The kernel (``csrc/chain_dp.cu``) replaces the JAX package's Pallas
kernel ``ops/chain_dp_pallas.py::_dp_kernel``; :func:`chain_dp_plain` is
the JAX ``ops/chain.py::_dp_scan`` written in PyTorch over the kernel's
[PF, NL] interface.  :func:`chain_dp` takes the plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING

import torch

from . import _build

if TYPE_CHECKING:
    from .chain import ChainConfig


def chain_dp_plain(qpos_t: torch.Tensor, rpos_t: torch.Tensor,
                   meta_t: torch.Tensor, cfg: ChainConfig):
    """(score f32, root int32) [PF, NL] of the DP over transposed grids.

    A Python loop over the PF anchor rows with vector ops over the lanes;
    the window holds the last ``chain_band`` anchors of every lane, slot 0
    the most recent.  Ties go to the smallest slot (most recent)."""
    PF, NL = qpos_t.shape
    band = cfg.chain_band
    dev = qpos_t.device
    i32, f32, f64 = torch.int32, torch.float32, torch.float64
    wq = torch.zeros((band, NL), dtype=i32, device=dev)
    wr = torch.zeros_like(wq)
    wm = torch.zeros_like(wq)            # valid bit 0 = empty slot
    wt = torch.zeros_like(wq)
    ws = torch.full((band, NL), float("-inf"), dtype=f32, device=dev)
    score = torch.empty((PF, NL), dtype=f32, device=dev)
    root = torch.empty((PF, NL), dtype=i32, device=dev)
    anchor = torch.tensor(cfg.anchor_score, dtype=f32, device=dev)
    gap_scale = torch.tensor(cfg.gap_cost_scale, dtype=f32,
                             device=dev).to(f64)
    neg_inf = torch.tensor(float("-inf"), dtype=f32, device=dev)
    slots = torch.arange(band, dtype=i32, device=dev)[:, None]
    for j in range(PF):
        cq, cr, cm = qpos_t[j], rpos_t[j], meta_t[j]
        cvalid = (cm & 1) == 1
        crev = (cm & 2) == 2
        dr = cr[None] - wr
        dq_f = cq[None] - wq
        dq = torch.where(crev[None], -dq_f, dq_f)
        same = ((wm >> 1) == (cm >> 1)[None]) & ((wm & 1) == 1) & \
            cvalid[None]
        gap = (dr - dq).abs()
        ok = same & (dr > 0) & (dq > 0) & (gap < cfg.max_gap_length)
        # (score + anchor) - gap * scale with the product fused into the
        # subtraction (one rounding), as XLA and the kernel compute it:
        # the f32 product is exact in f64, and for scores >= anchor_score
        # below 2^24 the f64 difference is exact, so one rounding to f32
        # gives the fused result
        x = (ws + anchor).to(f64)
        cand = torch.where(ok, (x - gap.to(f32).to(f64) * gap_scale).to(f32),
                           neg_inf)
        best = cand.max(0).values
        extend = best > anchor
        best_slot = torch.where(cand == best[None], slots, band).min(0).values
        root_best = wt.gather(0, best_slot.clamp(max=band - 1)[None].long())[0]
        s = torch.where(extend, best, anchor)
        rt = torch.where(extend & cvalid, root_best,
                         torch.full_like(root_best, j))
        score[j] = s
        root[j] = rt
        wq = torch.cat([cq[None], wq[:-1]])
        wr = torch.cat([cr[None], wr[:-1]])
        wm = torch.cat([cm[None], wm[:-1]])
        wt = torch.cat([rt[None], wt[:-1]])
        ws = torch.cat([s[None], ws[:-1]])
    return score, root


def _lib() -> ctypes.CDLL:
    lib = _build.load("chain_dp")
    if not getattr(lib, "_argtypes_set", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.chain_dp_launch.argtypes = [p, p, p, p, p, i, i, i, f, f, i, p]
        lib.chain_dp_launch.restype = ctypes.c_int
        lib.chain_dp_max_band.argtypes = []
        lib.chain_dp_max_band.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def chain_dp(qpos_t: torch.Tensor, rpos_t: torch.Tensor,
             meta_t: torch.Tensor, cfg: ChainConfig):
    """Run the DP over transposed grids [PF, NL] -> (score, root) [PF, NL].

    ``meta`` packs qcid[30:17] rcid[16:3] rev[1] valid[0].  CPU tensors
    take :func:`chain_dp_plain`; CUDA tensors launch the kernel on the
    current stream (``chain_dp.launches`` counts the launches)."""
    grids = (qpos_t, rpos_t, meta_t)
    if all(t.device.type == "cpu" for t in grids):
        return chain_dp_plain(qpos_t, rpos_t, meta_t, cfg)
    dev = qpos_t.device
    if dev.type != "cuda" or any(t.device != dev for t in grids):
        raise ValueError(f"chain_dp: grids must share one CUDA device or "
                         f"all lie on the CPU, got "
                         f"{[str(t.device) for t in grids]}")
    for t in grids:
        if t.dtype != torch.int32 or t.dim() != 2 or \
                t.shape != qpos_t.shape or not t.is_contiguous():
            raise ValueError("chain_dp: grids must be contiguous int32 "
                             "[PF, NL] tensors of one shape")
    PF, NL = qpos_t.shape
    if PF >= 2**31 or NL >= 2**31:
        raise ValueError(f"chain_dp: grid {PF}x{NL} too large")
    lib = _lib()
    max_band = lib.chain_dp_max_band()
    if not 0 <= cfg.chain_band <= max_band:
        raise ValueError(f"chain_dp: chain_band={cfg.chain_band} outside "
                         f"the kernel's [0, {max_band}]")
    score = torch.empty((PF, NL), dtype=torch.float32, device=dev)
    root = torch.empty((PF, NL), dtype=torch.int32, device=dev)
    if PF == 0 or NL == 0:
        return score, root
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.chain_dp_launch(
        qpos_t.data_ptr(), rpos_t.data_ptr(), meta_t.data_ptr(),
        score.data_ptr(), root.data_ptr(), PF, NL, cfg.chain_band,
        float(cfg.anchor_score), float(cfg.gap_cost_scale),
        int(cfg.max_gap_length), stream)
    if err != 0:
        raise RuntimeError(f"chain_dp kernel launch failed: CUDA error {err}")
    chain_dp.launches += 1
    return score, root


chain_dp.launches = 0
