"""Banded chain DP: the CUDA kernel's wrapper, its plain version and its
launch count.

The kernel (``csrc/chain_dp.cu``) replaces the JAX package's Pallas
kernel ``ops/chain_dp_pallas.py::_dp_kernel``; :func:`chain_dp_plain` is
the JAX ``ops/chain.py::_dp_scan`` written in PyTorch.  Both take
row-major [R, PF] grids, one row per independent recurrence, the layout
of ``_dp_scan`` and of the grids ``chain_block`` builds.
:func:`chain_dp` takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING

import torch

from . import _build

if TYPE_CHECKING:
    from .chain import ChainConfig


def chain_dp_plain(qpos: torch.Tensor, rpos: torch.Tensor,
                   meta: torch.Tensor, cfg: ChainConfig):
    """(score f32, root int32) [R, PF] of the DP over row-major grids.

    A Python loop over the PF anchor columns with vector ops over the
    rows; the window holds the last ``chain_band`` anchors of every row,
    slot 0 the most recent.  Ties go to the smallest slot (most recent)."""
    R, PF = qpos.shape
    band = cfg.chain_band
    dev = qpos.device
    i32, f32, f64 = torch.int32, torch.float32, torch.float64
    nb = max(band, 1)                    # band 0: one slot, never in band
    wq = torch.zeros((R, nb), dtype=i32, device=dev)
    wr = torch.zeros_like(wq)
    wm = torch.zeros_like(wq)            # valid bit 0 = empty slot
    wt = torch.zeros_like(wq)
    ws = torch.full((R, nb), float("-inf"), dtype=f32, device=dev)
    score = torch.empty((R, PF), dtype=f32, device=dev)
    root = torch.empty((R, PF), dtype=i32, device=dev)
    anchor = torch.tensor(cfg.anchor_score, dtype=f32, device=dev)
    gap_scale = torch.tensor(cfg.gap_cost_scale, dtype=f32,
                             device=dev).to(f64)
    neg_inf = torch.tensor(float("-inf"), dtype=f32, device=dev)
    slots = torch.arange(nb, dtype=i32, device=dev)[None, :]
    for j in range(PF):
        cq, cr, cm = qpos[:, j:j + 1], rpos[:, j:j + 1], meta[:, j:j + 1]
        cvalid = (cm & 1) == 1
        dr = cr - wr
        dq_f = cq - wq
        dq = torch.where((cm & 2) == 2, -dq_f, dq_f)
        same = ((wm >> 1) == (cm >> 1)) & ((wm & 1) == 1) & cvalid
        gap = (dr - dq).abs()
        ok = same & (dr > 0) & (dq > 0) & (gap < cfg.max_gap_length) & \
            (slots < band)
        # (score + anchor) - gap * scale with the product fused into the
        # subtraction (one rounding), as XLA and the kernel compute it:
        # the f32 product is exact in f64, and for scores >= anchor_score
        # below 2^24 the f64 difference is exact, so one rounding to f32
        # gives the fused result
        x = (ws + anchor).to(f64)
        cand = torch.where(ok, (x - gap.to(f32).to(f64) * gap_scale).to(f32),
                           neg_inf)
        best = cand.max(1, keepdim=True).values
        extend = best > anchor
        best_slot = torch.where(cand == best, slots, nb).min(
            1, keepdim=True).values
        root_best = wt.gather(1, best_slot.clamp(max=nb - 1).long())
        s = torch.where(extend, best, anchor)
        rt = torch.where(extend & cvalid, root_best,
                         torch.full_like(root_best, j))
        score[:, j:j + 1] = s
        root[:, j:j + 1] = rt
        wq = torch.cat([cq, wq[:, :-1]], 1)
        wr = torch.cat([cr, wr[:, :-1]], 1)
        wm = torch.cat([cm, wm[:, :-1]], 1)
        wt = torch.cat([rt, wt[:, :-1]], 1)
        ws = torch.cat([s, ws[:, :-1]], 1)
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


def chain_dp(qpos: torch.Tensor, rpos: torch.Tensor, meta: torch.Tensor,
             cfg: ChainConfig):
    """Run the DP over row-major grids [R, PF] -> (score, root) [R, PF].

    ``meta`` packs qcid[30:17] rcid[16:3] rev[1] valid[0].  CPU tensors
    take :func:`chain_dp_plain`; CUDA tensors launch the kernel on their
    device's current stream (``chain_dp.launches`` counts the launches)."""
    grids = (qpos, rpos, meta)
    if all(t.device.type == "cpu" for t in grids):
        return chain_dp_plain(qpos, rpos, meta, cfg)
    dev = qpos.device
    if dev.type != "cuda" or any(t.device != dev for t in grids):
        raise ValueError(f"chain_dp: grids must share one CUDA device or "
                         f"all lie on the CPU, got "
                         f"{[str(t.device) for t in grids]}")
    for t in grids:
        if t.dtype != torch.int32 or t.dim() != 2 or \
                t.shape != qpos.shape or not t.is_contiguous():
            raise ValueError("chain_dp: grids must be contiguous int32 "
                             "[R, PF] tensors of one shape")
    R, PF = qpos.shape
    if R >= 2**30 or PF >= 2**30:
        raise ValueError(f"chain_dp: grid {R}x{PF} too large")
    lib = _lib()
    max_band = lib.chain_dp_max_band()
    if not 0 <= cfg.chain_band <= max_band:
        raise ValueError(f"chain_dp: chain_band={cfg.chain_band} outside "
                         f"the kernel's [0, {max_band}]")
    if not cfg.anchor_score >= 0:
        raise ValueError(f"chain_dp: the kernel needs anchor_score >= 0, "
                         f"got {cfg.anchor_score}")
    score = torch.empty((R, PF), dtype=torch.float32, device=dev)
    root = torch.empty((R, PF), dtype=torch.int32, device=dev)
    if R == 0 or PF == 0:
        return score, root
    # the CUDA runtime launches on the thread's current device: make it
    # the grids' device, whatever device the caller has current
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.chain_dp_launch(
            qpos.data_ptr(), rpos.data_ptr(), meta.data_ptr(),
            score.data_ptr(), root.data_ptr(), R, PF, cfg.chain_band,
            float(cfg.anchor_score), float(cfg.gap_cost_scale),
            int(cfg.max_gap_length), stream)
    if err != 0:
        raise RuntimeError(f"chain_dp kernel launch failed: CUDA error {err}")
    chain_dp.launches += 1
    return score, root


chain_dp.launches = 0
