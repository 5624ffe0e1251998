"""Batched marker screening on PyTorch tensors.

Port of the JAX package's ``ops/screen.py``: ONE query's marker set is
intersected with a whole batch of reference marker sets at once.  A
marker of up to 64 bits (marker_k <= 32) is one int64 key, its u64 bits
``hi << 32 | lo`` with the sign bit flipped so that signed order is the
unsigned (hi, lo) order of the stored sets.  Marker sets are sorted and
unique, so the shared count is a batched ``searchsorted`` of the query
keys into each reference row, where the JAX package sorted the
concatenated pair arrays.
"""

from __future__ import annotations

import torch

from ..params import MIN_MARKERS_RESCUE
from .sketch import I64_MIN

# the key of (0xFFFFFFFF, 0xFFFFFFFF), which no canonical k-mer equals
_SENT = (1 << 63) - 1


def marker_keys(hi: torch.Tensor, lo: torch.Tensor, n) -> torch.Tensor:
    """int64 keys ``(hi << 32 | lo) ^ 2^63`` of a padded marker array
    (last axis), in the unsigned (hi, lo) order, with every slot at or
    past ``n`` set to a sentinel that sorts last."""
    keys = ((hi.to(torch.int64) << 32) | lo.to(torch.int64)) ^ I64_MIN
    n = torch.as_tensor(n, device=keys.device)
    slot = torch.arange(keys.shape[-1], device=keys.device)
    valid = slot < n.unsqueeze(-1) if n.dim() else slot < n
    return torch.where(valid, keys, _SENT)


def _shared_count(q_keys: torch.Tensor, n_q, r_keys: torch.Tensor, n_r):
    """[N] count of the query's valid keys found among each reference
    row's valid keys (rows sorted ascending, sentinel-padded)."""
    N = r_keys.shape[0]
    Mr = r_keys.shape[1]
    q = q_keys.unsqueeze(0).expand(N, -1).contiguous()
    pos = torch.searchsorted(r_keys, q)
    hit = r_keys.gather(1, pos.clamp(max=Mr - 1)) == q
    ok = hit & (pos < n_r.unsqueeze(1)) & (q != _SENT)
    q_valid = torch.arange(q_keys.shape[0], device=q.device) < n_q
    return (ok & q_valid.unsqueeze(0)).sum(1, dtype=torch.int32)


def screen_pass(shared, n_q, n_r, screen_val: float, *, marker_k: int,
                rescue_small: bool):
    """Marker containment screen from shared counts (pyskani's
    ``check_markers_quickly``, lib.rs:623-628): containment^(1/marker_k)
    against ``screen_val``, the <MIN_MARKERS_RESCUE rescue clause and the
    ``screen_val <= 0`` pass-all clause.  Returns (pass bool, est f32)."""
    ratio = shared.to(torch.float32) / \
        torch.clamp(n_q.to(torch.float32), min=1.0)
    est = ratio ** (1.0 / marker_k)
    est = torch.where((n_q > 0) & (n_r > 0), est, torch.zeros_like(est))
    passes = est > screen_val
    if rescue_small:
        passes = passes | (n_r < MIN_MARKERS_RESCUE)
    if screen_val <= 0.0:
        passes = torch.ones_like(passes)
    return passes, est


def screen_batch(q_hi, q_lo, n_q, refs_hi, refs_lo, refs_n, screen_val,
                 *, marker_k: int, rescue_small: bool):
    """(pass [N] bool, est [N] f32) for one query vs N references.

    ``q_hi``/``q_lo`` are the query's sorted unique markers, padded;
    ``refs_hi``/``refs_lo`` [N, M] the references', ``refs_n`` [N] their
    counts.  All on one device.
    """
    n_q = torch.as_tensor(n_q, device=q_hi.device).to(torch.int32)
    refs_n = refs_n.to(torch.int32)
    q_keys = marker_keys(q_hi, q_lo, n_q)
    r_keys = marker_keys(refs_hi, refs_lo, refs_n)
    shared = _shared_count(q_keys, n_q, r_keys, refs_n)
    return screen_pass(shared, n_q, refs_n, float(screen_val),
                       marker_k=marker_k, rescue_small=rescue_small)
