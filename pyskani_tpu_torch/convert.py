"""Carry sketches between the JAX package and the port, as numpy arrays.

``sketch_from_numpy`` takes the ``DeviceSketch`` fields as the JAX
package holds them on the host (what ``jax.device_get(host.device)``
gives: uint32 k-mers and markers, int32 tables, bool strands) and returns
the port's ``HostSketch`` on ``device``; ``sketch_to_numpy`` gives the
fields back with the JAX package's dtypes.  Neither imports JAX.
"""

from __future__ import annotations

from typing import List, Mapping

import numpy as np
import torch

from .ops.sketch import FIELDS, U32_MAX, DeviceSketch, HostSketch

# the JAX package's host dtype of every DeviceSketch field
NUMPY_DTYPES = dict(
    kmers=np.uint32, positions=np.int32, contig_ids=np.int32,
    strands=np.bool_, own_mult=np.int32, p_positions=np.int32,
    p_contig_ids=np.int32, p_own_mult=np.int32, markers_hi=np.uint32,
    markers_lo=np.uint32, n_seeds=np.int32, n_markers=np.int32,
    contig_lengths=np.int32, n_contigs=np.int32, total_len=np.uint32)

_TORCH_DTYPES = {np.uint32: torch.int64, np.int32: torch.int32,
                 np.bool_: torch.bool}


def _field(fields, name):
    if isinstance(fields, Mapping):
        return fields[name]
    return getattr(fields, name)


def sketch_from_numpy(fields, name: str, contig_names: List[str],
                      lengths: List[int], device="cuda") -> HostSketch:
    """The port's ``HostSketch`` from numpy ``DeviceSketch`` fields
    (a mapping or an object with the fields as attributes)."""
    tensors = {}
    for f in FIELDS:
        np_dtype = NUMPY_DTYPES[f]
        arr = np.asarray(_field(fields, f)).astype(np_dtype)
        tensors[f] = torch.from_numpy(
            arr.astype(np.int64) if np_dtype is np.uint32 else arr).to(
            device=device, dtype=_TORCH_DTYPES[np_dtype])
    return HostSketch(name=name, contig_names=list(contig_names),
                      device=DeviceSketch(**tensors),
                      lengths=[int(x) for x in lengths])


def sketch_to_numpy(host: HostSketch) -> dict:
    """The ``DeviceSketch`` fields of a port sketch as numpy arrays with
    the JAX package's dtypes.  ``total_len`` saturates at 2^32-1, as the
    JAX package stores it, instead of wrapping."""
    out = {}
    for f in FIELDS:
        t = getattr(host.device, f).cpu()
        if f == "total_len":
            t = t.clamp(max=U32_MAX)
        out[f] = t.numpy().astype(NUMPY_DTYPES[f])
    return out
