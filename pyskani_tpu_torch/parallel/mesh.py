"""The engine's 2-D ("db", "batch") mesh over a ``torch.distributed`` world.

Port of the JAX package's ``parallel/mesh.py``.  JAX runs one controller
over every device; here each rank is one process on one device (SPMD),
and the mesh is the world's ranks laid out row-major as [db, batch]: rank
``r`` sits at ``(r // batch, r % batch)``, as device ``r`` does in the JAX
package's reshaped device array.  Every collective of ``parallel/dist.py``
gathers its result onto every rank, so the mesh needs no row or column
process group, only the layout.  Without an initialised process group the
world is this one process (a 1 x 1 mesh needs no rendezvous).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist

class Mesh:
    """A [db, batch] layout of the world's ranks, seen from one rank.

    ``device`` is where this rank computes.  ``transport`` is where its
    collectives run: the device under NCCL, host memory under gloo (a CUDA
    rank's tensors then stage through the host)."""

    def __init__(self, db: int, batch: int, device: torch.device):
        self.shape: Dict[str, int] = {"db": db, "batch": batch}
        self.size = db * batch
        self.distributed = dist.is_available() and dist.is_initialized()
        self.rank = dist.get_rank() if self.distributed else 0
        self.device = device
        gloo = self.distributed and dist.get_backend() == "gloo"
        self.transport = torch.device("cpu") if gloo else device

    @property
    def coords(self) -> Dict[str, int]:
        b = self.shape["batch"]
        return {"db": self.rank // b, "batch": self.rank % b}

    def axis_coord(self, axis: Union[str, Tuple[str, ...]]) -> Tuple[int, int]:
        """(this rank's index, number of blocks) along ``axis``: one axis
        name, or a tuple of names flattened row-major (``("db", "batch")``
        is the rank itself)."""
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        idx, n = 0, 1
        for name in names:
            idx = idx * self.shape[name] + self.coords[name]
            n *= self.shape[name]
        return idx, n

    def __repr__(self) -> str:
        return (f"Mesh(db={self.shape['db']}, batch={self.shape['batch']}, "
                f"rank={self.rank}, device={self.device})")


def rank_device(device=None) -> torch.device:
    """The device this rank computes on: ``cuda`` (the default) is the
    current CUDA device, which ``initialize_multihost`` and
    ``dist.launch`` set to the rank's own card before anything is built."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the mesh runs on the GPU by default and CUDA "
                               "is not available; pass device='cpu'")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(db: Optional[int] = None, batch: Optional[int] = None, *,
              device=None) -> Mesh:
    """Build the engine's 2-D ("db", "batch") mesh over the world.

    Defaults as in the JAX package: "db" as large as the world (the
    database shard axis dominates memory) and "batch" 1.  Raises
    ``ValueError`` when ``db * batch`` is not the world size."""
    n = dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1
    if db is None and batch is None:
        db, batch = n, 1
    elif db is None:
        db = n // batch
    elif batch is None:
        batch = n // db
    if db * batch != n:
        raise ValueError(f"mesh {db}x{batch} != {n} devices")
    return Mesh(db, batch, rank_device(device))
