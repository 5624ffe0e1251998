"""In-memory sketch storage (port of the memory backend of the JAX
package's ``db/storage.py``).  The on-disk formats are still to port."""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from ..params import SketchParams


@dataclasses.dataclass
class MarkerSketch:
    """RAM-resident marker sketch of one genome (screening input)."""

    name: str
    total_len: int
    contig_names: List[str]
    contig_lengths: List[int]
    hi: np.ndarray  # uint32 sorted unique (paired with lo)
    lo: np.ndarray


class MemoryStorage:
    """Sketches by name, in memory."""

    def __init__(self):
        self._sketches: Dict[str, object] = {}

    def store(self, host_sketch, params: SketchParams) -> None:
        self._sketches[host_sketch.name] = host_sketch

    def load(self, name: str):
        try:
            return self._sketches[name]
        except KeyError:
            raise KeyError(name) from None
