"""Sketch storage: in memory, or on disk in the JAX package's formats.

Port of the JAX package's ``db/storage.py``, byte for byte on disk, so a
store written by either package opens in the other:

* **memory**: a dict of sketches on the database's device;
* **separated**: one ``<name>.sketch`` file per genome, written at
  ``store()`` time; ``markers.bin`` written on ``flush()``;
* **consolidated**: one append-only ``sketches.db``, written at
  ``store()`` time; ``index.db`` (JSON offset/length index, sorted by
  offset) and ``markers.bin`` written on ``flush()``.

A sketch is an npz archive of its trimmed tables (uint32 k-mers and
markers, int32 positions, contig ids and lengths, bool strands) beside a
JSON manifest; ``markers.bin`` is an npz of every genome's markers beside
a JSON manifest of the sketch parameters and genome metadata.  The port's
int64 carriers of u32 values are cast back to uint32 before writing.
With profiling on, a sketch's encoding is the span ``storage/encode`` and
its decoding ``storage/decode``.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..convert import NUMPY_DTYPES, sketch_from_numpy
from ..ops.sketch import (I32_SENTINEL, U32_MAX, U32_SENTINEL,
                          contig_budget_for, marker_budget_for,
                          seed_budget_for)
from ..params import SketchParams
from ..utils import profiling

FORMAT_VERSION = 1
_SEED_KEYS = ("kmers", "positions", "contig_ids", "strands")
_MARKER_KEYS = ("markers_hi", "markers_lo")


def _params_dict(params: SketchParams) -> dict:
    return dict(c=params.c, marker_c=params.marker_c, k=params.k,
                marker_k=params.marker_k, use_aa=params.use_aa)


def _params_from(p: dict) -> SketchParams:
    return SketchParams(c=p["c"], marker_c=p["marker_c"], k=p["k"],
                        marker_k=p["marker_k"], use_aa=p["use_aa"])


def sketch_to_bytes(host_sketch, params: SketchParams) -> bytes:
    """Serialize a sketch (trimmed to its true counts) with its params."""
    with profiling.scope("storage/encode"):
        dev = host_sketch.device
        n, m, nc = int(dev.n_seeds), int(dev.n_markers), int(dev.n_contigs)

        def host(field, rows):
            return getattr(dev, field)[:rows].cpu().numpy().astype(
                NUMPY_DTYPES[field])

        meta = dict(
            version=FORMAT_VERSION,
            name=host_sketch.name,
            contig_names=host_sketch.contig_names,
            total_len=min(int(dev.total_len), U32_MAX),
            params=_params_dict(params),
        )
        buf = io.BytesIO()
        np.savez(
            buf,
            meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
            **{f: host(f, n) for f in _SEED_KEYS},
            **{f: host(f, m) for f in _MARKER_KEYS},
            contig_lengths=host("contig_lengths", nc),
        )
        return buf.getvalue()


def sketch_from_bytes(data: bytes, device="cpu"):
    """Deserialize into (HostSketch on ``device``, SketchParams), padded
    to the default budgets of its length, with the own multiplicities and
    the position-sorted view recomputed as the JAX package does."""
    with profiling.scope("storage/decode"):
        with np.load(io.BytesIO(data)) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            kmers, positions = z["kmers"], z["positions"]
            contig_ids, strands = z["contig_ids"], z["strands"]
            markers_hi, markers_lo = z["markers_hi"], z["markers_lo"]
            contig_lengths = z["contig_lengths"]

        params = _params_from(meta["params"])
        total = meta["total_len"]
        n, m = len(kmers), len(markers_hi)
        sb = max(seed_budget_for(total, params.c),
                 ((n + 1023) // 1024) * 1024)
        mb = max(marker_budget_for(total, params.marker_c),
                 ((m + 511) // 512) * 512)

        def pad(arr, size, fill):
            out = np.full(size, fill, dtype=arr.dtype)
            out[:len(arr)] = arr
            return out

        # own multiplicity: run lengths over the kmer-sorted table
        own_mult = (np.searchsorted(kmers, kmers, side="right") -
                    np.searchsorted(kmers, kmers, side="left")
                    ).astype(np.int32)
        order = np.lexsort((positions, contig_ids))
        fields = dict(
            kmers=pad(kmers, sb, U32_SENTINEL),
            positions=pad(positions, sb, np.int32(I32_SENTINEL)),
            contig_ids=pad(contig_ids, sb, np.int32(I32_SENTINEL)),
            strands=pad(strands, sb, False),
            own_mult=pad(own_mult, sb, np.int32(0)),
            p_positions=pad(positions[order], sb, np.int32(I32_SENTINEL)),
            p_contig_ids=pad(contig_ids[order], sb, np.int32(I32_SENTINEL)),
            p_own_mult=pad(own_mult[order], sb, np.int32(0)),
            markers_hi=pad(markers_hi, mb, U32_SENTINEL),
            markers_lo=pad(markers_lo, mb, U32_SENTINEL),
            n_seeds=n, n_markers=m,
            contig_lengths=pad(contig_lengths.astype(np.int32),
                               contig_budget_for(len(contig_lengths)), 0),
            n_contigs=len(contig_lengths),
            total_len=total,
        )
        host = sketch_from_numpy(fields, meta["name"], meta["contig_names"],
                                 [int(x) for x in contig_lengths],
                                 device=device)
        return host, params


# --------------------------------------------------------------------------
# markers.bin


@dataclasses.dataclass
class MarkerSketch:
    """RAM-resident marker sketch of one genome (screening input)."""

    name: str
    total_len: int
    contig_names: List[str]
    contig_lengths: List[int]
    hi: np.ndarray  # uint32 sorted unique (paired with lo)
    lo: np.ndarray


def save_markers(path: Path, params: SketchParams, markers: List) -> None:
    """markers.bin: the params and every genome's marker sketch, written
    to a temporary file and moved into place."""
    manifest = dict(
        version=FORMAT_VERSION,
        params=_params_dict(params),
        genomes=[dict(name=m.name, total_len=m.total_len,
                      n_markers=len(m.hi), contig_names=m.contig_names,
                      contig_lengths=[int(x) for x in m.contig_lengths])
                 for m in markers],
    )
    arrays = {"manifest": np.frombuffer(json.dumps(manifest).encode(),
                                        dtype=np.uint8)}
    for i, m in enumerate(markers):
        arrays[f"hi{i}"] = m.hi
        arrays[f"lo{i}"] = m.lo
    tmp = path.with_suffix(".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_markers(path: Path):
    """(SketchParams, [MarkerSketch]) from a markers.bin."""
    with np.load(path) as z:
        manifest = json.loads(bytes(z["manifest"]).decode())
        params = _params_from(manifest["params"])
        markers = [MarkerSketch(
            name=g["name"], total_len=g["total_len"],
            contig_names=g["contig_names"],
            contig_lengths=g["contig_lengths"],
            hi=z[f"hi{i}"], lo=z[f"lo{i}"])
            for i, g in enumerate(manifest["genomes"])]
    return params, markers


# --------------------------------------------------------------------------
# storage backends: ``store`` a sketch, ``load`` it by name onto a device
# (the storage's own by default), ``flush`` the buffers


class MemoryStorage:
    """Sketches by name, in memory."""

    path: Optional[Path] = None

    def __init__(self):
        self._sketches: Dict[str, object] = {}

    def store(self, host_sketch, params: SketchParams) -> None:
        self._sketches[host_sketch.name] = host_sketch

    def load(self, name: str):
        try:
            return self._sketches[name]
        except KeyError:
            raise KeyError(name) from None

    def flush(self, params, markers) -> None:
        pass


class FolderStorage:
    """One ``<name>.sketch`` per genome (separated)."""

    def __init__(self, path: Path, device="cpu"):
        self.path = Path(path)
        self.device = device

    def store(self, host_sketch, params: SketchParams) -> None:
        data = sketch_to_bytes(host_sketch, params)
        with open(self.path / f"{host_sketch.name}.sketch", "wb") as f:
            f.write(data)

    def load(self, name: str, device=None):
        p = self.path / f"{name}.sketch"
        try:
            with open(p, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            raise OSError(2, f"Failed to open {p}") from None
        return sketch_from_bytes(data, device or self.device)[0]

    def flush(self, params, markers) -> None:
        save_markers(self.path / "markers.bin", params, markers)


class ConsolidatedStorage:
    """One append-only ``sketches.db`` plus an offset index."""

    def __init__(self, path: Path, index: Optional[Dict[str, dict]] = None,
                 device="cpu"):
        self.path = Path(path)
        self.index: Dict[str, dict] = index or {}
        self.device = device

    def store(self, host_sketch, params: SketchParams) -> None:
        name = host_sketch.name
        if name in self.index:
            raise ValueError(f"duplicate name in sketches: {name!r}")
        data = sketch_to_bytes(host_sketch, params)
        with open(self.path / "sketches.db", "ab") as f:
            offset = f.tell()
            f.write(data)
        self.index[name] = dict(file_name=name, offset=offset,
                                length=len(data))

    def load(self, name: str, device=None):
        try:
            entry = self.index[name]
        except KeyError:
            raise KeyError(name) from None
        with open(self.path / "sketches.db", "rb") as f:
            f.seek(entry["offset"])
            data = f.read(entry["length"])
        return sketch_from_bytes(data, device or self.device)[0]

    def flush(self, params, markers) -> None:
        save_markers(self.path / "markers.bin", params, markers)
        entries = sorted(self.index.values(), key=lambda e: e["offset"])
        tmp = self.path / "index.db.tmp"
        with open(tmp, "w") as f:
            json.dump(dict(version=FORMAT_VERSION, entries=entries), f)
        os.replace(tmp, self.path / "index.db")


def load_index(path: Path) -> Dict[str, dict]:
    """The consolidated store's index.db, by name."""
    with open(path / "index.db") as f:
        data = json.load(f)
    return {e["file_name"]: e for e in data["entries"]}
