"""Dependency-free FASTA ingestion (host layer).

Copy of the JAX package's ``io/fasta.py``.  Functional replacement for
pyskani's vendored test parser (``tests/fasta.py``) and for the needletail-based
ingestion skani performs internally; pyskani itself is "sans I/O" and takes
in-memory contigs, which this framework also supports.  Handles plain and
gzip-compressed files.
"""

from __future__ import annotations

import gzip
import io
import os
from typing import Iterator, NamedTuple, Union


class Record(NamedTuple):
    id: str
    seq: bytes
    description: str


def _open(path: Union[str, os.PathLike]) -> io.BufferedReader:
    path = os.fsdecode(path)
    f = open(path, "rb")
    magic = f.peek(2)[:2]
    if magic == b"\x1f\x8b":
        return gzip.open(f, "rb")  # type: ignore[return-value]
    return f


def parse(source) -> Iterator[Record]:
    """Yield ``Record(id, seq, description)`` from a FASTA file or handle."""
    if isinstance(source, (str, os.PathLike)):
        handle = _open(source)
        own = True
    else:
        handle = source
        own = False
    try:
        header = None
        desc = ""
        chunks: list[bytes] = []
        for raw in handle:
            line = raw if isinstance(raw, bytes) else raw.encode()
            line = line.strip()
            if line.startswith(b">"):
                if header is not None:
                    yield Record(header, b"".join(chunks), desc)
                text = line[1:].decode()
                header = text.split()[0] if text.split() else ""
                desc = text
                chunks = []
            elif line:
                chunks.append(line)
        if header is not None:
            yield Record(header, b"".join(chunks), desc)
        elif chunks:
            raise ValueError("not in FASTA format")
    finally:
        if own:
            handle.close()


def read_genome(path: Union[str, os.PathLike]) -> list[bytes]:
    """All contig sequences of a FASTA file as a list of byte strings."""
    return [rec.seq for rec in parse(path)]
