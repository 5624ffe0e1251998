"""ctypes binding of the port's native FASTA reader (``csrc/fasta_reader.cpp``).

Port of the JAX package's ``io/native.py``.  The reader is host code: it
is compiled with ``g++ -O3 -fPIC -shared -std=c++17 ... -lz`` at first
use into the port's build directory (``ops/_build.py::build_dir``) as
``fasta_reader-<hash>.so``, keyed by a hash of the source and the flags,
so a changed source rebuilds.  Where no C++ compiler or zlib exists, or
the build fails, :func:`read_genome_native` returns None and
:func:`read_contigs` falls back to the Python parser (``io/fasta.py``);
both give the same contigs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import List, Optional, Tuple

from ..ops._build import build_dir
from .fasta import read_genome

_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "fasta_reader.cpp")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
LIBS = ("-lz",)

# the loaded library; False once a build or load has failed
_lib = None
build_log = ""


def _target() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS + LIBS)
                                .encode()).hexdigest()[:16]
    return os.path.join(build_dir(), f"fasta_reader-{digest}.so")


def _build(out: str) -> bool:
    global build_log
    cxx = shutil.which("g++")
    if cxx is None:
        build_log = "no C++ compiler found"
        return False
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, _SRC, *LIBS],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as err:
        build_log = str(err)
        return False
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        return False
    os.replace(tmp, out)     # atomic: a concurrent build never sees half
    return True


def _load():
    global _lib, build_log
    if _lib is not None:
        return _lib or None
    out = _target()
    try:
        if not os.path.exists(out) and not _build(out):
            _lib = False
            return None
        lib = ctypes.CDLL(out)
    except OSError as err:
        build_log += str(err)
        _lib = False
        return None
    lib.fasta_read.restype = ctypes.c_void_p
    lib.fasta_read.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.fasta_total_len.restype = ctypes.c_int64
    lib.fasta_total_len.argtypes = [ctypes.c_void_p]
    lib.fasta_num_contigs.restype = ctypes.c_int64
    lib.fasta_num_contigs.argtypes = [ctypes.c_void_p]
    lib.fasta_copy_seq.restype = ctypes.c_int64
    lib.fasta_copy_seq.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int64]
    lib.fasta_copy_starts.restype = ctypes.c_int64
    lib.fasta_copy_starts.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int64]
    lib.fasta_contig_name.restype = ctypes.c_char_p
    lib.fasta_contig_name.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.fasta_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the native reader is built (building it if needed)."""
    return _load() is not None


def read_genome_native(path, min_contig_len: int = 0
                       ) -> Optional[Tuple["np.ndarray", "np.ndarray",
                                           List[str]]]:
    """Read a FASTA (or gzipped FASTA) file natively.

    Returns (concatenated sequence uint8 array, contig starts int64 array
    ending with the total, contig names), or None when the reader is not
    available or the file could not be read or parsed."""
    import numpy as np

    lib = _load()
    if lib is None:
        return None
    h = lib.fasta_read(os.fsencode(os.fspath(path)), min_contig_len)
    if not h:
        return None
    try:
        total = lib.fasta_total_len(h)
        nc = lib.fasta_num_contigs(h)
        seq = np.empty(total, dtype=np.uint8)
        if total:
            lib.fasta_copy_seq(h, seq.ctypes.data_as(ctypes.c_void_p), total)
        starts = np.empty(nc + 1, dtype=np.int64)
        if nc:
            lib.fasta_copy_starts(h, starts.ctypes.data_as(ctypes.c_void_p),
                                  nc)
        starts[nc] = total
        names = [lib.fasta_contig_name(h, i).decode() for i in range(nc)]
        return seq, starts, names
    finally:
        lib.fasta_free(h)


def read_contigs(path) -> List[bytes]:
    """Every contig of a FASTA file as bytes: through the native reader
    where it is available, else the Python parser (as the JAX package's
    CLI reads)."""
    native = read_genome_native(path)
    if native is None:
        return read_genome(path)
    seq, starts, _ = native
    return [seq[starts[i]:starts[i + 1]].tobytes()
            for i in range(len(starts) - 1)]
