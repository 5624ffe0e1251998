"""Build the port's CUDA sources with ``nvcc`` at first use, load with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own into ``<build dir>/<name>-<hash>.so`` (hash of source and flags, so a
changed source rebuilds), for ``sm_90a``.  The build directory defaults to
``_build/`` inside the package (listed in ``.gitignore``) and can be moved
with ``PYSKANI_TORCH_BUILD_DIR``.  Nothing is built when a module is
imported: :func:`load` builds on the first call that needs a kernel, and
:func:`build` starts one ``nvcc`` per missing source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Sequence

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}


def build_dir() -> str:
    d = os.environ.get("PYSKANI_TORCH_BUILD_DIR") or os.path.join(
        os.path.dirname(_CSRC), "_build")
    os.makedirs(d, exist_ok=True)
    return d


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc") or "")
    for path in cand:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "at first use and need the CUDA toolkit")


def _target(name: str) -> tuple:
    src = os.path.join(_CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    out = os.path.join(build_dir(), f"{name}-{digest.hexdigest()[:16]}.so")
    return src, out


def build(names: Sequence[str]) -> Dict[str, float]:
    """Compile every missing ``csrc/<name>.cu``, one ``nvcc`` each, all
    started together.  Returns the wall seconds each build took (0.0 when
    the library was already built).  Raises if any build fails."""
    nvcc = None
    procs = {}
    secs = {}
    for name in names:
        src, out = _target(name)
        if os.path.exists(out):
            secs[name] = 0.0
            continue
        nvcc = nvcc or _nvcc()
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        build_logs[name] = log.decode(errors="replace")
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n"
                          f"{build_logs[name]}")
            continue
        os.replace(tmp, out)   # atomic: a concurrent build never sees half
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(_target(name)[1])
        _loaded[name] = lib
    return lib
