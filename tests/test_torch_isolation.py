"""The port stands alone: it never imports JAX or the JAX package.

Importing any ``pyskani_tpu`` module runs ``pyskani_tpu/__init__.py``,
which imports JAX, so the port keeps its own copies of what it needs.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "pyskani_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "pyskani_tpu")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _modules():
    mods = []
    for path in _port_files():
        rel = os.path.relpath(path, REPO)[:-3]
        if rel == "chip_smoke":
            mods.append(rel)
            continue
        parts = rel.split(os.sep)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_imports_in_source(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names = [str(node.args[0].value)]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_port_imports_with_jax_blocked():
    """Every module of the port (and chip_smoke.py) imports in a fresh
    interpreter in which ``import jax`` and ``import pyskani_tpu`` fail."""
    code = (
        "import sys\n"
        f"for m in {FORBIDDEN!r}: sys.modules[m] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import importlib\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r} and sys.modules[m] is not None]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_new_modules_are_checked():
    mods = _modules()
    for m in ("pyskani_tpu_torch.ops.prng", "pyskani_tpu_torch.engine.stream",
              "pyskani_tpu_torch.db.storage",
              "pyskani_tpu_torch.utils.profiling",
              "pyskani_tpu_torch.io.native"):
        assert m in mods


def test_disk_store_stream_and_ci_run_with_jax_blocked(tmp_path):
    """A store saved, opened (streamed query with the bootstrap interval)
    and loaded, in an interpreter in which JAX cannot be imported."""
    code = (
        "import sys\n"
        f"for m in {FORBIDDEN!r}: sys.modules[m] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import numpy as np\n"
        "import pyskani_tpu_torch as p\n"
        "rng = np.random.default_rng(3)\n"
        "g = rng.choice(np.frombuffer(b'ACGT', np.uint8), 40000).tobytes()\n"
        "q = bytearray(g); q[::97] = b'A' * len(q[::97])\n"
        "db = p.Database(device='cpu')\n"
        "db.sketch('g', g)\n"
        f"db.save({str(tmp_path)!r}, format='separated')\n"
        "for opener in (p.Database.open, p.Database.load):\n"
        f"    h = opener({str(tmp_path)!r}, device='cpu').query(\n"
        "        'q', bytes(q), est_ci=True)\n"
        "    assert len(h) == 1 and h[0].ci_low <= h[0].ci_high, h\n"
        "print('ok')\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_refuses_without_cuda():
    """chip_smoke.py exits non-zero and prints no result where CUDA is
    absent (the case on a CPU-only machine)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
