"""The port's profiling scopes, counters and derived rates vs the JAX
package's (``utils/profiling.py`` in each).

``tests/test_profiling.py``'s two cases on the port; the same
``sketch``, ``sketch_many`` and ``query`` calls leave the same counters
and calls in both packages; the CLI's ``stats:`` line; the environment
switch; a ``torch.profiler`` trace holding the scopes.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import pyskani_tpu
import pyskani_tpu_torch
from conftest import mutate, random_genome
from pyskani_tpu import cli as jax_cli
from pyskani_tpu.utils import profiling as jax_profiling
from pyskani_tpu_torch import cli
from pyskani_tpu_torch.utils import profiling

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ("bases_sketched", "refs_screened", "screen_passed", "pairs_chained")


def _genome(rng, n=4000):
    return rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n).tobytes()


@pytest.fixture(autouse=True)
def _profiling_off():
    yield
    profiling.disable()
    profiling.reset_stats()
    jax_profiling.disable()
    jax_profiling.reset_stats()


def test_disabled_scope_is_noop():
    profiling.disable()
    profiling.reset_stats()
    with profiling.scope("sketch"):
        pass
    with profiling.scope("chain", "cpu"):
        pass
    snap = profiling.stats().snapshot()
    assert snap["timers_s"] == {}
    assert snap["counters"] == {}
    assert snap["calls"] == {}


def test_stats_collected_through_database():
    rng = np.random.default_rng(7)
    base = np.frombuffer(_genome(rng, 20000), np.uint8).copy()
    mut = base.copy()
    idx = rng.integers(0, len(mut), 200)
    mut[idx] = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=len(idx))

    profiling.enable()
    profiling.reset_stats()
    db = pyskani_tpu_torch.Database(device="cpu")
    db.sketch("ref", base.tobytes())
    db.query("query", mut.tobytes(), learned_ani=False)
    snap = profiling.stats().snapshot()

    assert snap["counters"]["bases_sketched"] == 40000
    assert snap["counters"]["refs_screened"] == 1
    assert snap["calls"]["sketch"] == 2
    assert snap["calls"]["screen"] == 1
    assert snap["timers_s"]["sketch"] > 0
    # derived rates appear when their inputs are present
    assert "sketch_mbp_per_s" in snap["counters"]
    assert 0.0 <= snap["counters"]["screen_pass_rate"] <= 1.0


def _drive(mod, **kw):
    """sketch, sketch_many and three queries (one hitting two
    references, one screened out, one on an empty shortlist's store)."""
    rng = np.random.default_rng(8)
    base = random_genome(rng, 40_000)
    db = mod.Database(**kw)
    db.sketch("a", mutate(rng, base, 0.01), b"ACGT" * 10)
    db.sketch_many([("b", [mutate(rng, base, 0.02)]),
                    ("c", [random_genome(rng, 30_000)]),
                    ("d", [mutate(rng, base[:20_000], 0.01),
                           mutate(rng, base[20_000:], 0.01)])])
    hits = [db.query("q", mutate(rng, base, 0.015), learned_ani=False),
            db.query("x", random_genome(rng, 25_000), learned_ani=False)]
    mod.Database(**kw).query("empty", base)
    return hits


def test_counters_and_calls_equal_jax():
    for prof in (profiling, jax_profiling):
        prof.enable()
        prof.reset_stats()
    want_hits = _drive(pyskani_tpu)
    got_hits = _drive(pyskani_tpu_torch, device="cpu")
    want = jax_profiling.stats().snapshot()
    got = profiling.stats().snapshot()
    assert [len(h) for h in got_hits] == [len(h) for h in want_hits] == [3, 0]
    for key in BASE:
        assert got["counters"][key] == want["counters"][key], key
    assert got["counters"]["screen_pass_rate"] == \
        want["counters"]["screen_pass_rate"]
    assert got["calls"] == want["calls"] == \
        {"sketch": 5, "screen": 2, "chain": 2}
    assert set(got["counters"]) == set(want["counters"])
    assert set(got["timers_s"]) == set(want["timers_s"])
    assert all(t > 0 for t in got["timers_s"].values())


def test_cli_prints_stats_as_jax(tmp_path, capsys):
    rng = np.random.default_rng(9)
    base = random_genome(rng, 40_000)
    paths = []
    for name, g in (("r", base), ("q", mutate(rng, base, 0.02))):
        paths.append(str(tmp_path / f"{name}.fa"))
        with open(paths[-1], "wb") as f:
            f.write(b">" + name.encode() + b"\n" + g + b"\n")
    argv = ["dist", "-q", paths[1], "-r", paths[0], "--learned-ani", "no"]
    stats = []
    for main, prof, extra in ((jax_cli.main, jax_profiling, []),
                              (cli.main, profiling, ["--device", "cpu"])):
        prof.enable()
        prof.reset_stats()
        assert main(argv + extra) == 0
        err = capsys.readouterr().err
        lines = [ln for ln in err.splitlines() if ln.startswith("stats: ")]
        assert len(lines) == 1
        stats.append(json.loads(lines[0][len("stats: "):]))
    want, got = stats
    assert set(got) == {"counters", "timers_s", "calls"}
    assert {k: got["counters"][k] for k in BASE} == \
        {k: want["counters"][k] for k in BASE}
    assert got["calls"] == want["calls"]
    profiling.disable()
    assert cli.main(argv + ["--device", "cpu"]) == 0
    assert "stats: " not in capsys.readouterr().err


def test_environment_switch():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from pyskani_tpu_torch.utils import profiling\n"
            "print(profiling.enabled())\n" % REPO)
    for value, want in (("1", "True"), ("0", "False")):
        env = dict(os.environ, PYSKANI_TORCH_PROFILE=value,
                   OMP_NUM_THREADS="1")
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == want


def test_trace_holds_the_scopes(tmp_path):
    profiling.enable()
    profiling.start_trace(str(tmp_path))
    db = pyskani_tpu_torch.Database(device="cpu")
    db.sketch("a", _genome(np.random.default_rng(10), 5000))
    path = profiling.stop_trace()
    assert path == str(tmp_path / "trace.json")
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "pyskani_tpu_torch/sketch" in names
    assert profiling.stop_trace() is None
