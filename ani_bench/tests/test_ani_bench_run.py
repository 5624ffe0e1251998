"""The run's guards and its result line: the whole-name import check,
the exit without a card or without the program, and the line's keys
from a CPU run of each cell at a tiny size."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, tiny_cell
from ani_bench.lib import harness


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pyskani_tpu_torch_x", object())
    assert "pyskani_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "pyskani_tpu.oracle", object())
    assert "pyskani_tpu" in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax", object())
    assert "jax" in harness.forbidden_modules()


def _run(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "ani_bench/run.py", "--workload",
         "derep_triangle-species", "--seed", "1", "--seconds", "1"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_exits_without_a_card_and_prints_no_result():
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_exits_where_only_the_benchmark_is(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "ani_bench"), tmp_path / "ani_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_window_ends_on_a_whole_cycle():
    cell = tiny_cell("derep_triangle-species")
    out = harness.run(cell, 2**31 + 6, 0.01, False, "cpu", 0.0,
                      log=lambda s: None)
    per_cycle = sum(count * size * (size - 1) // 2
                    for size, count in cell.traffic["cycle"])
    assert out["attempted"] > 0 and out["attempted"] % per_cycle == 0


@pytest.mark.parametrize("name", ["derep_triangle-species",
                                  "derep_triangle-sketch"])
@pytest.mark.parametrize("traced", [False, True])
def test_result_line_on_the_cpu(name, traced):
    cell = tiny_cell(name)
    out = harness.run(cell, 2**31 + 5, 0.5, traced, "cpu", 0.0,
                      log=lambda s: None)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    line = json.loads(json.dumps(out))
    names = {m["name"] for m in
             (cell.metrics_layer if traced else cell.metrics_e2e)}
    assert set(line["metrics"]) <= names
    if not traced:
        assert set(line["metrics"]) == names
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
