"""One run of one cell: find its files by name, set up, measure a
window, check the outputs against the plain reference, and build the
result line.

The window is a closed loop of one client: each call starts when the
last has ended.  It lasts ``seconds`` and then up to the end of the
traffic's cycle, so that a rate is taken over whole cycles.

Everything that belongs to one cell is found by name:

* ``BENCHMARK.json`` names the cell's configuration file and traffic;
* ``traffic/<traffic>.json`` names the entry (``entries/<entry>.py``)
  that drives the program, the entry's parameters and the limits of the
  numbers its check compares;
* ``metrics/<metric>.py`` reads one metric from the window's record.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import sys
import time
import traceback
from typing import List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "pyskani_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    metrics_e2e: List[dict]
    metrics_layer: List[dict]


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def find_cell(bench: dict, name: str, root: str = ROOT) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, layer)


def load_entry(name: str):
    return importlib.import_module(f"ani_bench.entries.{name}")


def load_reader(name: str):
    """The ``read(ctx)`` of ``metrics/<name>.py`` (names may hold dots)."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "ani_bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Window:
    """What a measured window leaves for the metric readers."""

    unit: str
    start: float                      # perf_counter seconds
    calls: List[tuple]                # (start, end, units) completed calls
    setup_s: float
    facts: dict
    trace: Optional[object] = None    # lib.trace.Summary of a traced run
    program: Optional[dict] = None    # the program's profiling snapshot

    @property
    def end(self) -> float:
        return self.calls[-1][1] if self.calls else self.start

    @property
    def units(self) -> int:
        return sum(u for _, _, u in self.calls)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, log=print) -> dict:
    """Run the cell once; returns the result line's object."""
    import torch
    device = torch.device(device)
    entry = load_entry(cell.traffic["entry"]).Entry(
        cell.config, cell.traffic, seed, device)
    entry.setup()
    _sync(device)
    # the set-up's objects (genome pools, sketches) are left out of every
    # collection in the window, which then traverses the window's own
    gc.collect()
    gc.freeze()
    prof = None
    if trace:
        from pyskani_tpu_torch.utils import profiling
        from torch.profiler import ProfilerActivity, profile
        profiling.reset_stats()
        profiling.enable()
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    calls, attempted, failed, errors = [], 0, 0, []
    span = f"ani_bench/{cell.traffic['entry']}"
    setup_s = time.perf_counter() - t_start
    # the window closes at the end of the first whole cycle of the
    # traffic (``entry.period`` calls) after ``seconds``, so that where in
    # its cycle the window ends does not move a rate
    period = getattr(entry, "period", 1)
    n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds or n % period:
        n += 1
        units = entry.next_units()
        attempted += units
        s = time.perf_counter()
        try:
            if trace:
                with torch.profiler.record_function(span):
                    entry.call()
            else:
                entry.call()
        except Exception:                 # a failed call is counted
            failed += units
            errors.append(traceback.format_exc())
            continue
        calls.append((s, time.perf_counter(), units))
    window = Window(unit=entry.unit, start=t0, calls=calls, setup_s=setup_s,
                    facts=entry.facts)
    log(f"ani_bench: set-up {setup_s:.2f} s; {len(calls)} calls in "
        f"{window.end - t0:.2f} s")
    by_units = {}
    for s, e, u in calls:
        by_units.setdefault(u, []).append(e - s)
    log("ani_bench: median seconds per call by units: " + ", ".join(
        f"{u}: {sorted(d)[len(d) // 2]:.4f} ({len(d)})"
        for u, d in sorted(by_units.items())))
    if trace:
        from pyskani_tpu_torch.utils import profiling
        from . import trace as tracemod
        t1 = time.perf_counter()
        _sync(device)
        prof.__exit__(None, None, None)
        window.program = profiling.stats().snapshot()
        profiling.disable()
        window.trace = tracemod.from_profiler(prof)
        del prof
        log(f"ani_bench: trace read in {time.perf_counter() - t1:.2f} s")
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    entry.release()
    for err in errors[:3]:
        log(err)
    t1 = time.perf_counter()
    checks = entry.check() if calls else {}
    log(f"ani_bench: reference check in {time.perf_counter() - t1:.2f} s")
    limits = cell.traffic["limits"]
    correct = bool(checks) and failed == 0 and \
        all(checks[k] <= limits[k] for k in checks)
    metrics = {}
    for m in (cell.metrics_layer if trace else cell.metrics_e2e):
        value = load_reader(m["name"])(window) if calls else None
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if trace and window.trace is not None:
        dev["busy_s"] = window.trace.busy_s
        dev["window_s"] = window.trace.window_s
        out["breakdown"] = {
            "device_ops": window.trace.top(window.trace.by_name),
            "idle_gaps": window.trace.top(window.trace.idle_by_range)}
    out["checks"] = {k: {"value": v, "limit": limits[k]}
                     for k, v in checks.items()}
    return out
