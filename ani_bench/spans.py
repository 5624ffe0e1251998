#!/usr/bin/env python3
"""Break one traced window of a cell down by the program's spans.

    python3 ani_bench/spans.py --workload <cell> --seed <n> --seconds <s>
                               [--out FILE]

Sets the cell up as ``run.py`` does, traces a window of whole cycles
with ``torch.profiler`` and the program's profiling on, and prints one
JSON object: the card, the window and the device's busy time, idle time
by innermost host range, device time by the innermost program span that
launched it (``lib/spans.py``), host time by span, the program's
snapshot (calls, timers, ``host_syncs`` by scope), the most CUDA event
pairs pending at the end of a call, and the median seconds per call by
units.  Checks nothing and reports no metric: ``run.py`` does.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def _top(table: dict) -> dict:
    return dict(sorted(table.items(), key=lambda kv: -kv[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from ani_bench.lib import harness, spans, trace

    import torch
    if not torch.cuda.is_available():
        print("ani_bench: spans.py needs a CUDA card", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from pyskani_tpu_torch.utils import profiling
    cell = harness.find_cell(harness.load_benchmark(), args.workload)
    device = torch.device("cuda:0")
    entry = harness.load_entry(cell.traffic["entry"]).Entry(
        cell.config, cell.traffic, args.seed, device)
    entry.setup()
    torch.cuda.synchronize(device)
    span = f"ani_bench/{cell.traffic['entry']}"
    period = getattr(entry, "period", 1)
    profiling.reset_stats()
    profiling.enable()
    by_units, pending, n = {}, 0, 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < args.seconds or n % period:
            n += 1
            units = entry.next_units()
            s = time.perf_counter()
            with torch.profiler.record_function(span):
                entry.call()
            by_units.setdefault(units, []).append(time.perf_counter() - s)
            pending = max(pending, len(profiling.stats().pending))
        torch.cuda.synchronize(device)
    snap = profiling.stats().snapshot()
    profiling.disable()
    device_ev, host = spans.from_profiler(prof)
    summary = trace.summarize([d[:3] for d in device_ev], host)
    by_span = spans.device_by_range(device_ev, host)
    out = {
        "cell": cell.name, "seed": args.seed, "card": _card(),
        "calls": n, "window_s": summary.window_s, "busy_s": summary.busy_s,
        "outside_share_of_busy":
            by_span.get(spans.OUTSIDE, 0.0) / summary.busy_s
            if summary.busy_s else None,
        "idle_by_range": _top(summary.idle_by_range),
        "device_by_range": _top(by_span),
        "host_by_range": _top(spans.host_by_range(host)),
        "device_ops": summary.top(summary.by_name, 15),
        "program": snap, "max_pending_events": pending,
        "median_s_by_units": {u: statistics.median(d)
                              for u, d in sorted(by_units.items())},
    }
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
