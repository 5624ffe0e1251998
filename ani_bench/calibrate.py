#!/usr/bin/env python3
"""Readings that a cell's limits are set from, many seeds in one process.

    python3 ani_bench/calibrate.py --workload <cell> --seeds 1,2,3
                                   [--seconds 5] [--control]

For each seed: the cell's set-up, a short window of its own traffic at
its own sizes, then the numbers its check compares, for the program
(the lower readings) and, with ``--control``, for the control: the
plain reference in a lower precision put in the program's place (the
upper readings).  One JSON line per seed on standard output.  The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from run import _set_caches
    _set_caches()
    import torch
    from ani_bench.lib import harness
    if not torch.cuda.is_available():
        print("ani_bench: calibrate needs a CUDA card", file=sys.stderr)
        return 1
    cell = harness.find_cell(harness.load_benchmark(), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        entry = harness.load_entry(cell.traffic["entry"]).Entry(
            cell.config, cell.traffic, seed, "cuda:0")
        entry.setup()
        t0 = time.perf_counter()
        calls = 0
        while time.perf_counter() - t0 < args.seconds:
            entry.call()
            calls += 1
        entry.release()
        row = {"seed": seed, "calls": calls, "program": entry.check()}
        if args.control:
            row["control"] = entry.check(control=True)
        print(json.dumps(row), flush=True)
        del entry
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
