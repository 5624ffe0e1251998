#!/usr/bin/env python3
"""Run one cell of the benchmark of ``pyskani_tpu_torch`` once.

    python3 ani_bench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Sets up (genomes made on the card from the seed, sketched, every shape
of the cell warmed up), measures a closed loop of one
client for ``--seconds``, checks the outputs against the plain
reference, and prints one JSON object as the last line of standard
output.  ``--trace 1`` traces the window with ``torch.profiler`` and
reports the cell's per-layer metrics instead of its end-to-end ones.
Exits non-zero, with no result, without enough CUDA cards, when the
program is missing, or when the JAX package or JAX was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

T_IMPORT = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _process_age() -> float:
    """Seconds since this process started (the kernel's start time)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def _set_caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths,
    so that only a cell's first run in a checkout builds."""
    cache = os.path.join(ROOT, ".ani_bench_cache")
    for var, sub in (("PYSKANI_TORCH_BUILD_DIR", "build"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    t_start = min(time.perf_counter() - _process_age(), T_IMPORT)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _set_caches()
    sys.path.insert(0, ROOT)
    from ani_bench.lib import harness
    bench = harness.load_benchmark()
    cell = harness.find_cell(bench, args.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"ani_bench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    import pyskani_tpu_torch  # noqa: F401  (fails where the program is absent)

    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda:0", t_start,
                         log=lambda s: print(s, file=sys.stderr))
    found = harness.forbidden_modules()
    if found:
        print(f"ani_bench: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
