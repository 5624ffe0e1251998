"""Seconds of each phase of a set-up or a check, on standard error."""

import sys
import time
from contextlib import contextmanager


@contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    yield
    print(f"ani_bench: {name} {time.perf_counter() - t0:.2f} s",
          file=sys.stderr, flush=True)
