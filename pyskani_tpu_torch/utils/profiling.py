"""Profiling scopes, counters and derived rates.

Port of the JAX package's ``utils/profiling.py``, with the same public
names and snapshot keys:

* ``scope(name)`` opens a ``torch.profiler.record_function`` range
  named ``pyskani_tpu_torch/<name>`` (visible in ``torch.profiler``
  traces) and times the scope into the process-wide :class:`Stats`: on
  a CUDA device with a pair of timing events on the current stream, read
  lazily by :meth:`Stats.snapshot` so the hot path never syncs; on the
  CPU with ``perf_counter``;
* ``Stats`` holds the counters (``bases_sketched``, ``refs_screened``,
  ``screen_passed``, ``pairs_chained``), the per-scope seconds and
  calls, and derives ``pairs_per_s``, ``sketch_mbp_per_s`` and
  ``screen_pass_rate``;
* ``start_trace(logdir)`` / ``stop_trace()`` wrap ``torch.profiler``
  and write a Chrome trace into ``logdir``.

Everything is a no-op unless ``enable()`` was called or the
``PYSKANI_TORCH_PROFILE=1`` environment variable is set: a disabled
scope makes no device sync and allocates nothing.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

__all__ = ["enable", "disable", "enabled", "scope", "stats", "reset_stats",
           "start_trace", "stop_trace", "Stats"]

_enabled = bool(int(os.environ.get("PYSKANI_TORCH_PROFILE", "0")))
_lock = threading.Lock()


@dataclass
class Stats:
    """Process-wide counters and scope timers."""

    counters: Dict[str, float] = field(default_factory=dict)
    timers: Dict[str, float] = field(default_factory=dict)
    calls: Dict[str, int] = field(default_factory=dict)
    # (name, start event, end event) of CUDA scopes not yet read
    pending: List[tuple] = field(default_factory=list)

    def add(self, name: str, value: float = 1.0) -> None:
        with _lock:
            self.counters[name] = self.counters.get(name, 0.0) + value

    def time(self, name: str, seconds: float) -> None:
        with _lock:
            self.timers[name] = self.timers.get(name, 0.0) + seconds
            self.calls[name] = self.calls.get(name, 0) + 1

    def time_events(self, name: str, start, end) -> None:
        """Count a call of ``name`` whose seconds two recorded CUDA
        events will give once the device has passed them."""
        with _lock:
            self.calls[name] = self.calls.get(name, 0) + 1
            self.pending.append((name, start, end))

    def _settle(self) -> None:
        with _lock:
            pending, self.pending = self.pending, []
        for name, start, end in pending:
            end.synchronize()
            with _lock:
                self.timers[name] = self.timers.get(name, 0.0) + \
                    start.elapsed_time(end) / 1e3

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        self._settle()
        with _lock:
            out = {
                "counters": dict(self.counters),
                "timers_s": dict(self.timers),
                "calls": dict(self.calls),
            }
        # derived rates
        t_chain = out["timers_s"].get("chain", 0.0)
        pairs = out["counters"].get("pairs_chained", 0.0)
        if t_chain > 0 and pairs:
            out["counters"]["pairs_per_s"] = pairs / t_chain
        t_sketch = out["timers_s"].get("sketch", 0.0)
        bp = out["counters"].get("bases_sketched", 0.0)
        if t_sketch > 0 and bp:
            out["counters"]["sketch_mbp_per_s"] = bp / 1e6 / t_sketch
        screened = out["counters"].get("refs_screened", 0.0)
        passed = out["counters"].get("screen_passed", 0.0)
        if screened:
            out["counters"]["screen_pass_rate"] = passed / screened
        return out


_stats = Stats()
_trace = None


def stats() -> Stats:
    return _stats


def reset_stats() -> None:
    global _stats
    _stats = Stats()


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


@contextlib.contextmanager
def scope(name: str, device=None):
    """Named profiling scope: a ``record_function`` range and a timer of
    the work in it, on ``device`` (CUDA events on a CUDA device, wall
    clock otherwise).  No-op when profiling is disabled."""
    if not _enabled:
        yield
        return
    import torch

    cuda = device is not None and torch.device(device).type == "cuda"
    with torch.profiler.record_function(f"pyskani_tpu_torch/{name}"):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                yield
            finally:
                end.record()
                _stats.time_events(name, start, end)
        else:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                _stats.time(name, time.perf_counter() - t0)


def start_trace(logdir: str) -> None:
    """Start a ``torch.profiler`` trace of the CPU and, where present, the
    GPU; :func:`stop_trace` writes it into ``logdir``."""
    global _trace
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    _trace = (profile(activities=acts), logdir)
    _trace[0].__enter__()


def stop_trace() -> Optional[str]:
    """Stop the trace and write it as ``<logdir>/trace.json`` (Chrome
    trace format); returns that path."""
    global _trace
    if _trace is None:
        return None
    prof, logdir = _trace
    _trace = None
    prof.__exit__(None, None, None)
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    return path
