"""Profiling scopes, counters and derived rates.

Port of the JAX package's ``utils/profiling.py``, with the same public
names and snapshot keys:

* ``scope(name)`` opens a ``torch.profiler.record_function`` range
  named ``pyskani_tpu_torch/<name>`` (visible in ``torch.profiler``
  traces) and times the scope into the process-wide :class:`Stats`: on
  a CUDA device with a pair of timing events on the current stream, read
  lazily (pairs the device has passed are settled once a few thousand
  are pending, the rest by :meth:`Stats.snapshot`) so the hot path never
  syncs; on the CPU with ``perf_counter``.  The JAX package's scopes are
  ``sketch``, ``screen`` and ``chain``; the port's own spans nest under
  them and under its other layers with ``/`` (``triangle/group``,
  ``chain/post``, ``sketch/pack``, ``stream/load``, ``storage/decode``,
  ...);
* ``Stats`` holds the counters (``bases_sketched``, ``refs_screened``,
  ``screen_passed``, ``pairs_chained``), the per-scope seconds and
  calls, and derives ``pairs_per_s``, ``sketch_mbp_per_s`` and
  ``screen_pass_rate``;
* ``host_syncs`` counts the host's waits on a CUDA device, while
  profiling is on and CUDA is initialised: ``torch.cuda``'s sync-debug
  mode warns at each synchronising operation, and each warning adds 1 to
  ``host_syncs`` and to ``host_syncs/<innermost open scope>``
  (``host_syncs/-`` outside every scope), printing nothing;
* ``start_trace(logdir)`` / ``stop_trace()`` wrap ``torch.profiler``
  and write a Chrome trace into ``logdir``.

Everything is a no-op unless ``enable()`` was called or the
``PYSKANI_TORCH_PROFILE=1`` environment variable is set: a disabled
scope is one shared null context, so it makes no device sync and
allocates nothing, and no sync-debug mode or warning filter is set.
"""

from __future__ import annotations

import contextlib
import os
import re
import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional

__all__ = ["enable", "disable", "enabled", "scope", "stats", "reset_stats",
           "start_trace", "stop_trace", "Stats"]

_enabled = bool(int(os.environ.get("PYSKANI_TORCH_PROFILE", "0")))
_lock = threading.Lock()
_NULL = contextlib.nullcontext()
_local = threading.local()        # .stack: names of this thread's open scopes
# the text of torch's warning at each synchronising CUDA operation
SYNC_MESSAGE = "called a synchronizing CUDA operation"
# CUDA event pairs held before the ones the device has passed are read
PENDING_LIMIT = 4096
# (filter entry, our showwarning, the previous one, the previous
# sync-debug mode) while the host-sync counter is on
_hook = None
_hook_lock = threading.Lock()


@dataclass
class Stats:
    """Process-wide counters and scope timers."""

    counters: Dict[str, float] = field(default_factory=dict)
    timers: Dict[str, float] = field(default_factory=dict)
    calls: Dict[str, int] = field(default_factory=dict)
    # (name, start event, end event) of CUDA scopes not yet read
    pending: List[tuple] = field(default_factory=list)
    # pending pairs at which the next read of the passed ones is due
    _settle_at: int = PENDING_LIMIT

    def add(self, name: str, value: float = 1.0) -> None:
        with _lock:
            self.counters[name] = self.counters.get(name, 0.0) + value

    def time(self, name: str, seconds: float) -> None:
        with _lock:
            self.timers[name] = self.timers.get(name, 0.0) + seconds
            self.calls[name] = self.calls.get(name, 0) + 1

    def time_events(self, name: str, start, end) -> None:
        """Count a call of ``name`` whose seconds two recorded CUDA
        events will give once the device has passed them.  Past
        ``PENDING_LIMIT`` pending pairs, those already passed are read, so
        that a long traced run holds a bounded number."""
        with _lock:
            self.calls[name] = self.calls.get(name, 0) + 1
            self.pending.append((name, start, end))
            full = len(self.pending) >= self._settle_at
        if full:
            self._settle(wait=False)

    def _settle(self, wait: bool = True) -> None:
        """Add the seconds of pending event pairs to the timers: of all
        of them, waiting for the device, or with ``wait=False`` of those
        the device has passed (``Event.query``, no sync)."""
        with _lock:
            pending, self.pending = self.pending, []
        left = []
        for name, start, end in pending:
            if wait:
                end.synchronize()
            elif not end.query():
                left.append((name, start, end))
                continue
            with _lock:
                self.timers[name] = self.timers.get(name, 0.0) + \
                    start.elapsed_time(end) / 1e3
        with _lock:
            self.pending = left + self.pending
            self._settle_at = max(PENDING_LIMIT, 2 * len(self.pending))

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
    _count_syncs()


def disable() -> None:
    global _enabled
    _enabled = False
    _stop_counting_syncs()


def enabled() -> bool:
    return _enabled


def _open_scopes() -> List[str]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _count_syncs() -> None:
    """Turn the host-sync counter on, where CUDA is initialised: set
    sync-debug mode ``warn`` and take torch's sync warnings, every one of
    them (an ``always`` filter: the default shows a line once), passing
    every other warning to the ``showwarning`` that was there."""
    global _hook
    import torch
    with _hook_lock:
        if _hook is None and torch.cuda.is_initialized():
            _hook = _install_sync_hook(torch)


def _install_sync_hook(torch) -> tuple:
    previous = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        if SYNC_MESSAGE not in str(message):
            previous(message, category, filename, lineno, file, line)
            return
        stack = _open_scopes()
        _stats.add("host_syncs")
        _stats.add("host_syncs/" + (stack[-1] if stack else "-"))

    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        # torch warns once that the mode is a prototype
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
    warnings.filterwarnings("always", message=".*" + re.escape(SYNC_MESSAGE))
    warnings.showwarning = show
    return warnings.filters[0], show, previous, mode


def _stop_counting_syncs() -> None:
    """Restore the sync-debug mode, the filters and the ``showwarning``
    that :func:`_count_syncs` found.  An ``always`` filter writes no
    warning registry, so removing it leaves nothing stale."""
    global _hook
    with _hook_lock:
        if _hook is None:
            return
        entry, show, previous, mode = _hook
        _hook = None
    import torch
    torch.cuda.set_sync_debug_mode(mode)
    if warnings.showwarning is show:
        warnings.showwarning = previous
    with contextlib.suppress(ValueError):
        warnings.filters.remove(entry)


def scope(name: str, device=None):
    """Named profiling scope: a ``record_function`` range and a timer of
    the work in it, on ``device`` (CUDA events on a CUDA device, wall
    clock otherwise).  Disabled, it is one shared null context."""
    if not _enabled:
        return _NULL
    return _scope(name, device)


@contextlib.contextmanager
def _scope(name: str, device):
    import torch

    if _hook is None:
        _count_syncs()
    cuda = device is not None and torch.device(device).type == "cuda"
    stack = _open_scopes()
    with torch.profiler.record_function(f"pyskani_tpu_torch/{name}"):
        stack.append(name)
        try:
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
        finally:
            stack.pop()


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
