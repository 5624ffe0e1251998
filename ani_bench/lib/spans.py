"""Device and host time by the program's spans in a traced window, and
the program's host-sync counts: what ``lib/trace.py``'s summary does not
break down.

* ``device_by_range``: device seconds of the activities launched inside
  each innermost program span (``pyskani_tpu_torch/<name>``).  An
  activity is placed by its launch: the host call of the CUDA runtime
  (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...) that shares its
  correlation id.  Activity launched outside every program span counts
  under ``outside any range``.
* ``host_by_range``: host seconds of each span name (program and
  benchmark spans), summed over its calls.
* ``program_syncs``: the program's ``host_syncs`` counter less the syncs
  made outside every program span (the benchmark's own reads).

The window is ``lib/trace.py``'s: from the start of the first benchmark
span to the end of the last.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Sequence, Tuple

from .trace import HOST_PREFIXES, SPAN_PREFIX

PROGRAM_PREFIX = "pyskani_tpu_torch/"
OUTSIDE = "outside any range"
SYNCS = "host_syncs"


def _window(host) -> Tuple[int, int]:
    spans = [(s, e) for s, e, name in host if name.startswith(SPAN_PREFIX)]
    if not spans:
        raise ValueError("the trace holds no benchmark span")
    return min(s for s, _ in spans), max(e for _, e in spans)


def innermost(points: Sequence[Tuple[int, float]],
              ranges: Sequence[Tuple[int, int, str]]) -> Dict[str, float]:
    """Sum each (time_ns, seconds) point under the innermost range
    (start_ns, end_ns, name) with start <= time < end (ranges of one
    thread nest, so a stack finds it), or under ``OUTSIDE``."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out: Dict[str, float] = {}
    stack: List[Tuple[int, str]] = []
    i = 0
    for t, sec in sorted(points):
        while i < len(ranges) and ranges[i][0] <= t:
            stack.append((ranges[i][1], ranges[i][2]))
            i += 1
        stack = [r for r in stack if r[0] > t]
        tag = stack[-1][1] if stack else OUTSIDE
        out[tag] = out.get(tag, 0.0) + sec
    return out


def device_by_range(device: Sequence[Tuple[int, int, str, int]],
                    host: Sequence[Tuple[int, int, str]]) -> Dict[str, float]:
    """Device seconds in the window by the innermost program span holding
    each activity's launch.  ``device`` holds (start_ns, end_ns, name,
    launch_ns), ``host`` (start_ns, end_ns, name)."""
    w0, w1 = _window(host)
    points = []
    for s, e, _, launch in device:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            points.append((launch, (e - s) / 1e9))
    program = [r for r in host if r[2].startswith(PROGRAM_PREFIX)]
    return innermost(points, program)


def host_by_range(host: Sequence[Tuple[int, int, str]]) -> Dict[str, float]:
    """Host seconds in the window by span name."""
    w0, w1 = _window(host)
    out: Dict[str, float] = {}
    for s, e, name in host:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            out[name] = out.get(name, 0.0) + (e - s) / 1e9
    return out


def from_profiler(prof):
    """(device, host) tuples of a finished ``torch.profiler.profile``:
    device activities with their launch times, and the program's and the
    benchmark's host ranges."""
    from torch.autograd import DeviceType
    device, host, runtime = [], [], {}
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            # a host range's mirror on the device timeline is no activity
            if not (name.startswith(HOST_PREFIXES) or
                    ev.is_user_annotation()):
                device.append((ev.start_ns(), ev.end_ns(), name,
                               ev.correlation_id()))
        elif name.startswith(HOST_PREFIXES):
            host.append((ev.start_ns(), ev.end_ns(), name))
        elif name.startswith("cu"):
            runtime[ev.correlation_id()] = ev.start_ns()
    device = [(s, e, name, runtime.get(corr, s))
              for s, e, name, corr in device]
    return device, host


def program_syncs(program: Optional[dict]) -> Optional[float]:
    """Host syncs the program counted inside its spans, or None where it
    counts none (profiling off, no CUDA, or a program without the
    counter)."""
    if not program:
        return None
    counters = program.get("counters", {})
    if SYNCS not in counters:
        return None
    return counters[SYNCS] - counters.get(SYNCS + "/-", 0.0)


def log_syncs(program: dict, n: int = 12) -> None:
    """The host-sync counts by innermost scope, largest first, on
    standard error."""
    by_scope = sorted(((k[len(SYNCS) + 1:], v) for k, v in
                       program.get("counters", {}).items()
                       if k.startswith(SYNCS + "/")), key=lambda kv: -kv[1])
    print("ani_bench: host syncs by scope: " + ", ".join(
        f"{k}: {v:.0f}" for k, v in by_scope[:n]), file=sys.stderr)


def span_device_ms_per_kpair(w, span: str) -> Optional[float]:
    """Milliseconds of the program's span ``span`` on the device's clock
    (its CUDA timing events, in the snapshot's ``timers_s``) per 1,000
    pairs of the window, or None without the span or a device."""
    if w.unit != "pairs" or not w.program or w.units == 0 \
            or w.trace is None or w.trace.busy_s <= 0:
        return None
    sec = w.program.get("timers_s", {}).get(span)
    if sec is None:
        return None
    return sec * 1e3 / (w.units / 1e3)
