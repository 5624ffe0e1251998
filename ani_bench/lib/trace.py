"""The device trace of a measured window, reduced to what the per-layer
metrics read: the device's busy time (the union of its activity
intervals), the window's length, device time by operation name, and the
idle time between device activities by the host range it fell in.

Host ranges are the ``record_function`` ranges of the program
(``pyskani_tpu_torch/<scope>``) and the benchmark's own spans
(``ani_bench/<entry>``).  The window runs from the start of the first
benchmark span to the end of the last.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

HOST_PREFIXES = ("pyskani_tpu_torch/", "ani_bench/")
SPAN_PREFIX = "ani_bench/"


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    by_name: Dict[str, float]        # device seconds by operation name
    idle_by_range: Dict[str, float]  # idle seconds by innermost host range

    def top(self, table: Dict[str, float], n: int = 10) -> List[list]:
        return [[name[:120], sec] for name, sec in
                sorted(table.items(), key=lambda kv: -kv[1])[:n]]


def summarize(device: Sequence[Tuple[int, int, str]],
              host: Sequence[Tuple[int, int, str]]) -> Summary:
    """Reduce device activities and host ranges, each (start_ns, end_ns,
    name), over the window the benchmark's spans cover."""
    spans = [(s, e) for s, e, name in host if name.startswith(SPAN_PREFIX)]
    if not spans:
        raise ValueError("the trace holds no benchmark span")
    w0 = min(s for s, _ in spans)
    w1 = max(e for _, e in spans)
    by_name: Dict[str, float] = {}
    clipped = []
    for s, e, name in device:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        clipped.append((s, e))
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
    clipped.sort()
    busy = 0
    gaps = []
    cur = w0
    for s, e in clipped:
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if w1 > cur:
        gaps.append((cur, w1))
    return Summary(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9,
                   by_name=by_name, idle_by_range=_tag_gaps(gaps, host))


def _tag_gaps(gaps, host) -> Dict[str, float]:
    """Idle seconds by the innermost host range holding each gap's
    midpoint (ranges of one thread nest, so a stack finds it)."""
    ranges = sorted(host, key=lambda r: (r[0], -r[1]))
    out: Dict[str, float] = {}
    stack: List[Tuple[int, str]] = []
    i = 0
    for g0, g1 in sorted(gaps):
        mid = (g0 + g1) // 2
        while i < len(ranges) and ranges[i][0] <= mid:
            stack.append((ranges[i][1], ranges[i][2]))
            i += 1
        stack = [r for r in stack if r[0] > mid]
        tag = stack[-1][1] if stack else "outside any range"
        out[tag] = out.get(tag, 0.0) + (g1 - g0) / 1e9
    return out


def from_profiler(prof) -> Summary:
    """Read a finished ``torch.profiler.profile``'s raw events."""
    from torch.autograd import DeviceType
    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        ranged = name.startswith(HOST_PREFIXES)
        if ev.device_type() == DeviceType.CUDA:
            # a host range is mirrored on the device's timeline as a GPU
            # user annotation: it is no device activity
            if not (ranged or ev.is_user_annotation()):
                device.append((ev.start_ns(), ev.end_ns(), name))
        elif ranged:
            host.append((ev.start_ns(), ev.end_ns(), name))
    return summarize(device, host)
