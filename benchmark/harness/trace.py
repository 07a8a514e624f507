"""What the traced run reads from the profiler: device intervals, the
benchmark's spans, busy and idle time, and the breakdown.

The device is busy where at least one operation (kernel, copy or set) ran:
the union of their intervals, never their sum, so that overlapping
operations count once. An idle gap is named by the innermost benchmark
span (``torch.profiler.record_function`` named ``bench.*``) open at its
middle.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

SPAN_PREFIX = "bench."
Interval = Tuple[float, float]


def union(intervals: List[Interval]) -> List[Interval]:
    """Sorted, merged intervals."""
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def total(intervals: List[Interval]) -> float:
    return sum(e - s for s, e in intervals)


def intersect(a: List[Interval], b: List[Interval]) -> List[Interval]:
    """Intersection of two merged, sorted interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def gaps(busy: List[Interval], window: Interval) -> List[Interval]:
    """The idle intervals of ``window`` between merged busy intervals."""
    out, t = [], window[0]
    for s, e in busy:
        if s > t:
            out.append((t, min(s, window[1])))
        t = max(t, e)
        if t >= window[1]:
            break
    if t < window[1]:
        out.append((t, window[1]))
    return [(s, e) for s, e in out if e > s]


def innermost(spans: List[Tuple[str, float, float]], t: float) -> str:
    """Name of the shortest span that holds time t."""
    best, length = "no span", float("inf")
    for name, s, e in spans:
        if s <= t <= e and e - s < length:
            best, length = name, e - s
    return best


@dataclass
class Trace:
    """Device intervals and spans of the traced window, in seconds."""

    device: List[Tuple[str, float, float]] = field(default_factory=list)
    spans: List[Tuple[str, float, float]] = field(default_factory=list)
    window: Interval = (0.0, 0.0)

    def busy(self) -> List[Interval]:
        return intersect(union([(s, e) for _n, s, e in self.device]),
                         [self.window])

    def busy_s(self) -> float:
        return total(self.busy())

    def span_intervals(self, name: str) -> List[Interval]:
        return union([(s, e) for n, s, e in self.spans if n == name])

    def busy_in(self, name: str) -> float:
        """Device-busy seconds inside the spans called ``name``."""
        return total(intersect(self.busy(), self.span_intervals(name)))

    def top_ops(self, k: int = 10) -> List[list]:
        acc: Dict[str, float] = defaultdict(float)
        for n, s, e in self.device:
            acc[n] += e - s
        return [[n, v] for n, v in sorted(acc.items(),
                                          key=lambda x: -x[1])[:k]]

    def idle_by_span(self, k: int = 10) -> List[list]:
        acc: Dict[str, float] = defaultdict(float)
        for s, e in gaps(self.busy(), self.window):
            acc[innermost(self.spans, 0.5 * (s + e))] += e - s
        return [[n, v] for n, v in sorted(acc.items(),
                                          key=lambda x: -x[1])[:k]]


def _is_device_op(ev) -> bool:
    if "CUDA" not in str(ev.device_type()):
        return False
    kind = str(getattr(ev, "activity_type", lambda: "")()).lower()
    if "annotation" in kind or ev.name().startswith(SPAN_PREFIX):
        return False
    return ev.duration_ns() > 0


def from_profiler(prof, window_span: str = SPAN_PREFIX + "window") -> Trace:
    """A :class:`Trace` of a stopped ``torch.profiler.profile``: its device
    operations, the ``bench.*`` spans on the host, and the window span's
    extent."""
    t = Trace()
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns() * 1e-9
        e = s + ev.duration_ns() * 1e-9
        if _is_device_op(ev):
            t.device.append((ev.name(), s, e))
        elif ev.name().startswith(SPAN_PREFIX) and "CUDA" not in str(
                ev.device_type()):
            if ev.name() == window_span:
                t.window = (s, e)
            else:
                t.spans.append((ev.name(), s, e))
    return t
