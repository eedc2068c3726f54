"""The traced window: `torch.profiler` over a run of rounds, reduced to the
device activities, the program's profiler ranges and the host's ops, on
the profiler's clock (microseconds).

The window is the host-side range `WINDOW` around the traced rounds and
the synchronise that ends them; device activities are clipped to it.
The device is busy where any activity runs (the union of their
intervals); a profiler range's device time is that of the activities
inside its device-side ranges.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from portbench.cost import activity_class

#: the host range that marks the traced window
WINDOW = "portbench.window"

Span = Tuple[float, float]


@dataclass
class Trace:
    rounds: int
    start: float
    end: float
    kernels: List[Tuple[str, float, float]] = field(default_factory=list)
    ranges: Dict[str, List[Span]] = field(default_factory=dict)
    host: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def busy(self) -> List[Span]:
        """The union of the device activities' intervals."""
        out: List[Span] = []
        for _, a, b in sorted(self.kernels, key=lambda k: k[1]):
            if out and a <= out[-1][1]:
                if b > out[-1][1]:
                    out[-1] = (out[-1][0], b)
            else:
                out.append((a, b))
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) * 1e-6

    def gaps(self) -> List[Span]:
        """The device's idle intervals inside the window."""
        out, t = [], self.start
        for a, b in self.busy():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.end > t:
            out.append((t, self.end))
        return out

    def class_s(self, label: str) -> float:
        """Device seconds of the activities of one class
        (`portbench.cost.ACTIVITY_CLASSES`)."""
        return sum(b - a for n, a, b in self.kernels
                   if activity_class(n) == label) * 1e-6

    def named_s(self, word: str) -> float:
        """Device seconds of the activities whose name holds ``word``."""
        return sum(b - a for n, a, b in self.kernels
                   if word in n.lower()) * 1e-6

    def range_s(self, name: str) -> Optional[float]:
        """Device seconds of the activities inside the program's ranges
        named ``name``; None when the trace holds no such range."""
        spans = self.ranges.get(name)
        if not spans:
            return None
        acts = sorted((a, b) for _, a, b in self.kernels)
        starts = [a for a, _ in acts]
        total = 0.0
        for lo, hi in spans:
            i = bisect.bisect_left(starts, lo)
            while i < len(acts) and acts[i][0] < hi:
                total += min(acts[i][1], hi) - acts[i][0]
                i += 1
        return total * 1e-6

    def breakdown(self, top: int = 10) -> dict:
        """The device activities that took the most time, and the longest
        idle time by what the host was doing (the innermost host op
        running during each gap), as [name, seconds] lists."""
        ops: Dict[str, float] = defaultdict(float)
        for n, a, b in self.kernels:
            ops[n] += (b - a) * 1e-6
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        idle: Dict[str, float] = defaultdict(float)
        for a, b in self.gaps():
            name = "(no host op)"
            i = bisect.bisect_right(starts, b) - 1
            for j in range(i, max(i - 400, -1), -1):
                if host[j][2] >= a:
                    name = host[j][0]
                    break
            idle[name] += (b - a) * 1e-6

        def ranked(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:top]]
        return {"device_ops": ranked(ops), "idle_gaps": ranked(idle)}


def _runtime_call(name: str) -> bool:
    return name.startswith("cuda") or name.startswith("cu") and \
        name[2:3].isupper()


def from_profile(prof, rounds: int) -> Trace:
    """The `Trace` of a finished `torch.profiler.profile` whose traced
    rounds ran inside a `WINDOW` range."""
    from torch.autograd import DeviceType
    kernels, host, ranges = [], [], defaultdict(list)
    window = None
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False):
                if e.name != WINDOW:
                    ranges[e.name].append((tr.start, tr.end))
            else:
                kernels.append((e.name, tr.start, tr.end))
        elif e.name == WINDOW:
            window = (tr.start, tr.end)
        elif not _runtime_call(e.name) and not e.name.startswith(
                "ProfilerStep"):
            host.append((e.name, tr.start, tr.end))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    lo, hi = window
    kernels = [(n, max(a, lo), min(b, hi)) for n, a, b in kernels
               if b > lo and a < hi]
    host = [h for h in host if h[2] > lo and h[1] < hi]
    return Trace(rounds=rounds, start=lo, end=hi, kernels=kernels,
                 ranges={k: v for k, v in ranges.items()}, host=host)
