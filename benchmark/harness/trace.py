"""Reading a ``torch.profiler`` trace of a window: the device's busy time
(the union of its kernel, copy and memset intervals), its idle gaps and
what the host was doing in each, and the device time of operations by name.

``Trace`` holds plain tuples (name, start_us, end_us), so the metric
readers and the tests work on synthetic interval lists as well.
"""

from __future__ import annotations

from dataclasses import dataclass


def union_us(intervals):
    """Total length of the union of (start, end) intervals."""
    busy, last = 0.0, -float("inf")
    for lo, hi in sorted(intervals):
        lo = max(lo, last)
        if hi > lo:
            busy += hi - lo
        last = max(last, hi)
    return busy


def gaps(intervals, start: float, end: float):
    """The idle (start, end) gaps of the device between ``start`` and ``end``."""
    out, last = [], start
    for lo, hi in sorted(intervals):
        if lo > last:
            out.append((last, min(lo, end)))
        last = max(last, hi)
        if last >= end:
            break
    if last < end:
        out.append((last, end))
    return [(a, b) for a, b in out if b > a]


@dataclass
class Trace:
    """device: (name, start_us, end_us) of each device operation; host:
    (name, start_us, end_us, depth) of the host's operations on the
    launching thread; window: (start_us, end_us) of the traced window."""

    device: list
    host: list
    window: tuple

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def _clipped(self):
        lo, hi = self.window
        return [(max(a, lo), min(b, hi)) for _, a, b in self.device if b > lo and a < hi]

    @property
    def busy_s(self) -> float:
        return union_us(self._clipped()) / 1e6

    def device_seconds(self, match) -> tuple:
        """(seconds, launches) of the device operations whose name satisfies
        ``match``."""
        hits = [(b - a) for name, a, b in self.device if match(name)]
        return sum(hits) / 1e6, len(hits)

    def top_ops(self, n: int = 10):
        """The ``n`` device operations (by name) that took most time: [[name, s]]."""
        by: dict = {}
        for name, a, b in self.device:
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return [[name[:120], s] for name, s in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_host(self, n: int = 10):
        """The device's idle time summed by the innermost host operation
        running at each gap's midpoint: [[name, s]], the largest first."""
        by: dict = {}
        host = sorted(self.host, key=lambda e: e[1])
        active, i = [], 0
        for a, b in gaps(self._clipped(), *self.window):
            mid = (a + b) / 2
            while i < len(host) and host[i][1] <= mid:
                active.append(host[i])
                i += 1
            active = [e for e in active if e[2] >= mid]
            inner = max(active, key=lambda e: e[3], default=None)
            key = inner[0] if inner else "(no host operation)"
            by[key] = by.get(key, 0.0) + (b - a) / 1e6
        return [[name[:120], s] for name, s in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def from_profiler(prof, window_name: str) -> Trace:
    """A ``Trace`` of a finished ``torch.profiler.profile``: the window is the
    host range recorded under ``window_name``; device events are kernels,
    copies and memsets (not the device-side copies of the host's annotated
    ranges); host events are the CPU operations of the window's thread,
    with their nesting depth."""
    import torch

    events = prof.events()
    mark = next((e for e in events if e.name == window_name
                 and e.device_type != torch.autograd.DeviceType.CUDA), None)
    if mark is None:
        raise ValueError(f"no range {window_name!r} in the trace")
    dev, host = [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False) and not e.name.startswith("benchmark."):
                dev.append((e.name, start, end))
        elif e.thread == mark.thread:
            depth, p = 0, e.cpu_parent
            while p is not None:
                depth, p = depth + 1, p.cpu_parent
            host.append((e.name, start, end, depth))
    return Trace(dev, host, (mark.time_range.start, mark.time_range.end))
