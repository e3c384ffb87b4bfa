"""The arithmetic of the per-layer metrics that read the program's own spans:
the ``frcnn.*`` ranges that ``frcnn_tpu_torch/utils/trace.py`` records
under the traced window's profiler, on the window thread (``Trace.host``:
name, start_us, end_us, depth), beside the device's intervals.  Each
number is per request: per ``frcnn.serve.detect_blobs`` span.  A reader
returns None where the trace holds no such span (a program without the
spans, or another entry)."""

from __future__ import annotations

import bisect

from benchmark.harness.trace import gaps

PREFIX = "frcnn."
REQUEST = "frcnn.serve.detect_blobs"


def _intervals(trace, match):
    return [(a, b) for name, a, b, _ in trace.host if match(name)]


def _requests(trace) -> int:
    return len(_intervals(trace, lambda name: name == REQUEST))


def span_ms_per_request(ctx, name: str):
    """Host milliseconds of the spans ``name`` summed over the traced
    window / its requests; None with no request or no such span."""
    requests = _requests(ctx.trace)
    spans = _intervals(ctx.trace, lambda n: n == name)
    if requests == 0 or not spans:
        return None
    return sum(b - a for a, b in spans) / 1e3 / requests


def _merged(intervals):
    """The union of (start, end) intervals as sorted disjoint intervals:
    the outermost spans."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def program_idle_ms(ctx):
    """The device's idle milliseconds a request inside the program: the
    idle gaps of the traced window (as ``serve.device_idle_share`` takes
    them) whose midpoint lies inside an outermost ``frcnn.`` span, summed
    and divided by the requests.  The rest of the idle time is the
    client's own."""
    if ctx.platform != "gpu":
        return None
    trace = ctx.trace
    requests = _requests(trace)
    if requests == 0:
        return None
    outer = _merged(_intervals(trace, lambda name: name.startswith(PREFIX)))
    starts = [a for a, _ in outer]
    idle = 0.0
    for a, b in gaps(trace._clipped(), *trace.window):
        i = bisect.bisect_right(starts, (a + b) / 2) - 1
        if i >= 0 and (a + b) / 2 <= outer[i][1]:
            idle += b - a
    return idle / 1e3 / requests
