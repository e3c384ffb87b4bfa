"""The readers of the program's own spans (``benchmark/harness/spans.py``
through ``benchmark/metrics/serve.{program_host_ms,copy_in_ms,program_idle_ms}.py``)
on a synthetic ``Trace`` of interval lists, in microseconds."""

from types import SimpleNamespace

import pytest

from benchmark.harness.main import reader
from benchmark.harness.readers import idle_share
from benchmark.harness.trace import Trace
from benchmark.tests.tiny import ROOT

NAMES = ("serve.program_host_ms", "serve.copy_in_ms", "serve.program_idle_ms")

# two requests, 10-30 and 50-80, each with a copy-in inside; the client's
# own time around them is under the window's range only
HOST = [("benchmark.window", 0, 100, 0),
        ("frcnn.serve.detect_blobs", 10, 30, 1), ("frcnn.graphs.lookup", 10, 12, 2),
        ("frcnn.graphs.copy_in", 12, 20, 2), ("frcnn.graphs.replay", 20, 30, 2),
        ("frcnn.serve.detect_blobs", 50, 80, 1), ("frcnn.graphs.copy_in", 52, 56, 2),
        ("aten::copy_", 52, 56, 3)]
# idle gaps: 15-25 (midpoint in the first request), 35-45 (the client's),
# 55-58 (in the second), 78-90 (starts in the second; its midpoint is the
# client's)
DEVICE = [("k", 0, 15), ("k", 25, 35), ("k", 45, 55), ("k", 58, 78), ("k", 90, 100)]


def _ctx(host=HOST, device=DEVICE, platform="gpu"):
    return SimpleNamespace(platform=platform, trace=Trace(device, host, (0, 100)))


def _read(name, ctx):
    return reader(ROOT, name)(ctx)


def test_host_spans_are_per_request_means():
    ctx = _ctx()
    assert _read("serve.program_host_ms", ctx) == pytest.approx((20 + 30) / 2 / 1e3)
    assert _read("serve.copy_in_ms", ctx) == pytest.approx((8 + 4) / 2 / 1e3)


def test_an_idle_gap_counts_only_when_its_midpoint_is_inside_a_program_span():
    ctx = _ctx()
    assert _read("serve.program_idle_ms", ctx) == pytest.approx((10 + 3) / 2 / 1e3)
    # never more than the window's idle time a request
    total_idle_us = idle_share(ctx) / 100 * (ctx.trace.window[1] - ctx.trace.window[0])
    assert 2 * _read("serve.program_idle_ms", ctx) * 1e3 <= total_idle_us
    # a span nested in another is not counted twice
    nested = HOST + [("frcnn.graphs.replay", 14, 26, 3)]
    assert _read("serve.program_idle_ms", _ctx(nested)) == pytest.approx((10 + 3) / 2 / 1e3)


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read_without_a_request_span(name):
    without = [e for e in HOST if e[0] != "frcnn.serve.detect_blobs"]
    assert _read(name, _ctx(without)) is None
    assert _read(name, _ctx([HOST[0]])) is None


def test_no_device_idle_read_without_a_card():
    assert _read("serve.program_idle_ms", _ctx(platform="cpu")) is None
