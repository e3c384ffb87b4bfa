"""The reader of the BN epilogue's device time
(``benchmark/metrics/serve.bn_epilogue_ms.py``) on a synthetic ``Trace``
of interval lists, in microseconds."""

from types import SimpleNamespace

import pytest

from benchmark.harness.main import reader
from benchmark.harness.trace import Trace
from benchmark.tests.tiny import ROOT

NAME = "serve.bn_epilogue_ms"
KERNEL = "void (anonymous namespace)::bn_epilogue_kernel<1, true>(uint4 const*, long long)"
HOST = [("benchmark.window", 0, 1000, 0),
        ("frcnn.serve.detect_blobs", 10, 400, 1), ("frcnn.serve.detect_blobs", 500, 900, 1)]
# two requests; three epilogue launches of 30, 50 and 20 us among other kernels
DEVICE = [("sm90_xmma_fprop_implicit_gemm", 20, 120), (KERNEL, 120, 150),
          ("void (anonymous namespace)::bn_epilogue_kernel<2, true>(uint4 const*)", 150, 200),
          ("fused_bottleneck_kernel", 520, 600), (KERNEL, 600, 620)]


def _read(host=HOST, device=DEVICE, platform="gpu"):
    ctx = SimpleNamespace(platform=platform, trace=Trace(device, host, (0, 1000)))
    return reader(ROOT, NAME)(ctx)


def test_epilogue_device_time_per_request():
    assert _read() == pytest.approx((30 + 50 + 20) / 2 / 1e3)


@pytest.mark.parametrize("case", ["cpu", "no_request", "no_launch"])
def test_nothing_to_read(case):
    if case == "cpu":
        assert _read(platform="cpu") is None
    elif case == "no_request":
        assert _read(host=HOST[:1]) is None
    else:
        assert _read(device=[e for e in DEVICE if "bn_epilogue" not in e[0]]) is None
