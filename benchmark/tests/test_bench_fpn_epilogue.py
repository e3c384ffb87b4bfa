"""The reader of the FPN epilogue's device time
(``benchmark/metrics/serve.fpn_epilogue_ms.py``) on a synthetic ``Trace``
of interval lists, in microseconds."""

from types import SimpleNamespace

import pytest

from benchmark.harness.main import reader
from benchmark.harness.trace import Trace
from benchmark.tests.tiny import ROOT

NAME = "serve.fpn_epilogue_ms"
KERNEL = "void (anonymous namespace)::fpn_epilogue_kernel<2>(uint4 const*, long long)"
HOST = [("benchmark.window", 0, 1000, 0),
        ("frcnn.serve.detect_blobs", 10, 400, 1), ("frcnn.serve.detect_blobs", 500, 900, 1)]
# two requests; four FPN epilogue launches of 40, 10, 25 and 5 us among other
# kernels, the BN epilogue's among them
DEVICE = [("sm90_xmma_fprop_implicit_gemm", 20, 120), (KERNEL, 120, 160),
          ("void (anonymous namespace)::fpn_epilogue_kernel<0>(uint4 const*)", 160, 170),
          ("void (anonymous namespace)::bn_epilogue_kernel<1, true>(uint4 const*)", 170, 230),
          ("void (anonymous namespace)::fpn_epilogue_kernel<1>(uint4 const*)", 520, 545),
          (KERNEL, 600, 605)]


def _read(host=HOST, device=DEVICE, platform="gpu"):
    ctx = SimpleNamespace(platform=platform, trace=Trace(device, host, (0, 1000)))
    return reader(ROOT, NAME)(ctx)


def test_fpn_epilogue_device_time_per_request():
    assert _read() == pytest.approx((40 + 10 + 25 + 5) / 2 / 1e3)


@pytest.mark.parametrize("case", ["cpu", "no_request", "no_launch"])
def test_nothing_to_read(case):
    if case == "cpu":
        assert _read(platform="cpu") is None
    elif case == "no_request":
        assert _read(host=HOST[:1]) is None
    else:
        assert _read(device=[e for e in DEVICE if "fpn_epilogue" not in e[0]]) is None
