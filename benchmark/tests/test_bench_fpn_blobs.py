"""The cell ``res50_fpn_voc.serve_blobs`` on the CPU: its tiny form against
the reference (the port's f32 path reads nought; its bf16 path lies within
the cell's limits), K6's bound at the served shape worked by hand, and the
two K6 readers (``serve.roi_align_ml_ms``, ``k6_roofline.serve``) on
synthetic traces, in microseconds."""

import json
import time
from types import SimpleNamespace

import pytest

from benchmark.harness.check import judge
from benchmark.harness.k6_roofline import k6_bound_s, k6_shape
from benchmark.harness.main import reader, run_cell
from benchmark.harness.trace import Trace
from benchmark.tests.tiny import ROOT, tiny_cell

CELL = "res50_fpn_voc.serve_blobs"


def _readings(dtype: str, seed: int, tmp_path):
    cell = tiny_cell(CELL)
    cell.config["cfg"]["DEVICE.DTYPE"] = dtype
    limits, cell.limits = cell.limits, {}
    lines = []
    run_cell(cell, seed, 0.5, False, "cpu", time.perf_counter(), workdir=str(tmp_path),
             log=lambda m: lines.append(m) if m.startswith("readings") else None)
    return json.loads(lines[-1][len("readings "):]), limits


def test_the_ports_f32_path_reads_nought(tmp_path):
    r, _ = _readings("float32", 2**31 + 5, tmp_path)
    assert r["detections"] > 0
    assert r["unmatched"] == 0 and r["score_gap"] == 0
    assert r["box_gap"] == 0 and r["box_gap_part"] == 0 and r["box_gap_worst"] == 0


def test_the_ports_bf16_path_is_within_the_cells_limits(tmp_path):
    r, limits = _readings("bfloat16", 2**31 + 77, tmp_path)
    assert set(limits) == {"box_gap", "box_gap_part"}
    correct, checks = judge(r, limits)
    assert r["detections"] > 0 and correct, checks


def test_k6_bound_at_the_served_shape_by_hand():
    assert k6_shape(ROOT, "k6_roofline.serve") == (1000, 7, 2, 256, 2)
    # 8 images x 1000 rois: 7x7x256 bf16 written, 4 f32 read, a roi
    n_bytes = 8000 * (49 * 256 * 2 + 16)                 # 200.832 MB
    ops = 8000 * 2 * 4 * 2 * 2 * 49 * 256                # 3.21 GFLOP
    assert n_bytes / 3.35e12 > ops / 67e12               # bound by bytes
    assert k6_bound_s(8, 1000, 7, 2, 256, 2) == pytest.approx(n_bytes / 3.35e12)
    assert k6_bound_s(8, 1000, 7, 2, 256, 2) == pytest.approx(59.95e-6, rel=1e-3)
    # f32 output at one roi of 1024 channels and 4x4 samples: bound by operations
    assert k6_bound_s(1, 1, 7, 4, 1024, 4) == pytest.approx(2 * 4 * 16 * 49 * 1024 / 67e12)


def test_k6_shape_needs_one_cell():
    assert k6_shape(ROOT, "serve.mfu") is None            # two cells listed
    assert k6_shape(ROOT, "no.such_metric") is None


K6 = ("void (anonymous namespace)::roi_align_ml_fwd_kernel<__nv_bfloat16, 2>"
      "(Levels, float const*, int const*, int, int, int, int, __nv_bfloat16*)")
HOST = [("benchmark.window", 0, 2000, 0),
        ("frcnn.serve.detect_blobs", 10, 900, 1), ("frcnn.serve.detect_blobs", 1000, 1900, 1)]
# two requests, one batch of 8 at 800x1344 each; K6 took 300 and 200 us
DEVICE = [("sm90_xmma_fprop_implicit_gemm", 20, 320), (K6, 320, 620),
          ("void (anonymous namespace)::roi_align_fwd_kernel<float, 2>", 620, 700),
          ("void (anonymous namespace)::roi_align_bwd_tile_kernel<float>", 700, 720),
          ("fused_bottleneck_kernel", 1020, 1600), (K6, 1600, 1800)]
BATCHES = [(8, (800, 1344)), (8, (800, 1344))]


def _read(name, host=HOST, device=DEVICE, platform="gpu", batches=BATCHES):
    ctx = SimpleNamespace(platform=platform, trace=Trace(device, host, (0, 2000)),
                          batches=batches)
    return reader(ROOT, name)(ctx)


def test_k6_device_time_per_request_and_roofline_share():
    assert _read("serve.roi_align_ml_ms") == pytest.approx((300 + 200) / 2 / 1e3)
    bound = 2 * k6_bound_s(8, 1000, 7, 2, 256, 2)
    assert _read("k6_roofline.serve") == pytest.approx(100 * bound / 500e-6)


@pytest.mark.parametrize("name", ["serve.roi_align_ml_ms", "k6_roofline.serve"])
@pytest.mark.parametrize("case", ["cpu", "no_launch", "no_request_or_batch"])
def test_nothing_to_read(name, case):
    if case == "cpu":
        assert _read(name, platform="cpu") is None
    elif case == "no_launch":
        assert _read(name, device=[e for e in DEVICE if e[0] != K6]) is None
    else:
        assert _read(name, host=HOST[:1], batches=[]) is None


def test_the_roofline_needs_one_launch_a_batch():
    assert _read("k6_roofline.serve", device=DEVICE + [(K6, 1850, 1900)]) is None
    assert _read("k6_roofline.serve", batches=BATCHES[:1]) is None
    assert _read("serve.roi_align_ml_ms", batches=BATCHES[:1]) is not None
