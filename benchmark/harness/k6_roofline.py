"""K6 (the multilevel RoIAlign forward, ``roi_align_ml_fwd_kernel``): the
least time its launches could take on the chip, and its roofline share in a
traced window.

The bound reads the same work whatever implements the pooling: each roi's
pooled (p, p, C) block written once at the compute dtype, and its four f32
coordinates read once; operations, the bilinear multiply-adds, 2 x 4
corners x s² samples x p² bins x C a roi, at the f32 rate (the kernel
interpolates in f32 off the tensor cores).  The maps are not counted as
read once: a roi covers a few pixels of its level, and a kernel that reads
only those would beat a bound that counts the whole of P2-P5.  Peaks:
``roofline.py``'s HBM rate, and 67 TFLOP/s, one H100 SXM's dense f32 rate
outside the tensor cores (NVIDIA's data sheet).
"""

from __future__ import annotations

import json
import os

from benchmark.harness.main import load_cell
from benchmark.harness.program import settings
from benchmark.harness.roofline import bound_s

KERNEL = "roi_align_ml_fwd_kernel"
F32_FLOPS = 67e12
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def k6_bound_s(batch: int, rois: int, pool: int, sampling: int, channels: int,
               out_bytes: int) -> float:
    """The bound of one launch over ``batch`` images of ``rois`` rois each."""
    n = batch * rois
    n_bytes = n * (pool * pool * channels * out_bytes + 4 * 4)
    ops = n * 2 * 4 * sampling * sampling * pool * pool * channels
    return bound_s(n_bytes, ops, peak=F32_FLOPS)


def k6_shape(root: str, metric: str):
    """(rois an image, pool, sampling ratio, channels, output bytes) from
    the configuration of the one cell that ``metric``'s entry in
    ``BENCHMARK.json`` lists; None where it lists none or several, or the
    configuration leaves one of them out."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        entry = next((m for m in json.load(f)["per_layer"] if m["name"] == metric), {})
    cells = entry.get("workloads", [])
    if len(cells) != 1:
        return None
    cell = load_cell(root, cells[0])
    c = settings(cell.config, cell.traffic, 0)
    keys = ("TEST.RPN_POST_NMS_TOP_N", "POOLING_SIZE", "DEVICE.ROI_SAMPLING_RATIO",
            "FPN.OUT_CHANNELS")
    if any(k not in c for k in keys) or c.get("DEVICE.DTYPE") not in DTYPE_BYTES:
        return None
    return tuple(int(c[k]) for k in keys) + (DTYPE_BYTES[c["DEVICE.DTYPE"]],)


def k6_roofline(ctx, root: str, metric: str):
    """Σ K6's bound over the traced window's batches / Σ its device time,
    in %; None off the card, or unless the trace holds exactly one K6
    launch a batch, or without the shapes (``k6_shape``)."""
    if ctx.platform != "gpu" or not ctx.batches:
        return None
    seconds, launches = ctx.trace.device_seconds(lambda name: KERNEL in name)
    if seconds <= 0 or launches != len(ctx.batches):
        return None
    shape = k6_shape(root, metric)
    if shape is None:
        return None
    return 100.0 * sum(k6_bound_s(b, *shape) for b, _ in ctx.batches) / seconds
