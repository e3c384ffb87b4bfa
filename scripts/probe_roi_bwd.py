#!/usr/bin/env python3
"""K2b and K6b (the RoIAlign backward kernels) on one card: device time of
the kernel alone (torch.profiler, the kernel's own duration, median of 20
launches), at the train shapes of ``chip_smoke.py`` and with parts of the
work taken away, to show what the time is spent on:

    python3 scripts/probe_roi_bwd.py

  * K2b at dOut 8 x 128 x 7x7x1024 -> dF 8 x 38x64x1024, bf16;
  * K6b at dOut 8 x 128 x 7x7x256 -> dF P2-P5 of 608x1024, bf16;
  each as ``chip_smoke.py`` runs it, then with every roi on a level outside
  [0, L) (the roi tests and the zero stores, K6b), with no roi at all (the
  stores alone), with every roi a padding roi, and under the plans of
  ``PLANS`` (tile, channel chunk, threads, kept rois a round, staged bins).
Prints ptxas's registers and spills of the kernel, then one line a case,
with the card's name and power limit.
"""

import os
import statistics
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from frcnn_tpu_torch.ops.cuda import roi_align_kernel as rk  # noqa: E402


def device_ms(fn, n=20):
    """Median duration on the card of the RoIAlign backward kernel over n
    calls of fn (torch.profiler's kernel intervals)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and "roi_align_bwd" in e.name]
    if len(times) < n // 2:               # the profiler may drop an interval at its edges
        raise AssertionError(f"{len(times)} backward kernels in {n} calls")
    return statistics.median(times)


def inputs(dev, c, seed):
    rng = np.random.RandomState(seed)
    b, r = cs.TRAIN_B, 128
    rois = cs.random_boxes(rng, b, r, size=1000.0)
    rois[:, :10] = rng.uniform(-400, 1400, (b, 10, 4))
    rois[:, 10:15, 2:] = rois[:, 10:15, :2]
    rois[:, 15:20] = 0.0
    g = torch.from_numpy(rng.randn(b, r, 7, 7, c).astype(np.float32)).to(dev, torch.bfloat16)
    levels = torch.from_numpy(rng.randint(0, 4, (b, r)).astype(np.int32)).to(dev)
    return torch.from_numpy(rois).to(dev), g, levels


# (tile rows, tile columns, chunk, threads, kept rois a round, staged bins)
PLANS = ((8, 8, 128, 256, 8, 184), (8, 8, 128, 256, 8, 56), (8, 8, 128, 256, 16, 150),
         (8, 8, 64, 256, 8, 184), (8, 8, 64, 256, 8, 368), (16, 8, 64, 256, 8, 184),
         (4, 8, 128, 128, 8, 184), (8, 8, 128, 256, 4, 184))


def plans(c):
    for th, tw, chunk, threads, batch, bins in PLANS:
        plan = rk.roi_bwd_plan(c, 2, tile=(th, tw), chunk=chunk, threads=threads, batch=batch,
                               stage_bins=bins)
        yield (f"{th}x{tw}/{plan['chunk']} {threads} threads, {batch} rois, {bins} bins, "
               f"{plan['smem_bytes']} B"), plan


def main():
    dev = torch.device("cuda", 0)
    print(f"card: {cs.card_line()}; torch {torch.__version__}", flush=True)
    from frcnn_tpu_torch.ops.cuda import build

    build.library()
    lines = build.BUILD_LOG.splitlines()
    for i, line in enumerate(lines):
        if "roi_align_bwd_tile" in line and "Compiling" in line:
            print(line.split("for")[0].strip()[-70:], "|", " ".join(
                x.strip() for x in lines[i + 1:i + 4] if "registers" in x or "spill" in x))
    hws, strides = cs.FPN_TRAIN_LEVELS, cs.FPN_STRIDES
    rois, g, _ = inputs(dev, 1024, 7)
    hw = cs.TRAIN_FEAT
    k2b = {"as run": (g, rois), "padding rois only": (g, torch.zeros_like(rois)),
           "no roi": (g[:, :0].contiguous(), rois[:, :0].contiguous())}
    for name, (gg, rr) in k2b.items():
        ms = device_ms(lambda: rk.roi_align_backward(gg, rr, hw))
        print(f"K2b {name}: {ms:.4f} ms", flush=True)
    for name, plan in plans(1024):
        ms = device_ms(lambda: rk.roi_align_backward(g, rois, hw, plan=plan))
        print(f"K2b plan {name}: {ms:.4f} ms", flush=True)
    rois, g, levels = inputs(dev, 256, 12)
    k6b = {"as run": (g, rois, levels), "every level outside [0, 4)": (g, rois, levels * 0 - 1),
           "every roi on P2": (g, rois, levels * 0), "every roi on P5": (g, rois, levels * 0 + 3),
           "no roi": (g[:, :0].contiguous(), rois[:, :0].contiguous(),
                      levels[:, :0].contiguous())}
    for name, (gg, rr, ll) in k6b.items():
        ms = device_ms(lambda: rk.roi_align_multilevel_backward(gg, rr, ll, hws, strides))
        print(f"K6b {name}: {ms:.4f} ms", flush=True)
    for name, plan in plans(256):
        ms = device_ms(lambda: rk.roi_align_multilevel_backward(g, rois, levels, hws, strides,
                                                                plan=plan))
        print(f"K6b plan {name}: {ms:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
