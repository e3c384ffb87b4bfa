"""Probe of the K1 kernel (chunked greedy NMS, ``csrc/nms_kernel.cu``) and of
the K2 kernel (staged RoIAlign forward, ``csrc/roi_align_kernel.cu``) on a
CUDA card: not part of the port's main path or of ``chip_smoke.py``.

    python3 scripts/probe_nms_roi_plans.py

1. K1: keep masks bit-equal to ``nms_mask_reference`` (capped: AND cumsum <=
   cap) over shapes (N below 64, no multiple of 64, B = 1, a problem with no
   valid box, duplicates, an integer grid, walks that never reach their cap),
   caps (1, inside the first chunk, never reached, none) and every cluster
   size and thread count the launcher takes.
2. K1 timed at the five main-path shapes on ``chip_smoke.py``'s boxes and on
   boxes that suppress each other heavily (the walk crosses every chunk), for
   cluster sizes 1-16 and 256-1024 threads beside ``nms_plan``'s own choice:
   how the plan's rule was chosen.
3. K2 against ``roi_align_reference`` at C = 1024, 256, 96, 33 and 1023, f32
   and bf16, with rois that are padding, degenerate, inverted, outside, one
   pixel wide and wider than 28 columns; then timed at the serving and train
   shapes over channel chunks, threads and staging bytes.
Exits non-zero on any mismatch.
"""
import os
import statistics
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import random_boxes, roi_tolerance  # noqa: E402
from frcnn_tpu_torch.ops.cuda import build  # noqa: E402
from frcnn_tpu_torch.ops.cuda import nms_kernel as nk  # noqa: E402
from frcnn_tpu_torch.ops.cuda import roi_align_kernel as rk  # noqa: E402

dev = torch.device("cuda", 0)
build.library()
show = False
for line in build.BUILD_LOG.splitlines():
    if "Compiling entry function" in line:
        show = any(name in line for name in ("nms_chunk", "roi_align_fwd", "roi_align_ml_fwd"))
        if show:
            print(line.split("entry function")[1].strip()[:150])
    elif show and ("registers" in line or "spill" in line):
        print("   ", line.strip())


def cuda_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(a.elapsed_time(e))
    return statistics.median(ts)


rng = np.random.RandomState(0)
bad = 0

# ---- 1. K1 correctness ----------------------------------------------------
cases = []
for b, n in ((3, 700), (2, 50), (5, 64), (1, 6000), (4, 2000), (2, 4741)):
    boxes = random_boxes(rng, b, n)
    boxes[0, 1::3] = boxes[0, 0:-1:3][:len(boxes[0, 1::3])]          # duplicates
    if b > 1:
        boxes[1] = np.round(boxes[1] / 8) * 8                        # integer grid
    valid = rng.uniform(0, 1, (b, n)) > 0.15
    if b > 2:
        valid[2] = False                                             # no valid box
    cases.append((f"random ({b},{n})", boxes, valid))
# heavy suppression: few distinct boxes, the walk never reaches a cap of 300
boxes = random_boxes(rng, 2, 3000)
boxes = np.tile(boxes[:, :40], (1, 75, 1))
cases.append(("40 distinct (2,3000)", boxes, np.ones((2, 3000), bool)))

n_cases = 0
for name, boxes, valid in cases:
    b, n = boxes.shape[:2]
    bx, vd = torch.from_numpy(boxes).to(dev), torch.from_numpy(valid).to(dev)
    for thresh in (0.3, 0.7):
        want = nk.nms_mask_reference(bx, thresh, vd)
        for cap in (None, 1, 7, 300, n + 5):
            w = want if cap is None else want & (torch.cumsum(want, 1) <= cap)
            for cluster in (1, 2, 4, 8, 16):
                for threads in (64, 128, 512, 1024):
                    plan = nk.nms_plan(b, n, cap, cluster=cluster, threads=threads)
                    got = nk.nms_mask_batched(bx, thresh, vd, max_keep=cap, plan=plan)
                    n_cases += 1
                    if not torch.equal(got, w):
                        bad += 1
                        print(f"K1 MISMATCH {name} t={thresh} cap={cap} {plan}: "
                              f"{(got != w).sum().item()} bits")
            got = nk.nms_mask_batched(bx, thresh, vd, max_keep=cap)
            n_cases += 1
            if not torch.equal(got, w):
                bad += 1
                print(f"K1 MISMATCH {name} t={thresh} cap={cap} own plan")
torch.cuda.synchronize()
print(f"K1: {n_cases} cases, {bad} mismatches")

# ---- 2. K1 timing ----------------------------------------------------------
shapes = (("C4 serve", 8, 6000, 300, 40, 800.0), ("per class", 168, 300, 100, 40, 800.0),
          ("FPN serve", 8, 4741, 300, 60, 1216.0), ("C4 train", 8, 12000, 2000, 120, 1000.0),
          ("FPN train", 8, 8480, 2000, 120, 1000.0), ("one problem", 1, 6000, 300, 40, 800.0))
for name, b, n, cap, clusters, size in shapes:
    thresh = 0.3 if name == "per class" else 0.7
    light = random_boxes(rng, b, n, size=size, clusters=clusters)
    heavy = np.tile(random_boxes(rng, b, max(cap // 3, 8), size=size),
                    (1, n // max(cap // 3, 8) + 1, 1))[:, :n]
    heavy = heavy + rng.uniform(-0.5, 0.5, heavy.shape).astype(np.float32)
    for kind, boxes in (("smoke boxes", light), ("heavy suppression", heavy)):
        bx = torch.from_numpy(np.ascontiguousarray(boxes)).to(dev)
        vd = torch.ones((b, n), dtype=torch.bool, device=dev)
        keep = nk.nms_mask_batched(bx, thresh, vd, max_keep=cap)
        want = nk.nms_mask_reference(bx, thresh, vd)
        want &= torch.cumsum(want, 1) <= cap
        if not torch.equal(keep, want):
            bad += 1
            print(f"K1 MISMATCH timing {name} {kind}")
        last = (keep.long() * torch.arange(n, device=dev)).max(1).values.float().mean().item()
        own = nk.nms_plan(b, n, cap)
        line = (f"K1 {name} ({b},{n}) cap {cap}, {kind}: kept {keep.sum(1).float().mean():.0f}, "
                f"last kept at {last:.0f}; plan {own['cluster']}x{own['threads']} "
                f"{cuda_ms(lambda: nk.nms_mask_batched(bx, thresh, vd, max_keep=cap)):.4f} ms;")
        for cluster in (1, 2, 4, 8, 16):
            if b * cluster > 264:
                continue
            for threads in (256, 512, 1024):
                plan = nk.nms_plan(b, n, cap, cluster=cluster, threads=threads)
                ms = cuda_ms(lambda: nk.nms_mask_batched(bx, thresh, vd, max_keep=cap, plan=plan))
                line += f" {cluster}x{threads} {ms:.4f}"
        print(line)

# ---- 3. K2 -------------------------------------------------------------------
def rois_for(b, r, size):
    rois = random_boxes(rng, b, r, size=size)
    rois[:, :10] = rng.uniform(-400, size + 400, (b, 10, 4))       # partly / wholly outside
    rois[:, 10:14, 2:] = rois[:, 10:14, :2]                        # zero size
    rois[:, 14:18] = 0.0                                           # padding rois
    rois[:, 18:22, 2:] = rois[:, 18:22, :2] - 5.0                  # inverted corners
    rois[:, 22:26] = [0.0, 0.0, size - 1.0, size / 2]              # wider than 28 columns
    rois[:, 26:30, 2:] = rois[:, 26:30, :2] + 1.0                  # one pixel
    return rois


for c in (1024, 256, 96, 33, 1023):
    b, h, w, r, size = 2, 50, 76, 64, 1216.0
    feat32 = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32)).to(dev)
    rois = torch.from_numpy(rois_for(b, r, size)).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        feat = feat32.to(dtype)
        want = rk.roi_align_reference(feat, rois)
        scale = want.float().abs().max().item()
        tol, rule = roi_tolerance(dtype, scale)
        plans = [None]
        base = rk.roi_plan(c, feat.element_size())
        for chunk in (base["vec"], 2 * base["vec"], c):
            for smem in (base["smem_bytes"], 16 * 1024, 100 * 1024):
                for threads in (32, 128, 512):
                    plans.append({**base, "chunk": chunk, "smem_bytes": smem,
                                  "threads": threads})
        for plan in plans:
            got = rk.roi_align_forward(feat, rois, plan=plan)
            err = (got.float() - want.float()).abs().max().item()
            if not err <= tol:
                bad += 1
                print(f"K2 MISMATCH C={c} {dtype} plan {plan}: err {err} > {tol}")
    print(f"K2 C={c}: {len(plans)} plans x 2 dtypes checked against the twin")

for name, b, h, w, c, r, size in (("serving", 8, 50, 76, 1024, 300, 1216.0),
                                  ("train", 8, 38, 64, 1024, 128, 1024.0)):
    feat = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32)).to(dev, torch.bfloat16)
    rois = torch.from_numpy(random_boxes(rng, b, r, size=size)).to(dev)
    staged = rk.staged_pixels(rois, h, w).sum().item()
    base = rk.roi_plan(c, 2)
    line = (f"K2 {name} bf16: staged pixels / (16 x bins) = {staged / (16 * 49 * b * r):.4f}; "
            f"plan {base} {cuda_ms(lambda: rk.roi_align_forward(feat, rois)):.4f} ms;")
    for chunk in (128, 256, 512, 1024):
        for threads in (64, 128, 256):
            for smem in (16 * 1024, 40 * 1024, 72 * 1024):
                plan = {**base, "chunk": chunk, "threads": threads, "smem_bytes": smem}
                ms = cuda_ms(lambda: rk.roi_align_forward(feat, rois, plan=plan))
                line += f" c{chunk}/t{threads}/s{smem // 1024} {ms:.4f}"
    print(line)
print("bad", bad)
sys.exit(1 if bad else 0)
