#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``frcnn_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --only kernels   # stop after the kernel phases (1-9)
    python3 chip_smoke.py --profile        # and a stage breakdown of the train step (14)

Phases, each of which raises on failure (the script then exits non-zero):
  0. the card: name and power limit from nvidia-smi, torch/CUDA versions;
  1. build the hand-written kernels from frcnn_tpu_torch/csrc with nvcc;
  2. K1 (batched NMS) against its plain twin: nms_fixed_batched indices and
     valid masks equal, uncapped keep masks bit-equal;
  3. K2 (RoIAlign forward) against its twin, f32 and bf16, at the serving
     shape (8 x 300 rois, 50x76x1024) and the train shape (8 x 128 rois,
     38x64x1024);
  4. K3 (fused bottleneck) against its twin at the layer1/layer2 shapes of
     the serving path (800x1216) and of the train path (608x1024);
  5. K1 at the train shape (8 x 12000, t=0.7, cap 2000);
  6. K2b (RoIAlign backward) against its twin, f32 and bf16, at the train
     shape (8 x 128 rois, 38x64x1024);
  7. K4 (anchor-overlap stats) bit-equal to its twin at the train shape
     (21888 anchors, 8 x 64 padded gt);
  8. K5 (threshold top-k) indices equal to its twin at (8, 21888), k 128
     and 256, and on rows of ties, NaN and +-inf, and k = S;
  9. (with ``--only kernels``: print the kernel results and the card line
     and stop; a partial run prints no ok line);
 10. the serving path: res50 C4, 21 classes, seeded random weights, bf16
     trunk, one 800x1216 bucket; 3 requests of 8 images through
     ``Detector``, with the kernels' launch counts, then the steady-state
     batch time;
 11. one image through ``detect`` in f32 on the card and on a CPU copy of
     the same model; detections matched one to one;
 12. the train path: ``SolverWrapper.train_model`` for 5 steps of batch 8
     at 608x1024, bf16 trunk, over a synthetic in-memory roidb; launch
     counts per step, finite losses, frozen parameters bit-unchanged and
     trainable ones changed; then the steady-state step time;
 13. one f32 train step on the card and on a CPU copy with the same weights
     and draws: losses and parameter updates matched;
 14. (with ``--profile``) CUDA events around each stage of a steady-state
     train step and torch.profiler over 3 steps: stage times, the device's
     idle share and the top kernels, also in chiprun_out/profile_train.json.
Then one JSON line of per-kernel results, the card line, and, last, the
JSON ok line.  TF32 is off for convolutions and matmuls throughout, so f32
comparisons are f32.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median device time of fn() in ms, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bf16_ulp(scale: float) -> float:
    """One bf16 ulp (8 significant bits) at magnitude ``scale``."""
    return 2.0 ** (np.floor(np.log2(max(scale, 1e-30))) - 7)


def random_boxes(rng, b, n, size=800.0, clusters=40):
    """Boxes drawn around a few cluster centres, so that many overlap."""
    centres = rng.uniform(0, size, (b, clusters, 2))
    pick = rng.randint(0, clusters, (b, n))
    c = np.take_along_axis(centres, pick[..., None], axis=1) + rng.normal(0, 12, (b, n, 2))
    wh = rng.uniform(8, 160, (b, n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], axis=-1)
    return np.clip(boxes, 0, size - 1).astype(np.float32)


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------


def check_nms(dev):
    from frcnn_tpu_torch.ops.cuda.nms_kernel import nms_mask_batched, nms_mask_reference
    from frcnn_tpu_torch.ops.nms import nms_fixed_batched

    rng = np.random.RandomState(0)
    results = {}
    errs = []  # max |kernel - twin| of the returned indices

    def fixed(name, boxes, scores, valid, thresh, cap, presorted):
        args = (torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev),
                thresh, cap)
        kw = dict(valid=torch.from_numpy(valid).to(dev), presorted=presorted)
        ki, kv = nms_fixed_batched(*args, use_kernels=True, **kw)
        ti, tv = nms_fixed_batched(*args, use_kernels=False, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(ki, ti) and torch.equal(kv, tv)):
            raise AssertionError(f"K1 {name}: nms_fixed_batched idx/valid differ from the twin")
        errs.append((ki.long() - ti.long()).abs().max().item())
        log(f"K1 {name}: idx/valid equal to the twin, kept per problem "
            f"{kv.sum(1).float().mean().item():.1f} (max {kv.sum(1).max().item()})")
        return args, kw

    # proposal shape: presorted, valid entries first, cap 300
    b, n = 8, 6000
    boxes = random_boxes(rng, b, n)
    scores = -np.sort(-rng.uniform(0, 1, (b, n)), axis=1).astype(np.float32)
    valid = np.arange(n)[None, :] < rng.randint(4000, n + 1, (b, 1))
    valid[3] = False                                   # a problem with no valid box
    prop_args, prop_kw = fixed("proposals (8, 6000, t=0.7, cap 300)", boxes, scores,
                               valid, 0.7, 300, True)
    # per-class shape: unsorted scores, score-threshold validity, cap 100
    b, n = 168, 300
    boxes = random_boxes(rng, b, n)
    scores = rng.uniform(0, 1, (b, n)).astype(np.float32)
    valid = scores > 0.2
    valid[::17] = False
    cls_args, cls_kw = fixed("per-class (168, 300, t=0.3, cap 100)", boxes, scores,
                             valid, 0.3, 100, False)

    # uncapped keep masks, bit-equal: duplicates and integer boxes whose IoU
    # lands exactly on the threshold
    b, n = 4, 2000
    boxes = random_boxes(rng, b, n)
    dup = np.arange(1, n, 7)
    boxes[:, dup] = boxes[:, dup - 1]                                  # exact duplicates
    boxes[2] = np.round(boxes[2] / 8) * 8                              # integer grid
    valid = rng.uniform(0, 1, (b, n)) > 0.1
    for thresh in (0.5, 0.7):
        bx = torch.from_numpy(boxes).to(dev)
        vd = torch.from_numpy(valid).to(dev)
        k = nms_mask_batched(bx, thresh, vd)
        t = nms_mask_reference(bx, thresh, vd)
        torch.cuda.synchronize()
        if not torch.equal(k, t):
            raise AssertionError(f"K1 uncapped t={thresh}: keep masks differ "
                                 f"({(k != t).sum().item()} bits)")
        log(f"K1 uncapped (4, 2000, t={thresh}, duplicates + integer grid): "
            f"keep masks bit-equal, {k.sum().item()} kept")

    def mask_args(args, kw, sort):
        bx, sc, thresh, cap = args
        vd = kw["valid"]
        if sort:
            order = torch.argsort(-torch.where(vd, sc, -1e10), dim=1, stable=True)
            bx = torch.take_along_dim(bx, order[..., None], dim=1)
            vd = torch.take_along_dim(vd, order, dim=1)
        return bx.contiguous(), thresh, vd.contiguous(), cap

    timings = {}
    for name, args, kw, sort, iters in (("proposals", prop_args, prop_kw, False, 3),
                                        ("per_class", cls_args, cls_kw, True, 5)):
        bx, thresh, vd, cap = mask_args(args, kw, sort)
        k_ms = cuda_ms(lambda: nms_mask_batched(bx, thresh, vd, max_keep=cap))
        t_ms = cuda_ms(lambda: nms_mask_reference(bx, thresh, vd), iters=iters, warmup=1)
        timings[name] = (k_ms, t_ms)
        log(f"K1 time {name}: kernel {k_ms:.4f} ms, plain twin {t_ms:.4f} ms")
    results["ms"] = sum(v[0] for v in timings.values())
    results["plain_ms"] = sum(v[1] for v in timings.values())
    results["max_abs_err"] = float(max(errs))
    return results


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------


def check_roi_align(dev):
    from frcnn_tpu_torch.ops.cuda.roi_align_kernel import roi_align_forward, roi_align_reference

    rng = np.random.RandomState(1)
    k_total = t_total = 0.0
    worst = 0.0
    # (name, B, H, W, C, rois per image, image size): the serving and train shapes
    for name, b, h, w, c, r, size in (("serving", 8, 50, 76, 1024, 300, 1216.0),
                                      ("train", 8, 38, 64, 1024, 128, 1024.0)):
        feat32 = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32)).to(dev)
        rois = random_boxes(rng, b, r, size=size)
        rois[:, :20] = rng.uniform(-400, size + 400, (b, 20, 4))      # partly / wholly outside
        rois[:, 20:30, 2:] = rois[:, 20:30, :2]                        # degenerate: zero size
        rois[:, 30:40] = 0.0                                           # padding rois
        rois[:, 40:50, 2:] = rois[:, 40:50, :2] - 5.0                  # inverted corners
        rois_t = torch.from_numpy(rois).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            feat = feat32.to(dtype)
            k = roi_align_forward(feat, rois_t)
            t = roi_align_reference(feat, rois_t)
            torch.cuda.synchronize()
            err = (k.float() - t.float()).abs().max().item()
            scale = t.float().abs().max().item()
            if dtype == torch.float32:
                tol, rule = 1e-5 * scale, "1e-5 relative to max|twin|"
            else:
                tol, rule = bf16_ulp(scale), "one bf16 ulp of max|twin|"
            if not err <= tol:
                raise AssertionError(f"K2 {name} {dtype}: max abs err {err} > {tol} ({rule})")
            log(f"K2 {name} {str(dtype)[6:]} ({b} x {h}x{w}x{c}, {r} rois): max abs err "
                f"{err:.3e} <= {tol:.3e} ({rule})")
        worst = max(worst, err)                                        # the bf16 error
        k_ms = cuda_ms(lambda: roi_align_forward(feat, rois_t))
        t_ms = cuda_ms(lambda: roi_align_reference(feat, rois_t), iters=5)
        k_total += k_ms
        t_total += t_ms
        log(f"K2 time {name} bf16: kernel {k_ms:.4f} ms, plain twin {t_ms:.4f} ms")
    return {"ms": k_total, "plain_ms": t_total, "max_abs_err": worst}


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------

# (name, H, W, Cin, mid, projection, launches per serving batch or train step):
# the serving path at 800x1216, the train path at 608x1024
K3_SHAPES = (("layer1 block0 (proj)", 200, 304, 64, 64, True, 1),
             ("layer1 block1-2", 200, 304, 256, 64, False, 2),
             ("layer2 block1-3", 100, 152, 512, 128, False, 3),
             ("mid-128 projection", 100, 152, 256, 128, True, 0),
             ("train layer1 block0 (proj)", 152, 256, 64, 64, True, 1),
             ("train layer1 block1-2", 152, 256, 256, 64, False, 2),
             ("train layer2 block1-3", 76, 128, 512, 128, False, 3))


def check_fused_block(dev):
    from frcnn_tpu_torch.ops.cuda.fused_block import bottleneck_reference, fused_bottleneck

    g = torch.Generator().manual_seed(2)

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=g) * std).to(dev, torch.bfloat16)

    k_total = t_total = 0.0
    worst = 0.0
    for name, h, w, cin, mid, proj, count in K3_SHAPES:
        cout = 4 * mid
        x = torch.relu(rnd(8, h, w, cin))
        w1, b1 = rnd(cin, mid, std=(2 / cin) ** 0.5), rnd(mid, std=0.1)
        w2, b2 = rnd(9 * mid, mid, std=(2 / (9 * mid)) ** 0.5), rnd(mid, std=0.1)
        w3, b3 = rnd(mid, cout, std=(1 / mid) ** 0.5), rnd(cout, std=0.1)
        wds, bds = (rnd(cin, cout, std=(1 / cin) ** 0.5), rnd(cout, std=0.1)) if proj \
            else (None, None)
        args = (x, w1, b1, w2, b2, w3, b3, wds, bds)
        k = fused_bottleneck(*args)
        t = bottleneck_reference(x, w1, b1, w2.reshape(3, 3, mid, mid), b2, w3, b3, wds, bds)
        torch.cuda.synchronize()
        err = (k.float() - t.float()).abs().max().item()
        mean_err = (k.float() - t.float()).abs().mean().item()
        scale = t.float().abs().max().item()
        tol = 4 * bf16_ulp(scale)
        if not (torch.isfinite(k.float()).all() and err <= tol):
            raise AssertionError(f"K3 {name}: max abs err {err} > {tol} (4 bf16 ulps of max|twin|)")
        w2_hwio = w2.reshape(3, 3, mid, mid)
        k_ms = cuda_ms(lambda: fused_bottleneck(*args))
        t_ms = cuda_ms(lambda: bottleneck_reference(x, w1, b1, w2_hwio, b2, w3, b3, wds, bds))
        k_total += count * k_ms
        t_total += count * t_ms
        if count:
            worst = max(worst, err)
        log(f"K3 {name} x (8, {h}, {w}, {cin}) mid {mid}: max abs err {err:.3e} <= {tol:.3e} "
            f"(4 bf16 ulps of max|twin| {scale:.3f}), mean abs err {mean_err:.3e}; "
            f"kernel {k_ms:.4f} ms, plain twin (cuDNN bf16) {t_ms:.4f} ms")
    log(f"K3 time over the 12 main-path launches (6 per serving batch, 6 per train step): "
        f"kernel {k_total:.4f} ms, plain twin {t_total:.4f} ms")
    return {"ms": k_total, "plain_ms": t_total, "max_abs_err": worst}


# ---------------------------------------------------------------------------
# The train path's kernels: K1 at the train shape, K2b, K4, K5
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_H, TRAIN_W = 8, 608, 1024        # batch and bucket of the train path
TRAIN_FEAT = (TRAIN_H // 16, TRAIN_W // 16)      # 38 x 64 C4 features


def check_nms_train(dev):
    from frcnn_tpu_torch.ops.cuda.nms_kernel import nms_mask_batched, nms_mask_reference
    from frcnn_tpu_torch.ops.nms import nms_fixed_batched

    rng = np.random.RandomState(6)
    b, n, cap = TRAIN_B, 12000, 2000
    boxes = torch.from_numpy(random_boxes(rng, b, n, size=1000.0, clusters=120)).to(dev)
    scores = torch.from_numpy(-np.sort(-rng.uniform(0, 1, (b, n)), axis=1)
                              .astype(np.float32)).to(dev)
    valid = torch.from_numpy(np.arange(n)[None, :] < rng.randint(9000, n + 1, (b, 1))).to(dev)
    ki, kv = nms_fixed_batched(boxes, scores, 0.7, cap, valid=valid, presorted=True)
    ti, tv = nms_fixed_batched(boxes, scores, 0.7, cap, valid=valid, presorted=True,
                               use_kernels=False)
    torch.cuda.synchronize()
    if not (torch.equal(ki, ti) and torch.equal(kv, tv)):
        raise AssertionError("K1 train shape: nms_fixed_batched idx/valid differ from the twin")
    k_ms = cuda_ms(lambda: nms_mask_batched(boxes, 0.7, valid, max_keep=cap))
    t_ms = cuda_ms(lambda: nms_mask_reference(boxes, 0.7, valid), iters=3, warmup=1)
    log(f"K1 train shape (8, 12000, t=0.7, cap 2000): idx/valid equal to the twin, kept per "
        f"problem {kv.sum(1).float().mean().item():.1f}; kernel {k_ms:.4f} ms, "
        f"plain twin {t_ms:.4f} ms")
    return {"ms": k_ms, "plain_ms": t_ms,
            "max_abs_err": float((ki.long() - ti.long()).abs().max().item())}


def check_roi_align_bwd(dev):
    from frcnn_tpu_torch.ops.cuda.roi_align_kernel import (roi_align_backward,
                                                           roi_align_backward_reference)

    rng = np.random.RandomState(7)
    b, r, c = TRAIN_B, 128, 1024
    h, w = TRAIN_FEAT
    rois = random_boxes(rng, b, r, size=1000.0)
    rois[:, :10] = rng.uniform(-400, 1400, (b, 10, 4))             # partly / wholly outside
    rois[:, 10:15, 2:] = rois[:, 10:15, :2]                        # zero size
    rois[:, 15:20] = 0.0                                           # padding rois
    rois_t = torch.from_numpy(rois).to(dev)
    g32 = torch.from_numpy(rng.randn(b, r, 7, 7, c).astype(np.float32)).to(dev)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        g = g32.to(dtype)
        k = roi_align_backward(g, rois_t, (h, w))
        t = roi_align_backward_reference(g, rois_t, (h, w))
        torch.cuda.synchronize()
        if k.dtype != dtype or k.shape != (b, h, w, c):
            raise AssertionError(f"K2b {dtype}: got {k.dtype} {tuple(k.shape)}")
        err = (k.float() - t.float()).abs().max().item()
        scale = t.float().abs().max().item()
        if dtype == torch.float32:
            tol, rule = 1e-5 * scale, "1e-5 of max|twin|"
        else:
            tol, rule = bf16_ulp(scale), "one bf16 ulp of max|twin|"
        if not err <= tol:
            raise AssertionError(f"K2b {dtype}: max abs err {err} > {tol} ({rule})")
        log(f"K2b {str(dtype)[6:]} (dOut 8 x 128 x 7x7x1024 -> dF 8 x 38x64x1024): max abs "
            f"err {err:.3e} <= {tol:.3e} ({rule}, max|twin| {scale:.3f})")
        out[dtype] = err
    k_ms = cuda_ms(lambda: roi_align_backward(g, rois_t, (h, w)))
    t_ms = cuda_ms(lambda: roi_align_backward_reference(g, rois_t, (h, w)), iters=5)
    log(f"K2b time bf16: kernel {k_ms:.4f} ms, plain twin {t_ms:.4f} ms")
    return {"ms": k_ms, "plain_ms": t_ms, "max_abs_err": out[torch.bfloat16]}


def overlap_inputs(rng, dev):
    """Train-shape anchors and padded gt: 3-64 valid gt per image, exact
    anchor copies, duplicated gt (argmax ties), a gt overlapping nothing,
    and images smaller than the bucket (anchors outside)."""
    from frcnn_tpu_torch.ops.anchors import generate_anchors_pre

    anchors, k = generate_anchors_pre(*TRAIN_FEAT, 16)
    b, g = TRAIN_B, 64
    xy = rng.uniform(0, 900, (b, g, 2))
    wh = rng.uniform(16, 400, (b, g, 2))
    gt = np.round(np.concatenate([xy, xy + wh], axis=-1) / 8) * 8   # grid-aligned ties
    gt = gt.astype(np.float32)
    gt[:, :4] = anchors[rng.randint(0, k, (b, 4))]                  # IoU exactly 1
    gt[:, 4] = gt[:, 5]                                             # duplicate gt
    gt[:, 6] = [5000.0, 5000.0, 5010.0, 5010.0]                     # overlaps nothing
    n_valid = rng.randint(3, g + 1, b)
    n_valid[0] = g
    valid = np.arange(g)[None, :] < n_valid[:, None]
    hw = np.stack([rng.randint(400, TRAIN_H + 1, b), rng.randint(600, TRAIN_W + 1, b)], 1)
    hw[0] = (TRAIN_H, TRAIN_W)
    inside = ((anchors[None, :, 0] >= 0) & (anchors[None, :, 1] >= 0)
              & (anchors[None, :, 2] < hw[:, 1:2]) & (anchors[None, :, 3] < hw[:, 0:1]))
    return tuple(torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                 for v in (anchors, gt, valid, inside))


def check_overlap(dev):
    from frcnn_tpu_torch.ops.cuda.overlap_kernel import (anchor_overlap_stats,
                                                         anchor_overlap_stats_reference)

    args = overlap_inputs(np.random.RandomState(8), dev)
    got = anchor_overlap_stats(*args)
    want = anchor_overlap_stats_reference(*args)
    torch.cuda.synchronize()
    for name, k, t in zip(("max_overlaps", "argmax", "is_gt_argmax"), got, want):
        if k.dtype != t.dtype or not torch.equal(k, t):
            raise AssertionError(f"K4 {name}: not bit-equal to the twin "
                                 f"({(k != t).sum().item()} differ)")
    err = (got[0] - want[0]).abs().max().item()
    k_ms = cuda_ms(lambda: anchor_overlap_stats(*args))
    t_ms = cuda_ms(lambda: anchor_overlap_stats_reference(*args))
    log(f"K4 (21888 anchors, 8 x 64 padded gt): max_overlaps, argmax, is_gt_argmax bit-equal "
        f"to the twin ({got[2].sum().item()} gt-argmax anchors, "
        f"{(got[0] == 1.0).sum().item()} at IoU 1); kernel {k_ms:.4f} ms, "
        f"plain twin {t_ms:.4f} ms")
    return {"ms": k_ms, "plain_ms": t_ms, "max_abs_err": err}


def check_select(dev):
    from frcnn_tpu_torch.ops.cuda.select_kernel import topk_threshold, topk_threshold_reference

    rng = np.random.RandomState(9)
    b, n = TRAIN_B, TRAIN_FEAT[0] * TRAIN_FEAT[1] * 9

    def same(name, scores, k):
        kv, ki = topk_threshold(scores, k)
        tv, ti = topk_threshold_reference(scores, k)
        torch.cuda.synchronize()
        if not (torch.equal(ki, ti) and torch.equal(kv.view(torch.int32), tv.view(torch.int32))):
            raise AssertionError(f"K5 {name} k={k}: indices differ from the twin "
                                 f"({(ki != ti).sum().item()} of {ki.numel()})")

    # the production priorities: 1 + u on the fg (bg) anchors, -1 - i * 2^-17 elsewhere
    ramp = np.arange(n, dtype=np.float32) * np.float32(2.0 ** -17)
    u = rng.uniform(0, 1, (b, n)).astype(np.float32)
    prios = {}
    for kind, frac in (("fg", 0.004), ("bg", 0.6)):
        mask = rng.uniform(0, 1, (b, n)) < frac
        mask[0] = rng.uniform(0, 1, n) < 0.002                     # fewer than k
        pri = np.where(mask, np.float32(1.0) + u, np.float32(-1.0) - ramp).astype(np.float32)
        prios[kind] = torch.from_numpy(pri).to(dev)
    for kind, k in (("fg", 128), ("bg", 256)):
        same(f"{kind} priorities (8, {n})", prios[kind], k)
    hard = rng.randint(-3, 4, (b, n)).astype(np.float32)            # rows full of ties
    hard[1] = 7.0
    hard[2, ::97] = np.nan
    hard[2, 5] = np.float32(np.frombuffer(np.uint32(0xFFC00000).tobytes(), np.float32)[0])
    hard[3, ::13] = np.inf
    hard[3, 1::13] = -np.inf
    hard[4, ::2] = -0.0
    hard_t = torch.from_numpy(hard).to(dev)
    for k in (1, 128, 256, 5000, n):
        same("ties, NaN, +-inf", hard_t, k)
    k_ms = sum(cuda_ms(lambda kind=kind, k=k: topk_threshold(prios[kind], k))
               for kind, k in (("fg", 128), ("bg", 256)))
    t_ms = sum(cuda_ms(lambda kind=kind, k=k: topk_threshold_reference(prios[kind], k))
               for kind, k in (("fg", 128), ("bg", 256)))
    log(f"K5 ((8, {n}) production priorities at k 128 and 256; rows of ties, NaN and +-inf at "
        f"k 1..S): indices and value bits equal to the twin; kernel {k_ms:.4f} ms, "
        f"plain twin (stable sort) {t_ms:.4f} ms for the two launches")
    return {"ms": k_ms, "plain_ms": t_ms, "max_abs_err": 0.0}


# ---------------------------------------------------------------------------
# Main path and the end-to-end check
# ---------------------------------------------------------------------------


def synthetic_images(rng, shapes):
    """Low-frequency noise plus flat rectangles, BGR uint8: random-weight
    heads then score boxes without large runs of exact ties."""
    ims = []
    for h, w in shapes:
        base = rng.randint(0, 255, (h // 16 + 1, w // 16 + 1, 3)).astype(np.float32)
        t = torch.from_numpy(base).permute(2, 0, 1)[None]
        im = torch.nn.functional.interpolate(t, size=(h, w), mode="bilinear",
                                             align_corners=False)[0].permute(1, 2, 0).numpy()
        for _ in range(6):
            y, x = rng.randint(0, h - 60), rng.randint(0, w - 60)
            bh, bw = rng.randint(20, 60, 2)
            im[y:y + bh, x:x + bw] = rng.randint(0, 255, 3)
        ims.append(np.clip(im, 0, 255).astype(np.uint8))
    return ims


def smoke_config(extra=()):
    from frcnn_tpu_torch import cfg_from_list, default_config

    return cfg_from_list(default_config(), [
        "TEST.SCALES", "(800,)", "TEST.MAX_SIZE", "1333",
        "DEVICE.BUCKETS", "((800, 1216),)", "TEST.SCORE_THRESH", "0.0", *extra])


def build_seeded(cfg, dtype, seed=0):
    from frcnn_tpu_torch.models.network import build_model, init_random_

    model = build_model("res50", 21, cfg, dtype=dtype)
    init_random_(model, torch.Generator().manual_seed(seed))
    return model.eval()


def main_path(dev, card):
    from frcnn_tpu_torch.engine.serve import Detector
    from frcnn_tpu_torch.ops.cuda import build

    cfg = smoke_config()
    model = build_seeded(cfg, torch.bfloat16).to(dev)
    detector = Detector(model, uint8_input=True)
    bh, bw = cfg.DEVICE.BUCKETS[0]
    rng = np.random.RandomState(3)
    # 800x1216 and 600x912 images both land in the one bucket
    requests = [synthetic_images(rng, [(bh, bw), (bh * 3 // 4, bw * 3 // 4)] * 4)
                for _ in range(3)]

    # finite trunk activations at full size (outside the counted window)
    blob = np.stack([item[1] for item in detector._prep_groups(requests[0])[(bh, bw)]])
    with torch.inference_mode():
        from frcnn_tpu_torch.models.backbones import preprocess_images

        x = preprocess_images(torch.from_numpy(blob).to(dev), cfg, torch.bfloat16)
        feat = model.backbone.extract_features(x.permute(0, 3, 1, 2)).float()
    if not torch.isfinite(feat).all():
        raise AssertionError("trunk activations are not finite at 800x1216")
    log(f"trunk features {tuple(feat.shape)}: finite, std {feat.std().item():.4f}, "
        f"max |x| {feat.abs().max().item():.4f}")

    torch.cuda.synchronize()
    build.reset_launch_counts()
    results = [detector(images) for images in requests]
    torch.cuda.synchronize()
    counts = dict(build.LAUNCH_COUNTS)
    log(f"main path: 3 requests x 8 images served; kernel launches {counts}")
    n_det = 0
    for req in results:
        for dets in req:
            if dets.ndim != 2 or dets.shape[1] != 6 or not np.isfinite(dets).all():
                raise AssertionError(f"bad detections: shape {dets.shape}")
            n_det += len(dets)
    if n_det == 0:
        raise AssertionError("no detections at SCORE_THRESH 0.0")
    want = {"nms": 6, "roi_align": 3, "fused_block": 18}
    for name, n in want.items():
        if counts.get(name, 0) != n:
            raise AssertionError(f"launch count {name}: {counts.get(name, 0)} != {n} "
                                 "(2 / 1 / 6 per batch)")
    log(f"main path: {n_det} finite detections of shape (k, 6) over 24 images; per batch "
        f"K1 {counts['nms'] // 3}, K2 {counts['roi_align'] // 3}, "
        f"K3 {counts['fused_block'] // 3} launches")

    data = torch.from_numpy(blob).to(dev)
    im_info = torch.tensor([[float(bh), float(bw), 1.0]] * 8, device=dev)
    ms = cuda_ms(lambda: detector.detect_blobs(data, im_info), iters=10, warmup=2)
    log(f"serving path steady state (batch 8, {bh}x{bw}, bf16 trunk): {ms:.3f} ms per batch "
        f"(median of 10, CUDA events), {8000.0 / ms:.2f} images/s on {card}")
    return counts


def match_dets(want, got, label, score_atol=1e-3, box_atol=5e-2):
    """One-to-one match of detection rows [x1, y1, x2, y2, score, class]
    (the rule of the JAX pipeline-parity test, per class)."""
    if len(want) != len(got):
        raise AssertionError(f"{label}: CPU kept {len(want)}, card kept {len(got)}")
    used = np.zeros(len(got), bool)
    for row in want:
        cand = np.where(~used & (got[:, 5] == row[5])
                        & (np.abs(got[:, 4] - row[4]) <= score_atol)
                        & (np.abs(got[:, :4] - row[:4]).max(axis=1) <= box_atol))[0]
        if not len(cand):
            raise AssertionError(f"{label}: no card detection matches CPU row {row}")
        used[cand[0]] = True


def end_to_end(dev):
    from frcnn_tpu_torch.engine.serve import Detector
    from frcnn_tpu_torch.ops.cuda import build

    cfg = smoke_config(["TEST.SCALES", "(320,)", "TEST.MAX_SIZE", "480",
                        "DEVICE.BUCKETS", "((320, 480),)", "TEST.SCORE_THRESH", "0.05"])
    cpu_model = build_seeded(cfg, torch.float32, seed=1)
    card_model = build_seeded(cfg, torch.float32, seed=1).to(dev)
    im = synthetic_images(np.random.RandomState(5), [(320, 480)])
    before = dict(build.LAUNCH_COUNTS)
    got = Detector(card_model)(im)[0]
    after = dict(build.LAUNCH_COUNTS)
    want = Detector(cpu_model)(im)[0]
    ran = {k: after.get(k, 0) - before.get(k, 0) for k in ("nms", "roi_align")}
    if ran != {"nms": 2, "roi_align": 1}:
        raise AssertionError(f"f32 card detect did not run K1 twice and K2 once: {ran}")
    match_dets(want, got, "f32 detect, card vs CPU")
    log(f"end to end (f32, TF32 off, 320x480): card detect (K1 x2, K2 x1) matches the CPU "
        f"copy (twins): {len(want)} detections, score atol 1e-3, box atol 5e-2")


# ---------------------------------------------------------------------------
# The train path
# ---------------------------------------------------------------------------

# per train step: proposals NMS, RoIAlign fwd + bwd, the 6 stride-1 blocks
# of layer1-2 (forward; their backward is autograd of the twin), anchor
# overlaps, fg + bg subsampling
TRAIN_LAUNCHES = {"nms": 1, "roi_align": 1, "roi_align_bwd": 1, "fused_block": 6,
                  "overlap": 1, "select": 2}


def synthetic_roidb(rng, shapes, max_boxes=20):
    """In-memory roidb over synthetic images: each entry has 3-max_boxes gt
    boxes, painted as flat rectangles.  Returns (roidb, reader)."""
    images = synthetic_images(rng, shapes)
    roidb = []
    for i, (im, (h, w)) in enumerate(zip(images, shapes)):
        n = rng.randint(3, max_boxes + 1)
        xy = np.stack([rng.uniform(0, w - 40, n), rng.uniform(0, h - 40, n)], 1)
        wh = rng.uniform(24, np.array([w, h]) / 2, (n, 2))
        boxes = np.concatenate([xy, np.minimum(xy + wh, [w - 1, h - 1])], 1).astype(np.float32)
        for x1, y1, x2, y2 in boxes.astype(int):
            im[y1:y2, x1:x2] = rng.randint(0, 255, 3)
        roidb.append({"image": f"synthetic/{i}", "boxes": boxes, "flipped": False,
                      "gt_classes": rng.randint(1, 21, n).astype(np.int32),
                      "height": h, "width": w, "max_overlaps": np.ones(n, np.float32)})
    table = {e["image"]: im for e, im in zip(roidb, images)}
    return roidb, table.__getitem__


def train_config(extra=()):
    from frcnn_tpu_torch import cfg_from_list, default_config

    return cfg_from_list(default_config(), [
        "TRAIN.IMS_PER_BATCH", str(TRAIN_B), "DEVICE.BUCKETS", f"(({TRAIN_H}, {TRAIN_W}),)",
        "TRAIN.DISPLAY", "1", *extra])


def train_path(dev, card):
    from frcnn_tpu_torch.engine.train import SolverWrapper, filter_roidb
    from frcnn_tpu_torch.ops.cuda import build

    cfg = train_config()
    model = build_seeded(cfg, torch.bfloat16).to(dev)
    rng = np.random.RandomState(4)
    # landscape images whose 600-pixel rescale fits the 608x1024 bucket
    shapes = []
    for _ in range(16):
        h = int(rng.choice([375, 450, 480, 600]))
        shapes.append((h, int(h * rng.uniform(1.3, 1.66))))
    roidb, reader = synthetic_roidb(rng, shapes)
    roidb = filter_roidb(roidb, cfg)
    solver = SolverWrapper(model, roidb, cfg, reader=reader)
    before = {name: p.detach().clone() for name, p in model.named_parameters()}

    steps = 5
    torch.cuda.synchronize()
    build.reset_launch_counts()
    history = solver.train_model(steps)
    torch.cuda.synchronize()
    counts = dict(build.LAUNCH_COUNTS)
    log(f"train path: {steps} steps of batch {TRAIN_B} at {TRAIN_H}x{TRAIN_W} over a "
        f"{len(roidb)}-entry synthetic roidb; kernel launches {counts}")
    for i, losses in enumerate(history):
        if not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"train step {i + 1}: non-finite losses {losses}")
    want = {name: n * steps for name, n in TRAIN_LAUNCHES.items()}
    if counts != want:
        raise AssertionError(f"train launch counts {counts} != {want} ({TRAIN_LAUNCHES} per step)")
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    trained = [n for n, p in model.named_parameters() if p.requires_grad]
    params = dict(model.named_parameters())
    moved = [n for n in frozen if not torch.equal(params[n], before[n])]
    still = [n for n in trained if torch.equal(params[n], before[n])]
    if moved or still:
        raise AssertionError(f"frozen params changed: {moved}; trainable params unchanged: {still}")
    log(f"train path: losses finite, first {history[0]}, last {history[-1]}; "
        f"{len(frozen)} frozen tensors bit-unchanged, {len(trained)} trainable tensors changed")

    blobs = {k: torch.as_tensor(v).to(dev) for k, v in solver.data_layer.forward().items()}
    ms = cuda_ms(lambda: solver.train_step(blobs), iters=10, warmup=2)
    log(f"train step steady state (batch {TRAIN_B}, {TRAIN_H}x{TRAIN_W}, bf16 trunk): "
        f"{ms:.3f} ms per step (median of 10, CUDA events), "
        f"{TRAIN_B * 1000.0 / ms:.2f} images/s on {card}")
    return counts, solver


def train_card_vs_cpu(dev):
    """One f32 train step on the card (kernels) and on a CPU copy (twins)
    from the same weights, minibatch and draws.  The proposal and RoI
    counts are cut (pre-NMS 400, post-NMS 64) so that the proposal order,
    which decides which roi each random priority lands on, is not flipped
    by near-tied RPN scores that differ in the last bits between cuDNN and
    the CPU convolutions."""
    from frcnn_tpu_torch.data.loader import get_minibatch
    from frcnn_tpu_torch.engine.train import SolverWrapper
    from frcnn_tpu_torch.ops.cuda import build

    cfg = train_config(["TRAIN.IMS_PER_BATCH", "2", "DEVICE.BUCKETS", "((320, 480),)",
                        "TRAIN.SCALES", "(320,)", "TRAIN.MAX_SIZE", "480",
                        "TRAIN.RPN_PRE_NMS_TOP_N", "400", "TRAIN.RPN_POST_NMS_TOP_N", "64"])
    rng = np.random.RandomState(5)
    roidb, reader = synthetic_roidb(rng, [(320, 480), (320, 480)])
    blobs = get_minibatch(roidb, cfg, np.random.RandomState(0), reader=reader)
    k = (320 // 16) * (480 // 16) * 9
    n = 64 + cfg.DEVICE.MAX_GT
    draws = {name: torch.from_numpy(rng.uniform(0, 1, (2, size)).astype(np.float32))
             for name, size in (("anchor_fg", k), ("anchor_bg", k), ("roi_fg", n),
                                ("roi_bg", n))}
    results = []
    for device in (dev, torch.device("cpu")):
        model = build_seeded(cfg, torch.float32, seed=2).to(device)
        before = {name: p.detach().clone() for name, p in model.named_parameters()}
        solver = SolverWrapper(model, roidb, cfg, reader=reader)
        start = dict(build.LAUNCH_COUNTS)
        losses = solver.train_step(blobs, {k_: v.to(device) for k_, v in draws.items()})
        ran = {k_: v - start.get(k_, 0) for k_, v in build.LAUNCH_COUNTS.items()
               if v != start.get(k_, 0)}
        delta = {name: (p.detach() - before[name]).cpu() for name, p in model.named_parameters()}
        results.append(({k_: float(v) for k_, v in losses.items()}, delta, ran))
    (card_l, card_d, card_ran), (cpu_l, cpu_d, cpu_ran) = results
    if card_ran != {"nms": 1, "roi_align": 1, "roi_align_bwd": 1} or cpu_ran:
        raise AssertionError(f"f32 train step launches: card {card_ran}, CPU {cpu_ran}")
    for name, want in cpu_l.items():
        rel = abs(card_l[name] - want) / max(abs(want), 1e-6)
        if not rel <= 1e-4:
            raise AssertionError(f"f32 train step {name}: card {card_l[name]} vs CPU {want} "
                                 f"(rel {rel:.2e} > 1e-4)")
    worst = {}
    for name in ("rpn_net.weight", "cls_score.weight", "layer2.1.conv2.weight"):
        scale = cpu_d[name].abs().max().item()
        err = (card_d[name] - cpu_d[name]).abs().max().item()
        if not (scale > 0 and err <= 1e-3 * scale):
            raise AssertionError(f"f32 train step update of {name}: err {err} vs max|delta| "
                                 f"{scale} (tolerance 1e-3 relative)")
        worst[name] = err / scale
    log(f"f32 train step, card (K1, K2, K2b) vs CPU copy (twins), 320x480, batch 2: losses "
        f"{cpu_l} within 1e-4 relative; updates within 1e-3 of max|delta| "
        f"({ {k_: f'{v:.2e}' for k_, v in worst.items()} })")


# (owner, attribute, stage) of the calls train_forward makes, in order; the
# owner is the network module (its globals) or an object of the solver
TRAIN_STAGES = (
    ("network", "preprocess_images", "preprocess"),
    ("backbone", "extract_features", "trunk forward (stem, layer1-3; K3 x6)"),
    ("network", "anchor_target_compact", "anchor targets (K4, K5 x2)"),
    ("model", "_rpn", "RPN head"),
    ("network", "proposal_layer_batch", "proposals (sort, K1 8x12000 cap 2000)"),
    ("network", "proposal_target_layer", "proposal targets"),
    ("model", "_pool", "RoIAlign forward (K2)"),
    ("model", "_classify", "tail + heads forward"),
    ("network", "detection_losses_compact", "losses"),
    ("model", "train_forward", "forward total"),
    ("optimizer", "step", "SGD update"),
)


def profile_train_step(solver, card):
    """Stage breakdown of a steady-state train step.  A CUDA event is
    recorded on the current stream just before and just after each call of
    TRAIN_STAGES (the calls are wrapped for this phase only); a stage's time
    is the median over 10 steps, after 2 warm-up steps, of the time between
    its two events.  "backward" is the time from the end of train_forward to
    the start of the SGD update (zero_grad, backward, clip).  Then
    torch.profiler over 3 steps: the union of the device's kernel intervals
    against the host wall time gives the idle share, and the kernels are
    summed by name.  Everything goes to chiprun_out/profile_train.json."""
    from torch.profiler import ProfilerActivity, profile

    from frcnn_tpu_torch.models import network

    owners = {"network": network, "backbone": solver.model.backbone, "model": solver.model,
              "optimizer": solver.optimizer}
    events = []

    def timed(fn, stage):
        def wrapper(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            events.append((stage, start, end))
            return out
        return wrapper

    blobs = {k: torch.as_tensor(v).to(solver.device)
             for k, v in solver.data_layer.forward().items()}
    originals = [(owners[o], attr, getattr(owners[o], attr)) for o, attr, _ in TRAIN_STAGES]
    for (obj, attr, fn), (_, _, stage) in zip(originals, TRAIN_STAGES):
        setattr(obj, attr, timed(fn, stage))
    per_step = []
    try:
        for i in range(12):
            events.clear()
            step = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            step[0].record()
            solver.train_step(blobs)
            step[1].record()
            torch.cuda.synchronize()
            if i < 2:
                continue
            ms = {stage: start.elapsed_time(end) for stage, start, end in events}
            ends = {stage: (start, end) for stage, start, end in events}
            ms["backward"] = ends["forward total"][1].elapsed_time(ends["SGD update"][0])
            ms["step total"] = step[0].elapsed_time(step[1])
            per_step.append(ms)
    finally:
        for obj, attr, fn in originals:
            if obj is network:
                setattr(obj, attr, fn)
            else:
                delattr(obj, attr)           # back to the class's method
    stages = {name: statistics.median(ms[name] for ms in per_step) for name in per_step[0]}

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            solver.train_step(blobs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise AssertionError("torch.profiler recorded no device activity")
    busy_us, last = 0.0, -float("inf")
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        lo, hi = max(e.time_range.start, last), e.time_range.end
        busy_us += max(hi - lo, 0.0)
        last = max(last, hi)
    by_name = {}
    for e in kernels:
        total, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]
    result = {"card": card, "stages_ms_median_of_10": stages,
              "profiler_3_steps": {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
                                   "idle_share": 1.0 - busy_us / 1e3 / wall_ms},
              "top_kernels_ms_per_step": [(name[:100], total / 3, n / 3)
                                          for name, (total, n) in top]}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "profile_train.json"), "w") as f:
        json.dump(result, f, indent=1)
    log("train step stages (ms, median of 10, CUDA events): "
        + ", ".join(f"{name} {ms:.3f}" for name, ms in stages.items()))
    log(f"train step under torch.profiler, 3 steps: wall {wall_ms:.3f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms, idle share {result['profiler_3_steps']['idle_share']:.4f}")
    for name, total, n in result["top_kernels_ms_per_step"][:10]:
        log(f"  {total:8.4f} ms/step  {n:6.1f} launches/step  {name}")


def parse_args(argv):
    parser = argparse.ArgumentParser(description="Smoke run of frcnn_tpu_torch on one card.")
    parser.add_argument("--only", choices=("kernels",),
                        help="stop after the kernel phases (a partial run: no ok line)")
    parser.add_argument("--profile", action="store_true",
                        help="after the train path, time each stage of a train step and "
                             "profile the device (chiprun_out/profile_train.json)")
    return parser.parse_args(argv)


KERNELS = (  # name, source, the TPU kernel it replaces
    ("nms", "frcnn_tpu_torch/csrc/nms_kernel.cu", "frcnn_tpu/ops/pallas/nms_kernel.py:318"),
    ("roi_align", "frcnn_tpu_torch/csrc/roi_align_kernel.cu",
     "frcnn_tpu/ops/pallas/roi_align_kernel.py:702"),
    ("roi_align_bwd", "frcnn_tpu_torch/csrc/roi_align_kernel.cu",
     "frcnn_tpu/ops/pallas/roi_align_kernel.py:752"),
    ("fused_block", "frcnn_tpu_torch/csrc/fused_block.cu",
     "frcnn_tpu/ops/pallas/fused_block.py:133"),
    ("overlap", "frcnn_tpu_torch/csrc/overlap_kernel.cu",
     "frcnn_tpu/ops/pallas/overlap_kernel.py:153"),
    ("select", "frcnn_tpu_torch/csrc/select_kernel.cu",
     "frcnn_tpu/ops/pallas/select_kernel.py:213"),
)


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from frcnn_tpu_torch.ops.cuda import build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; TF32 off")

    t0 = time.perf_counter()
    build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc {build.BUILD_SECONDS:.2f} s, one "
        f"process per source)")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "build_log.txt"), "w") as f:
        f.write(build.BUILD_LOG)
    for line in build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            log(f"ptxas: {line.strip()}")

    k1 = check_nms(dev)
    k2 = check_roi_align(dev)
    k3 = check_fused_block(dev)
    k1_train = check_nms_train(dev)
    results = {
        "nms": {"ms": k1["ms"] + k1_train["ms"], "plain_ms": k1["plain_ms"] + k1_train["plain_ms"],
                "max_abs_err": max(k1["max_abs_err"], k1_train["max_abs_err"])},
        "roi_align": k2, "fused_block": k3, "roi_align_bwd": check_roi_align_bwd(dev),
        "overlap": check_overlap(dev), "select": check_select(dev)}
    if args.only == "kernels":
        # a partial run: no main path ran, so no launch count and no ok line
        print(json.dumps({"kernel_checks": [{"name": name, **results[name]}
                                            for name, _, _ in KERNELS]}))
        print(card)
        return 0

    serve_counts = main_path(dev, card)
    end_to_end(dev)
    train_counts, solver = train_path(dev, card)
    train_card_vs_cpu(dev)
    if args.profile:
        profile_train_step(solver, card)

    kernels = []
    for name, src, rep in KERNELS:
        launches = serve_counts.get(name, 0) + train_counts.get(name, 0)
        if launches == 0:
            raise AssertionError(f"kernel {name} was not launched on a main path")
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                        "launches": launches, **results[name]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
