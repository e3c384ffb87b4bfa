#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``frcnn_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):
  0. the card: name and power limit from nvidia-smi, torch/CUDA versions;
  1. build the hand-written kernels from frcnn_tpu_torch/csrc with nvcc;
  2. K1 (batched NMS) against its plain twin: nms_fixed_batched indices and
     valid masks equal, uncapped keep masks bit-equal;
  3. K2 (RoIAlign forward) against its twin, f32 and bf16;
  4. K3 (fused bottleneck) against its twin at the layer1/layer2 shapes;
  5. the main path: res50 C4, 21 classes, seeded random weights, bf16
     trunk, one 800x1216 bucket; 3 requests of 8 images through
     ``Detector``, with the kernels' launch counts, then the steady-state
     batch time;
  6. one image through ``detect`` in f32 on the card and on a CPU copy of
     the same model; detections matched one to one.
Then one JSON line of per-kernel results, the card line, and, last, the
JSON ok line.  TF32 is off for convolutions and matmuls throughout, so f32
comparisons are f32.
"""

from __future__ import annotations

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
    b, h, w, c, r = 8, 50, 76, 1024, 300
    feat32 = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32)).to(dev)
    rois = random_boxes(rng, b, r, size=1216.0)
    rois[:, :20] = rng.uniform(-400, 1600, (b, 20, 4))            # partly / wholly outside
    rois[:, 20:30, 2:] = rois[:, 20:30, :2]                        # degenerate: zero size
    rois[:, 30:40] = 0.0                                           # padding rois
    rois[:, 40:50, 2:] = rois[:, 40:50, :2] - 5.0                  # inverted corners
    rois_t = torch.from_numpy(rois).to(dev)
    out = {}
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
            raise AssertionError(f"K2 {dtype}: max abs err {err} > {tol} ({rule})")
        log(f"K2 {str(dtype)[6:]} (8 x 50x76x1024, 300 rois): max abs err {err:.3e} "
            f"<= {tol:.3e} ({rule})")
        out[dtype] = err
        if dtype == torch.bfloat16:
            k_ms = cuda_ms(lambda: roi_align_forward(feat, rois_t))
            t_ms = cuda_ms(lambda: roi_align_reference(feat, rois_t), iters=5)
            log(f"K2 time bf16: kernel {k_ms:.4f} ms, plain twin {t_ms:.4f} ms")
    return {"ms": k_ms, "plain_ms": t_ms, "max_abs_err": out[torch.bfloat16]}


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------

# (name, H, W, Cin, mid, projection, launches per main-path batch)
K3_SHAPES = (("layer1 block0 (proj)", 200, 304, 64, 64, True, 1),
             ("layer1 block1-2", 200, 304, 256, 64, False, 2),
             ("layer2 block1-3", 100, 152, 512, 128, False, 3),
             ("mid-128 projection", 100, 152, 256, 128, True, 0))


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
    log(f"K3 time over the 6 main-path launches: kernel {k_total:.4f} ms, "
        f"plain twin {t_total:.4f} ms")
    return {"ms": k_total, "plain_ms": t_total, "max_abs_err": worst}


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
    log(f"main path steady state (batch 8, {bh}x{bw}, bf16 trunk): {ms:.3f} ms per batch "
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


def main() -> int:
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
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc {build.BUILD_SECONDS:.2f} s)")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "build_log.txt"), "w") as f:
        f.write(build.BUILD_LOG)
    for line in build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            log(f"ptxas: {line.strip()}")

    k1 = check_nms(dev)
    k2 = check_roi_align(dev)
    k3 = check_fused_block(dev)
    counts = main_path(dev, card)
    end_to_end(dev)

    kernels = []
    for name, res, src, rep in (
            ("nms", k1, "frcnn_tpu_torch/csrc/nms_kernel.cu",
             "frcnn_tpu/ops/pallas/nms_kernel.py:318"),
            ("roi_align", k2, "frcnn_tpu_torch/csrc/roi_align_kernel.cu",
             "frcnn_tpu/ops/pallas/roi_align_kernel.py:702"),
            ("fused_block", k3, "frcnn_tpu_torch/csrc/fused_block.cu",
             "frcnn_tpu/ops/pallas/fused_block.py:133")):
        launches = counts.get(name, 0)
        if launches == 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                        "launches": launches,
                        "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                        "plain_ms": res["plain_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
