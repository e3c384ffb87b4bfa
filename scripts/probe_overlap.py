#!/usr/bin/env python3
"""K4 (anchor-overlap stats) on one card: bit-equality with its twin, its
time a call and on the device alone, under several plans, with parts of the
work taken away, against the twin over K (the gate), and inside the two
train steps:

    python3 scripts/probe_overlap.py                 # everything but the steps
    python3 scripts/probe_overlap.py --quick         # build, check, no timing
    python3 scripts/probe_overlap.py --steps         # also K4 inside the train steps
    python3 scripts/probe_overlap.py --root DIR      # measure DIR's frcnn_tpu_torch

``--root`` points at another checkout (an earlier commit unpacked with
``git archive``) so that two versions are timed in one call; plans and the
gate table need ``overlap_plan`` and are skipped where it is missing.

  * the shapes of ``chip_smoke.py``'s ``check_overlap``: the C4 train anchors
    (21888) and the FPN train anchors (P2-P6 of 608x1024, 155520), 8 x 64
    padded gt from ``chip_smoke.overlap_inputs``;
  * probes at both shapes: no valid gt (the stores alone), every gt far from
    every anchor (all culled), and 64 valid gts that each cover the image
    (every chunk keeps all 64: the dense loop);
  * plans: ``PLANS``, blocks a cluster x threads a block;
  * the gate: the kernel and the twin a call over the C4 and FPN anchor
    tables of smaller buckets, 3-20 valid gts an image (the synthetic
    roidb's range);
  * ``--steps``: K4's device time in a steady-state C4 and FPN train step
    (``chip_smoke.py``'s train configuration; torch.profiler over 3 steps).
A call is CUDA events around the wrapper (median of 50), "on the device"
torch.profiler's device operations of a call (median of 20 calls).
"""

import argparse
import os
import statistics
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def device_ms(fn, n=20):
    """Device time a call of fn: over n calls, the median duration of each
    device operation it launches (kernels and memsets, by name), summed."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
            torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name.setdefault(e.name[:40], []).append(e.time_range.elapsed_us() / 1e3)
    return sum(statistics.median(t) for t in by_name.values()), sorted(by_name)


# (cluster, threads)
PLANS = ((16, 1024), (16, 512), (16, 256), (8, 1024), (8, 512), (4, 1024), (1, 1024))


def same(got, want):
    return all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want))


def probe_inputs(args, case):
    anchors, gt, valid, inside = args
    gt = gt.clone()
    valid = valid.clone()
    if case == "no valid gt":
        valid[:] = False
    elif case == "every gt culled":
        gt[:] = torch.tensor([5000.0, 5000.0, 5010.0, 5010.0], device=gt.device)
        valid[:] = True
    elif case == "every gt survives":
        j = torch.arange(gt.shape[1], device=gt.device, dtype=torch.float32)
        gt[:] = torch.stack([-j, -j, 1100.0 + j, 700.0 + j], 1)
        valid[:] = True
    return anchors, gt, valid, inside


def gate_inputs(rng, dev, anchors, h, w):
    b, g = 8, 64
    n = rng.randint(3, 21, b)
    xy = np.stack([rng.uniform(0, w - 40, (b, g)), rng.uniform(0, h - 40, (b, g))], -1)
    wh = np.stack([rng.uniform(24, w / 2, (b, g)), rng.uniform(24, h / 2, (b, g))], -1)
    gt = np.concatenate([xy, np.minimum(xy + wh, [w - 1, h - 1])], -1).astype(np.float32)
    valid = np.arange(g)[None, :] < n[:, None]
    inside = np.broadcast_to((anchors[:, 0] >= 0) & (anchors[:, 1] >= 0) & (anchors[:, 2] < w)
                             & (anchors[:, 3] < h), (b, len(anchors)))
    return tuple(torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                 for v in (anchors, gt, valid, inside))


def fpn_anchors(h, w):
    from frcnn_tpu_torch.ops.anchors import generate_anchors_pre

    levels = [(-(-h // 2 ** lv), -(-w // 2 ** lv)) for lv in range(2, 7)]
    return np.concatenate([generate_anchors_pre(fh, fw, 2 ** lv, scales=(8.0,))[0]
                           for lv, (fh, fw) in enumerate(levels, start=2)])


def step_overlap_ms(cs, net):
    """K4's device time (kernels named overlap) and the step's memsets, per
    steady-state train step of ``net``."""
    from frcnn_tpu_torch.engine.train import SolverWrapper, filter_roidb

    cfg = cs.train_config()
    model = cs.build_seeded(cfg, torch.bfloat16, net=net)
    rng = np.random.RandomState(4)
    shapes = []
    for _ in range(16):
        h = int(rng.choice([375, 450, 480, 600]))
        shapes.append((h, int(h * rng.uniform(1.3, 1.66))))
    roidb, reader = cs.synthetic_roidb(rng, shapes)
    solver = SolverWrapper(model, filter_roidb(roidb, cfg), cfg, reader=reader)
    blobs = {k: torch.as_tensor(v).to(solver.device) for k, v in solver.data_layer.forward().items()}
    for _ in range(2):
        solver.train_step(blobs)
    prof, kernels = cs.device_profile(lambda: solver.train_step(blobs))
    k4 = [(name, ms, n) for name, ms, n in kernels if "overlap" in name]
    memset = sum(ms for name, ms, _ in kernels if "emset" in name)
    return sum(ms for _, ms, _ in k4), k4, memset, prof["device_busy_ms"] / 3


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=REPO)
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--steps", action="store_true")
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    sys.path.insert(0, root)
    from frcnn_tpu_torch.ops.anchors import generate_anchors_pre
    from frcnn_tpu_torch.ops.cuda import build
    from frcnn_tpu_torch.ops.cuda import overlap_kernel as ok

    if not os.path.abspath(ok.__file__).startswith(root):
        raise AssertionError(f"imported {ok.__file__}, not from {root}")
    dev = torch.device("cuda", 0)
    print(f"card: {cs.card_line()}; torch {torch.__version__}; tree {root}", flush=True)
    build.library()
    lines = [line.strip() for line in build.BUILD_LOG.splitlines()]
    for i, line in enumerate(lines):
        if "overlap" in line and "Compiling" in line:
            print("ptxas:", " | ".join(lines[i:i + 4]))
    has_plan = hasattr(ok, "overlap_plan")

    rng = np.random.RandomState(8)              # check_overlap's inputs, in its order
    shapes = (("C4 train", generate_anchors_pre(*cs.TRAIN_FEAT, 16)[0]),
              ("FPN train", cs.fpn_train_anchors()))
    for name, anchors in shapes:
        base = cs.overlap_inputs(rng, dev, anchors)
        for case in ("as chip_smoke", "no valid gt", "every gt culled", "every gt survives"):
            inp = probe_inputs(base, case)
            want = ok.anchor_overlap_stats_reference(*inp)
            got = ok.anchor_overlap_stats(*inp)
            torch.cuda.synchronize()
            if not same(got, want):
                raise AssertionError(f"K4 {name} {case}: not bit-equal to the twin")
            if args.quick:
                print(f"K4 {name} {case}: bit-equal", flush=True)
                continue
            call = cs.cuda_ms(lambda: ok.anchor_overlap_stats(*inp), iters=50, warmup=5)
            dms, ops = device_ms(lambda: ok.anchor_overlap_stats(*inp))
            print(f"K4 {name} ({len(anchors)} anchors) {case}: a call {call:.4f} ms, on the "
                  f"device {dms:.4f} ms ({ops})", flush=True)
        if not has_plan:
            continue
        b, k = base[1].shape[0], len(anchors)
        for cluster, threads in PLANS:
            plan = ok.overlap_plan(b, k, cluster=cluster, threads=threads)
            got = ok.anchor_overlap_stats(*base, plan=plan)
            if not same(got, ok.anchor_overlap_stats_reference(*base)):
                raise AssertionError(f"K4 {name} plan {plan}: not bit-equal to the twin")
            if args.quick:
                continue
            dms, _ = device_ms(lambda: ok.anchor_overlap_stats(*base, plan=plan))
            print(f"K4 {name} cluster {cluster} x {threads} threads (segment "
                  f"{plan['segment']}): on the device {dms:.4f} ms", flush=True)
        if args.quick:
            print(f"K4 {name}: bit-equal under {len(PLANS)} plans", flush=True)
    if args.quick:
        return 0

    if has_plan:
        grng = np.random.RandomState(21)
        print("gate: K, bucket, kernel a call ms, twin a call ms", flush=True)
        for kind, (h, w) in (("C4", (128, 192)), ("C4", (192, 320)), ("FPN", (128, 192)),
                             ("C4", (320, 480)), ("C4", (480, 640)), ("FPN", (320, 480)),
                             ("C4", (608, 1024)), ("FPN", (480, 640)), ("C4", (800, 1216)),
                             ("FPN", (608, 1024)), ("FPN", (800, 1216))):
            anchors = (generate_anchors_pre(-(-h // 16), -(-w // 16), 16)[0] if kind == "C4"
                       else fpn_anchors(h, w))
            inp = gate_inputs(grng, dev, anchors, h, w)
            got = ok.anchor_overlap_stats(*inp)
            if not same(got, ok.anchor_overlap_stats_reference(*inp)):
                raise AssertionError(f"K4 gate {kind} {h}x{w}: not bit-equal to the twin")
            k_ms = cs.cuda_ms(lambda: ok.anchor_overlap_stats(*inp), iters=50, warmup=5)
            t_ms = cs.cuda_ms(lambda: ok.anchor_overlap_stats_reference(*inp), iters=20)
            print(f"gate: K {len(anchors)}, {kind} {h}x{w}, kernel {k_ms:.4f}, twin "
                  f"{t_ms:.4f}", flush=True)

    if args.steps:
        for net in ("res50", "res50_fpn"):
            total, k4, memset, busy = step_overlap_ms(cs, net)
            print(f"K4 in the {net} train step: {total:.4f} ms on the device a step "
                  f"({[(n[:40], round(ms, 4), c) for n, ms, c in k4]}); memsets of the step "
                  f"{memset:.4f} ms; device busy {busy:.3f} ms a step", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
