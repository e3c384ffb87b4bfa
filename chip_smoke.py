#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``frcnn_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --only kernels   # stop after the kernel phases (1-11)
    python3 chip_smoke.py --only coco      # the kernel phases, 12 and the COCO
                                           # phases 48-50 alone
    python3 chip_smoke.py --only graphs    # 12, then phase 51 on models built
                                           # for it (no kernel checks)
    python3 chip_smoke.py --profile        # and stage breakdowns of the three train
                                           # steps and of FPN detect (38-41)

On the card every ``Detector`` replays one CUDA graph captured per batch
shape (``frcnn_tpu_torch/engine/graphs.py``): the kernel wrappers count at
its eager warm-up and at the capture, and a replay calls no wrapper, so the
serving phases check each graph's capture-time launches, its replays and
the wrappers' counts of the warm-up and the capture (``check_graphed``).

Phases, each of which raises on failure (the script then exits non-zero):
  0. the card: name and power limit from nvidia-smi, torch/CUDA versions;
  1. build the hand-written kernels from frcnn_tpu_torch/csrc with nvcc;
  2. K1 (batched NMS) against its plain twin at the C4 proposal shape (8 x
     6000), the FPN proposal shape (8 x 4741, an invalid NEG_INF tail) and
     the per-class shape (168 x 300, 168 x 5000 under TEST.MODE top, and
     COCO's 648 x 300 with softmax scores over 81 classes, most of each row
     below SCORE_THRESH 0.05):
     nms_fixed_batched indices and valid masks equal; the capped keep masks
     (the form the main path runs) bit-equal to the twin's mask cut after its
     first ``cap`` kept boxes, also with the cap inside the first chunk of 64
     and with a cap that is never reached; uncapped keep masks bit-equal;
  3. K2 (RoIAlign forward) against its twin, f32 and bf16, at the serving
     shape (8 x 300 rois, 50x76x1024) and the train shape (8 x 128 rois,
     38x64x1024), at VGG-16's and MobileNet's C = 512 (the same shapes and
     8 x 5000 rois under TEST.MODE top) and MobileNet-0.25's C = 128, with
     the share of corner reads that its staging leaves; then at C = 1024, 256
     and 1023 (an odd C: one channel a thread) with
     rois wider than 28 map columns and one pixel wide;
  4. K3 (fused bottleneck) against its twin at the layer1/layer2 shapes of
     the serving path (800x1216) and of the train path (608x1024), with
     ptxas's registers and spills of its instantiations; then the BN
     epilogue bit-equal to its twin at every shape of a res101 C4 serving
     batch (8 at 608x1024, 2400 crops in layer4) in the form each site takes
     (no middle term, the identity residual, the projection shortcut), timed
     in CUDA graphs beside the twin and the module-by-module path it replaces;
  5. K1 at the train shapes (C4: 8 x 12000, FPN: 8 x 8480; t=0.7, cap 2000),
     indices and capped keep masks as in 2;
  6. K2b (RoIAlign backward) against its twin, f32 and bf16, at the train
     shape (8 x 128 rois, 38x64x1024, and at C = 512 and 128); K6b (multilevel RoIAlign backward)
     against its twin, f32 and bf16, at the FPN train shape (dOut 8 x 128 x
     7x7x256 over P2-P5 of 608x1024), every level populated and with one
     level empty (exactly zero), and with every roi on one level bit-equal to
     K2b on that level; each called twice with bit-equal results; both timed
     under a few tile and chunk plans beside the default;
  7. K4 (anchor-overlap stats) bit-equal to its twin at the C4, FPN and
     COCO C4 train shapes (21888, 155520 and 29184 anchors, 8 x 64 padded
     gt), with an
     image with no valid gt, one with every anchor outside and gts whose
     edge touches a chunk's box exactly; a device profile of one call lists
     one kernel and no memset; the bound counts the pairs with inter > 0;
  8. K5 (threshold top-k) indices equal to its twin at (8, 21888), k 128
     and 256, on rows of ties, NaN and +-inf, and k = S, on rows whose ties
     at the cut fall in several segments of the kernel's cluster (8 and 1 x
     182400), at a row length that is no multiple of 4 and at S = 5, at the
     FPN serving rows (8, 182400) and (8, 45600), k 1000, at the FPN
     train rows (8, 155520), k 128 and 256, and (8, 116736), k 2000, at the
     COCO C4 train rows (8, 29184), k 128 and 256, and at the C4 proposal
     rows of the threshold route, (8, 45600) and (8, 34200) with NEG_INF
     tails, k 1000, timed beside ``torch.topk``, ``torch.sort`` and the
     stable sort the route replaces (its output the sort's first 1000);
  9. K6 (multilevel RoIAlign forward) against its twin, f32 and bf16, at
     the FPN serving shape (P2-P5 of 800x1216, 256 channels, 8 x 300
     rois), every level populated and with one level empty; and K6 with
     every roi on one level bit-equal to K2 on that level;
 10. single-problem NMS (``nms_fixed``, K1 at B = 1: the TPU package's
     K1b) at 6000 boxes, t=0.7: indices and valid equal to the twin, capped
     keep masks as in 2, and the kernel's launch timed alone;
 11. (with ``--only kernels``: print the kernel results and the card line
     and stop; a partial run prints no ok line);
 12. the serving path: res50 C4, 21 classes, seeded random weights, bf16
     trunk, one 800x1216 bucket; 3 requests of 8 images through
     ``Detector`` (one graph captured, replayed 3 times), with the kernels'
     launch counts (the BN epilogue 31 a batch: every frozen BN outside K3),
     then the steady-state batch time (graphed);
 13. one image through ``detect`` in f32 on the card and on a CPU copy of
     the same model; detections matched one to one;
 14. the FPN serving path: res50_fpn, the same bucket, batch, weights seed
     and requests as 12: first the served RPN's bf16 logit product at P2
     against the f32 product of the same operands, then the requests with
     their launch counts per batch (K3 6, K5 2, K1 2, K6 1, the BN epilogue
     31), then the
     steady-state batch time;
 15. one image through FPN ``detect`` in f32 on the card and on a CPU copy,
     matched one to one;
 16. the train path: ``SolverWrapper.train_model`` for 5 steps of batch 8
     at 608x1024, bf16 trunk, over a synthetic in-memory roidb; launch
     counts per step, finite losses, frozen parameters bit-unchanged and
     trainable ones changed; then the steady-state step time and the peak
     device memory;
 17. one f32 train step on the card and on a CPU copy with the same weights
     and draws: losses and parameter updates matched;
 18. the FPN train path: res50_fpn, the shape, roidb and solver of 16; on
     step 1 every trainable tensor has a non-zero gradient; launch counts
     per step (K3 6, K4 1, K5 3, K1 1, K6 1, K6b 1), finite losses, frozen
     parameters bit-unchanged; then the steady-state step time and the peak
     device memory (as in 16, beside the figure of the f32-accumulator
     backward);
 19. one f32 FPN train step on the card and on a CPU copy, as 17;
 20. (a) ``train_net`` at full width: res50 C4, batch 8, 608x1024, bf16 trunk,
     over a synthetic VOC devkit written into a temporary directory
     (Annotations XML and ImageSets on disk, the pixels from a seeded numpy
     reader, so that no image codec is needed), 16 images and their
     flips.  Run A: 6 iterations straight (SNAPSHOT_ITERS 100: the final
     snapshot only), with its launch counts per step (those of 16), every
     parameter and buffer on cuda:0 and finite losses in train_log.jsonl;
     the median iteration time (prefetch thread on) beside 16's step time.
     A again: if the two straight runs differ, both again under
     ``cudnn.deterministic``, and if they still differ, the ops PyTorch names
     as nondeterministic are printed and the spread is the tolerance below.
     Run B: 3 iterations (SNAPSHOT_ITERS 3), then a new ``train_net`` on the
     same directory to 6, which must resume at 3; B's final state_dict
     equals A's bit for bit; the .pth/.pkl pairs on disk, pruned to
     SNAPSHOT_KEPT 1;
 21. (b) ``test_net`` at full width over the devkit's test split (16 images
     at 800x1216, batch 8, bf16, TEST.SCORE_THRESH 0.0): 20's model loaded
     from its final snapshot, and a seeded res50_fpn; detections.pkl read
     back, the per-class APs and the mAP finite in [0, 1], one graph
     replayed for the 2 batches with the launches of 12 and 14; images/s
     of each graphed, beside the same run eager and ``Detector``'s;
 22. (c) ``test_net`` in f32 over the devkit's 4 val images (320x480) on the
     card and on a CPU copy of the same model: detections matched one to
     one per image and class (the tolerances of 13); then ``im_detect`` of
     the first image on each (K1 once, K2 once on the card, the model moved
     there by default): its valid rois, rows of per-class scores and boxes,
     matched one to one;
 23. the GroupNorm FPN serving path: res50_fpn_gn (RESNET.FIXED_BLOCKS 0)
     with the JAX package's from-scratch init from a seed, bf16, the bucket,
     batch and requests of 14: the pyramid finite, the RPN's bf16 logits as
     in 14, launch counts per batch K5 2, K1 2, K6 1 and K3 0 (it folds a
     frozen BN), then the steady-state batch time and peak device memory;
 24. one image through the GroupNorm FPN's f32 ``detect`` on the card and on
     a CPU copy, matched one to one as in 15;
 25. the GroupNorm FPN train path: the shape, roidb and solver of 18 under
     the from-scratch recipe (FIXED_BLOCKS 0, GRAD_CLIP 10, warmup); on step
     1 every tensor, conv1 and the 53 GroupNorms' scales and biases
     included, has a non-zero gradient; launch counts per step K4 1, K5 3,
     K1 1, K6 1, K6b 1 and K3 0; finite losses; then the steady-state step
     time and the peak device memory;
 26. one f32 GroupNorm FPN train step on the card and on a CPU copy at lr
     1.0: the losses and the RPN's, box head's and neck's updates as in 19,
     and every tensor's update, the trunk's too, at cosine >= 0.99 with the
     CPU's or zero on both (a relu input within rounding of zero may pass a
     gradient on one device only, and each trunk tensor lies behind many
     relus);
 27. the VGG-16 serving path: vgg16 at full width (fc6/fc7 4096), as 12, with
     launch counts per batch K1 2, K2 1 and K3 0, the steady-state batch time
     and the peak device memory;
 28. one image through VGG-16's f32 ``detect`` on the card and on a CPU copy,
     matched one to one as in 13;
 29. the VGG-16 train path: the shape, roidb and solver of 16; launch counts
     per step K4 1, K5 2, K1 1, K2 1, K2b 1 (K3 0); finite losses;
     ``features.0/2/5/7`` (conv1_*, conv2_*) bit-unchanged, fc6 and fc7
     changed; the steady-state step time and the peak device memory;
 30. one f32 VGG-16 train step on the card and on a CPU copy with the same
     weights and draws, the dropout uniforms of fc6 and fc7 included, as 17;
 31-34. 27-30 for MobileNet-v1 at DEPTH_MULTIPLIER 1.0 (``conv0`` and
     ``sep1``..``sep4`` bit-unchanged; no dropout);
 35. POOLING_MODE "pool" and "crop" (plain PyTorch, as in the JAX package:
     K2 and K2b do not run): one f32 MobileNet ``detect`` and one f32 train
     step each on the card against a CPU copy (320x480);
 36. TEST.MODE "top": VGG-16, bf16, 3 requests of 8 at 800x1216 through
     ``Detector`` (K1 once a batch: the per-class NMS over 168 problems of
     5000 rois, cap 100; K2 once over 8 x 5000 rois), the steady-state batch
     time and peak memory; the per-class NMS of a served batch through K1 and
     through its twin: detections and valid masks equal;
 37. one image through VGG-16's f32 ``detect`` under TEST.MODE "top" (RPN_TOP_N
     300) on the card and on a CPU copy, matched one to one;
 38. (with ``--profile``) CUDA events around each stage of a steady-state
     train step and torch.profiler over 3 steps: stage times, the device's
     idle share, the top kernels and K4's device time (one launch a step),
     also in chiprun_out/profile_train.json;
 39. (with ``--profile``) the same for a steady-state FPN detect batch,
     into chiprun_out/profile_fpn.json;
 40. (with ``--profile``) the same (K4 too) for a steady-state FPN train step, into
     chiprun_out/profile_fpn_train.json, with every device kernel of the RoI
     pool's forward and backward alone (K6b one launch, no memset or
     rounding kernel);
 41. (with ``--profile``) the same for the GroupNorm FPN train step, into
     chiprun_out/profile_fpn_gn_train.json;
 42. (after 22, in the devkit) the cached ``train_net``: 20's run A with
     TRAIN.IMAGE_CACHE (run C): the resized-image cache built through the
     reader at <DATA_DIR>/cache/voc_2007_trainval_resized.{dat,idx} (one read
     an image, the build timed), every batch reaching the model as torch.uint8
     on the card, launch counts per step those of 16, every tensor on the
     card, finite losses, the median iteration time beside 20's and 16's
     step; C's final state_dict bit-equal to 20's straight run A where 20's
     two straight runs were bit-equal (the devkit's trainval images sit at
     the train scale, so the cached pixels are the reader's), else within
     their spread; run D to 3 with a snapshot and a new ``train_net`` to 6,
     both with 0 reader calls (the cache reused), against C by the same rule;
     one cached batch through ``train_step`` against the same batch cast to
     f32 from the same state and draws: losses and updates bit-equal;
 43. ``serve.throughput`` on 12's seeded res50 C4 (batch 8, 800x1216, bf16):
     images/s > 0, graphed beside eager, beside 8000 / 12's batch time and
     12's timing of its own noise batch, one graph replayed 22 times (2
     warm-up and 20 timed batches) with 12's launches;
 44. the host libraries on the card's machine: ``native.host_ops`` builds
     (g++) and loads; ``apply_nms`` over 21's C4 detections.pkl keeps the
     rows of ``nms_fixed(..., use_kernels=False)`` at 0.3 and 0.1;
     ``tools/reval.py`` on that directory returns and prints 21's APs; whether
     ``native.data_prep`` built (opencv4 dev files) is logged;
 45. the data mesh (``frcnn_tpu_torch/parallel``): 2 ranks, over NCCL with
     a card each where the machine has two cards, else over gloo sharing
     cuda:0 (NCCL refuses two ranks on one GPU), each phase logging the
     backend, the world and why; then a one-rank NCCL group.  One C4 train
     step (res50, phase 16's seeded weights, global batch 8 at 608x1024,
     4 images a rank) over the mesh and unsharded in this process from the
     same weights, minibatch and draws: in f32 (cudnn.deterministic, TF32
     off), the losses within 2e-4 relative, every updated tensor within rtol
     2e-4 / atol 2e-5, frozen tensors bit-unchanged, the replicas bit-equal;
     in bf16, finite losses and the step bit-equal to ``two_shard_step``
     (each rank's rows at the rank's batch shape in this process, the f32
     gradient mean, the clip, the update), the update's cosine with the
     global step logged; launch counts per rank and step those of 16, and 3
     more steps timed; the one-rank NCCL group's f32 step bit-equal to the
     unsharded one.  A witness of why bf16 is held to the two-shard step: K3
     on each rank's rows of its 6 batch-8 launches gives those rows bit for
     bit, while its cuDNN twin and the whole trunk differ (logged);
 46. the same for res50_fpn (launch counts those of 18);
 47. ``Detector`` over the mesh (res50 C4, 800x1216): 12's 3 requests of 8
     and one of 5 (padded to 6); every rank returns the same list, and each
     rank's rows are the unsharded bf16 ``Detector``'s on those rows bit for
     bit; in f32 (TF32 off) every image matched one to one (``match_dets``)
     with the unsharded ``Detector``'s on the whole request, in bf16 at
     least ``MESH_BF16_MATCHED`` of the 58; per rank two graphs (rows of 4
     and 3) launching K1 2, K2 1, K3 6 a replay; ``serve.throughput`` of a
     global batch of 8, graphed and eager, beside 12's batch time;
 48. (C) COCO serving: res101 C4, 81 classes, ANCHOR_SCALES (4, 8, 16, 32)
     (12 anchors a cell, 45600 at 800x1216), seeded weights, bf16 trunk, the
     bucket and 3 requests of 8 of 12 through ``Detector``: launch counts
     per batch K1 2 (the per-class NMS over 648 problems), K2 1, K3 6, K5 0
     (45600 < 24 x 6000 misses the gate), the steady-state batch time,
     images/s and peak memory; then one image in f32 on the card and on a
     CPU copy, matched one to one as in 13;
 49. (D) the C4 threshold route: 48's model and then 12's at
     TEST.RPN_PRE_NMS_TOP_N 1000 (45600 and 34200 >= 24 x 1000 open K5's
     gate), one batch of 8 with DEVICE.THRESHOLD_SELECT on and off: bf16
     detections and valid masks bit-equal, K5 1 a batch on and 0 off, the
     batch time of each;
 50. (E) COCO train -> test -> evaluate over a synthetic COCO written into a
     temporary directory (``write_coco_dataset``: instances_train2014.json
     and instances_minival2014.json with the 80 categories at their COCO
     ids, crowds, a zero-area annotation, one image of 70 annotations;
     empty placeholder images, pixels from a seeded reader; 16 training
     images and their flips, 16 minival images): the roidb's class map and
     crowds, the 70 gts cut to DEVICE.MAX_GT 64 in a minibatch;
     ``train_net`` (res101, 81 classes, four scales, batch 8, 608x1024,
     bf16) for 6 iterations, launches per step K4 1, K5 2 (29184 anchors),
     K1 1, K2 1, K2b 1, K3 6, finite losses, frozen tensors bit-unchanged,
     the median iteration beside the bare step and its peak memory; one f32
     train step on the card and on a CPU copy as 17; ``test_net`` over
     minival from the final snapshot (batch 8, 800x1216, SCORE_THRESH 0.0):
     the results json at COCO's category ids, the 12 stats finite in [-1,
     1], images/s beside 48's ``detect_blobs``; COCOEval's host seconds on
     those detections and on a minival-sized set (5000 images, 80
     categories, 100 dets an image), with the host's CPU model;
 51. graphed serving, on the models of 12, 14, 23, 27, 31, 36 and 48: for
     each a new ``Detector``, 3 requests of 8 at 800x1216 whose detections
     and (dets, valid) are bit-equal to eager ``model.detect`` on the same
     batches; the capture-time launches equal to eager detect's and to the
     device kernels of a profiled replay; eager and graphed batch ms (median
     of 10 after 2, CUDA events), the host ms of 10 queued calls, the
     device's idle share (torch.profiler), the capture's seconds and the
     peak memory with the graph captured; then two keys in one ``Detector``
     (B 8 at 800x1216 and B 3 at 1216x800, one pool) captured in one order
     and replayed in the other inside one request, bit-equal to eager, with
     the peak memory after the two captures; then a capture that fails (a
     host read in a toy ``detect``) raises naming its key and line, keeps
     and replays nothing, and a new capture still serves bit-equal; all in
     chiprun_out/graphed_serving.json.
Then one JSON line of per-kernel results, the card line, and, last, the
JSON ok line.  Each kernel's line carries its launches on the paths of 12,
14, 16, 18, 23, 25, 27, 29, 31, 33, 36, 43, 45-47 (rank 0's), 48 and 49
(``launches``, as the wrappers count them: eager calls, and a graph's
warm-up and capture; ``launches_by_path`` by path, with the driven runs of
20 (A), 21, 42 (C) and 50), each counted from zero; ``replayed_launches``
(by path: ``replayed_launches_by_path``), the launches the serving
phases' graph replays made,
its error against the twin, its time, the twin's, the time of the one
library call that computes the same function where there is one, and its
bound: the least time the card could take for the timed launches, from the
bytes they must move (inputs read once, of a RoIAlign's maps only the
pixels under a roi; outputs written once) and the operations they need,
over the H100's published rates.  TF32 is off for
convolutions and matmuls throughout, so f32 comparisons are f32.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types

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


# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12
IOU_FLOPS = 16            # one box pair: 4 min/max, 2 extents, product, union, quotient, compare
RESULTS_KEYS = ("ms", "plain_ms", "library_ms", "max_abs_err", "bound_ms", "bound_by")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class Bound:
    """The least time the card could take for the launches added to it: per
    launch the larger of bytes / HBM rate and operations / peak rate."""

    def __init__(self):
        self.ms = self.bytes_ms = self.ops_ms = 0.0

    def add(self, n_bytes: float, ops: float = 0.0, peak: float = F32_FLOPS, count: int = 1):
        b_ms, o_ms = n_bytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
        self.ms += count * max(b_ms, o_ms)
        self.bytes_ms += count * b_ms
        self.ops_ms += count * o_ms
        return max(b_ms, o_ms)

    def result(self) -> dict:
        return {"bound_ms": self.ms,
                "bound_by": "bytes" if self.bytes_ms >= self.ops_ms else "operations"}


def merge_results(*parts) -> dict:
    """One kernel's results over several checks: times and bounds add, the
    error is the worst, the bound's kind is that of the larger share."""
    out = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0, "library_ms": None}
    by = {"bytes": 0.0, "operations": 0.0}
    for part in parts:
        for key in ("ms", "plain_ms", "bound_ms"):
            out[key] += part[key]
        out["max_abs_err"] = max(out["max_abs_err"], part["max_abs_err"])
        by[part["bound_by"]] += part["bound_ms"]
        if part.get("library_ms") is not None:
            out["library_ms"] = (out["library_ms"] or 0.0) + part["library_ms"]
    out["bound_by"] = max(by, key=by.get)
    return out


def nms_pairs(keep, valid, cap=None):
    """Box pairs a greedy NMS of this data must compare: each kept box (the
    first ``cap`` of them) against every valid box after it."""
    n = keep.shape[1]
    pos = torch.arange(n, device=keep.device)
    counted = keep if cap is None else keep & (torch.cumsum(keep, 1) <= cap)
    after = torch.clamp(valid.sum(1, keepdim=True) - pos - 1, min=0)
    return int(torch.where(counted, after, 0).sum().item())


def bf16_ulp(scale: float) -> float:
    """One bf16 ulp (8 significant bits) at magnitude ``scale``."""
    return 2.0 ** (np.floor(np.log2(max(scale, 1e-30))) - 7)


def roi_tolerance(dtype, scale: float):
    """The RoIAlign kernels' tolerance against their twins, and its rule:
    f32 1e-5 of max|twin|, bf16 one bf16 ulp of max|twin|."""
    if dtype == torch.float32:
        return 1e-5 * scale, "1e-5 of max|twin|"
    return bf16_ulp(scale), "one bf16 ulp of max|twin|"


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


def check_capped_mask(name, boxes, thresh, valid, caps):
    """K1 with ``max_keep`` against the twin's uncapped mask cut after its
    first ``cap`` kept boxes, bit for bit, for each cap; returns the kernel's
    mask at the last cap."""
    from frcnn_tpu_torch.ops.cuda.nms_kernel import nms_mask_batched, nms_mask_reference

    full = nms_mask_reference(boxes, thresh, valid)
    order = torch.cumsum(full, 1)
    for cap in caps:
        keep = nms_mask_batched(boxes, thresh, valid, max_keep=cap)
        torch.cuda.synchronize()
        want = full & (order <= cap)
        if not torch.equal(keep, want):
            raise AssertionError(f"K1 {name} capped at {cap}: keep mask differs from the twin's "
                                 f"({(keep != want).sum().item()} bits)")
    kept = full.sum(1)
    log(f"K1 {name}: keep masks capped at {list(caps)} bit-equal to the twin's first kept boxes "
        f"(uncapped the twin keeps {kept.min().item()}-{kept.max().item()} a problem)")
    return keep


def check_nms(dev):
    from frcnn_tpu_torch.ops.cuda.nms_kernel import nms_mask_batched, nms_mask_reference
    from frcnn_tpu_torch.ops.nms import NEG_INF, nms_fixed_batched

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
    # the FPN proposal shape (4741 = 74 * 64 + 5 candidates, a partial last
    # block), fed as FPN ``_propose`` feeds it: sorted, the anchors centred
    # on padding last with score NEG_INF and valid = score > NEG_INF / 2
    b, n = 8, FPN_CANDIDATES
    boxes = random_boxes(rng, b, n, size=1216.0, clusters=60)
    boxes[0] = np.tile(boxes[0, :100], (n // 100 + 1, 1))[:n]   # 100 distinct: the walk
    scores = -np.sort(-rng.uniform(0, 1, (b, n)), axis=1).astype(np.float32)  # reaches the tail
    n_valid = rng.randint(2500, n + 1, b)
    n_valid[0], n_valid[1] = n, n - 1                  # no padding; one invalid in the tail
    scores[np.arange(n)[None, :] >= n_valid[:, None]] = NEG_INF
    fpn_args, fpn_kw = fixed(f"FPN proposals (8, {n}, t=0.7, cap 300)", boxes, scores,
                             scores > NEG_INF / 2, 0.7, 300, True)
    k = nms_mask_batched(fpn_args[0], 0.7, fpn_kw["valid"])
    t = nms_mask_reference(fpn_args[0], 0.7, fpn_kw["valid"])
    torch.cuda.synchronize()
    if not torch.equal(k, t):
        raise AssertionError(f"K1 FPN proposals uncapped: keep masks differ "
                             f"({(k != t).sum().item()} bits)")
    log(f"K1 FPN proposals uncapped (8, {n}, t=0.7): keep masks bit-equal, "
        f"{k[:, -(n % 64):].sum().item()} kept in the partial last block")
    # per-class shape: unsorted scores, score-threshold validity, cap 100
    b, n = 168, 300
    boxes = random_boxes(rng, b, n)
    scores = rng.uniform(0, 1, (b, n)).astype(np.float32)
    valid = scores > 0.2
    valid[::17] = False
    cls_args, cls_kw = fixed("per-class (168, 300, t=0.3, cap 100)", boxes, scores,
                             valid, 0.3, 100, False)
    # the per-class shape under TEST.MODE "top": RPN_TOP_N = 5000 rois a class
    top_rng = np.random.RandomState(16)
    b, n = 168, 5000
    boxes = random_boxes(top_rng, b, n, size=1216.0, clusters=120)
    scores = top_rng.uniform(0, 1, (b, n)).astype(np.float32)
    valid = scores > 0.05
    valid[::21] = False                                # the background class
    top_args, top_kw = fixed("per-class, TEST.MODE top (168, 5000, t=0.3, cap 100)", boxes,
                             scores, valid, 0.3, 100, False)
    # the COCO per-class shape: 8 images x 81 classes of 300 rois, the class
    # probabilities a softmax over 81 logits with one to three lifted per roi,
    # valid above TEST.SCORE_THRESH 0.05: most of each row is invalid
    coco_rng = np.random.RandomState(17)
    b, n = 8 * COCO_CLASSES, 300
    logits = coco_rng.normal(0, 1.5, (8, n, COCO_CLASSES))
    lifted = coco_rng.randint(0, COCO_CLASSES, (8, n, 3))
    np.put_along_axis(logits, lifted, coco_rng.uniform(2, 6, (8, n, 3)), axis=2)
    prob = np.exp(logits - logits.max(2, keepdims=True))
    prob /= prob.sum(2, keepdims=True)
    scores = prob.transpose(0, 2, 1).reshape(b, n).astype(np.float32)
    boxes = random_boxes(coco_rng, b, n, size=1216.0, clusters=40)
    valid = scores > 0.05
    coco_args, coco_kw = fixed(f"per-class COCO ({b}, {n}, t=0.3, cap 100; "
                               f"{valid.mean():.3f} of the rows valid)", boxes, scores, valid,
                               0.3, 100, False)

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
    bound = Bound()
    for name, args, kw, sort, iters in (("proposals", prop_args, prop_kw, False, 3),
                                        ("per_class", cls_args, cls_kw, True, 5),
                                        ("FPN proposals", fpn_args, fpn_kw, False, 3),
                                        ("per_class top", top_args, top_kw, True, 2),
                                        ("per_class COCO", coco_args, coco_kw, True, 3)):
        bx, thresh, vd, cap = mask_args(args, kw, sort)
        # the main path's cap, one inside the first chunk of 64 candidates, one
        # never reached, then the main path's again (the mask the bound counts)
        keep = check_capped_mask(f"{name} ({bx.shape[0]}, {bx.shape[1]}, t={thresh})", bx, thresh,
                                 vd, (1, 20, bx.shape[1] + 1, cap))
        k_ms = cuda_ms(lambda: nms_mask_batched(bx, thresh, vd, max_keep=cap))
        t_ms = cuda_ms(lambda: nms_mask_reference(bx, thresh, vd), iters=iters, warmup=1)
        b_ms = bound.add(nbytes(bx, vd, keep), nms_pairs(keep, vd, cap) * IOU_FLOPS)
        timings[name] = {"ms": k_ms, "plain_ms": t_ms, "bound_ms": b_ms}
        log(f"K1 time {name}: kernel {k_ms:.4f} ms, plain twin {t_ms:.4f} ms, bound {b_ms:.4f} ms")
    results["ms"] = sum(v["ms"] for v in timings.values())
    results["plain_ms"] = sum(v["plain_ms"] for v in timings.values())
    results["max_abs_err"] = float(max(errs))
    return {**results, **bound.result(), "by_shape": timings}


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------


ROI_FLOPS = 32   # per pooled value at sampling ratio 2: 4 samples x 4 corners x (mul, add)


def check_roi_align(dev):
    from frcnn_tpu_torch.ops.cuda.roi_align_kernel import (roi_align_forward,
                                                           roi_align_reference, staged_pixels)

    rng = np.random.RandomState(1)
    k_total = t_total = 0.0
    worst = 0.0
    bound = Bound()
    by_shape = {}
    # (name, B, H, W, C, rois per image, image size): the serving and train shapes
    # of the ResNet C4 nets (C 1024), of VGG-16 and MobileNet at width 1.0 (C 512,
    # and VGG-16's 5000 rois a image under TEST.MODE top) and of MobileNet at
    # width 0.25 (C 128)
    for name, b, h, w, c, r, size in (("serving", 8, 50, 76, 1024, 300, 1216.0),
                                      ("train", 8, 38, 64, 1024, 128, 1024.0),
                                      ("serving C512", 8, 50, 76, 512, 300, 1216.0),
                                      ("train C512", 8, 38, 64, 512, 128, 1024.0),
                                      ("top serving C512", 8, 50, 76, 512, 5000, 1216.0),
                                      ("serving C128", 8, 50, 76, 128, 300, 1216.0)):
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
            tol, rule = roi_tolerance(dtype, scale)
            if not err <= tol:
                raise AssertionError(f"K2 {name} {dtype}: max abs err {err} > {tol} ({rule})")
            log(f"K2 {name} {str(dtype)[6:]} ({b} x {h}x{w}x{c}, {r} rois): max abs err "
                f"{err:.3e} <= {tol:.3e} ({rule})")
        worst = max(worst, err)                                        # the bf16 error
        k_ms = cuda_ms(lambda: roi_align_forward(feat, rois_t))
        t_ms = cuda_ms(lambda: roi_align_reference(feat, rois_t), iters=5)
        k_total += k_ms
        t_total += t_ms
        read = roi_read_bytes(rois_t, torch.zeros_like(rois_t[..., 0]), [(h, w)], [1.0 / 16.0],
                              c, feat.element_size())
        b_ms = bound.add(read + nbytes(rois_t, k), k.numel() * ROI_FLOPS)
        staged = staged_pixels(rois_t, h, w).sum().item() / (16 * 49 * b * r)
        by_shape[name] = {"ms": k_ms, "plain_ms": t_ms, "bound_ms": b_ms}
        log(f"K2 time {name} bf16: kernel {k_ms:.4f} ms, plain twin {t_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({read / 1e6:.1f} of the map's {nbytes(feat) / 1e6:.1f} MB lie "
            f"under a roi; the pixels staged are {staged:.4f} of the 16 corner reads a bin)")
    # other channel counts (256: the FPN width; 1023: one channel a thread) and
    # rois at the ends of the staging: wider than 28 map columns (no pixel
    # shared, the most passes) and one pixel wide
    b, h, w, r, size = 2, 50, 76, 64, 1216.0
    rois = random_boxes(rng, b, r, size=size)
    rois[:, :8] = rng.uniform(-400, size + 400, (b, 8, 4))
    rois[:, 8:12] = [0.0, 0.0, size - 1.0, 799.0]                      # the whole map
    rois[:, 12:16] = [100.0, 300.0, 1100.0, 340.0]                     # 62 columns, 2 rows
    rois[:, 16:24, 2:] = rois[:, 16:24, :2] + 1.0                      # one pixel
    rois[:, 24:28] = 0.0
    rois_t = torch.from_numpy(rois).to(dev)
    for c in (1024, 256, 1023):
        feat32 = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32)).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            feat = feat32.to(dtype)
            k = roi_align_forward(feat, rois_t)
            t = roi_align_reference(feat, rois_t)
            torch.cuda.synchronize()
            err = (k.float() - t.float()).abs().max().item()
            tol, rule = roi_tolerance(dtype, t.float().abs().max().item())
            if not err <= tol:
                raise AssertionError(f"K2 C={c} {dtype}: max abs err {err} > {tol} ({rule})")
        log(f"K2 C={c} (2 x {h}x{w}, {r} rois; whole-map, 62-column and one-pixel rois), f32 and "
            f"bf16: within tolerance of the twin (bf16 err {err:.3e} <= {tol:.3e})")
    return {"ms": k_total, "plain_ms": t_total, "max_abs_err": worst, **bound.result(),
            "by_shape": by_shape}


def roi_read_bytes(rois, levels, hws, scales, c, element_size, p=7, sr=2):
    """Bytes of the level maps that a RoIAlign of these rois must read: a
    pixel counts once per image and level when some sample of some roi on that
    level gives it a non-zero bilinear weight; each holds ``c`` values.  rois
    (B, R, 4), levels (B, R) int; a level outside the list reads nothing."""
    def axis_hits(lo, hi, size):
        """(B, R, size): 1.0 where an index along this axis has weight."""
        bin_sz = torch.clamp(hi - lo, min=1.0) / p
        s = (torch.arange(p * sr, dtype=torch.float32, device=lo.device) + 0.5) / sr
        coords = lo[..., None] + s * bin_sz[..., None]
        inside = (coords >= -1.0) & (coords <= size)
        at = torch.clamp(coords, 0.0, size - 1.0)
        low = torch.floor(at)
        high = torch.clamp(low + 1, max=size - 1)
        hits = torch.zeros((*lo.shape, size), device=lo.device)
        hits.scatter_reduce_(2, low.long(), inside.float(), "amax")               # 1 - frac > 0
        hits.scatter_reduce_(2, high.long(), (inside & (at > low)).float(), "amax")
        return hits

    pixels = 0
    for lv, ((h, w), scale) in enumerate(zip(hws, scales)):
        scaled = rois.float() * scale
        rows = axis_hits(scaled[..., 1], scaled[..., 3], h) * (levels == lv)[..., None]
        cols = axis_hits(scaled[..., 0], scaled[..., 2], w)
        pixels += int((torch.einsum("brh,brw->bhw", rows, cols) > 0).sum().item())
    return pixels * c * element_size


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


def ptxas_report(build_log: str, symbol: str):
    """ptxas's registers and spill bytes for every compiled entry function
    whose mangled name holds ``symbol``, from nvcc's ``-Xptxas -v`` output."""
    found, name = [], None
    for line in build_log.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for")[1].strip()
            found.append({"function": name, "spill_stores": None, "spill_loads": None,
                          "registers": None})
        elif name and "spill stores" in line:
            nums = [int(tok) for tok in line.replace(",", " ").split() if tok.isdigit()]
            found[-1]["spill_stores"], found[-1]["spill_loads"] = nums[1], nums[2]
        elif name and "Used" in line and "registers" in line:
            found[-1]["registers"] = int(line.split("Used")[1].split("registers")[0])
            name = None
    return [f for f in found if symbol in f["function"]]


def check_fused_block(dev):
    from frcnn_tpu_torch.ops.cuda import build
    from frcnn_tpu_torch.ops.cuda.fused_block import (bottleneck_reference, fused_bottleneck,
                                                      fused_plan)

    g = torch.Generator().manual_seed(2)

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=g) * std).to(dev, torch.bfloat16)

    ptxas = ptxas_report(build.BUILD_LOG, "fused_bottleneck_kernel")
    for entry in ptxas:
        # the mangled name carries the template arguments: ILi<mid>ELb<projection>EE
        log(f"K3 ptxas {entry['function'].split('fused_bottleneck_kernel')[1][:14]}: "
            f"{entry['registers']} registers, spill stores {entry['spill_stores']} B, "
            f"loads {entry['spill_loads']} B")
    log(f"K3: one 512-thread block an SM; shared memory a block "
        f"{fused_plan(1, 1, 64, 256)['smem_bytes']} B (mid 64), "
        f"{fused_plan(1, 1, 128, 512)['smem_bytes']} B (mid 128)")

    k_total = t_total = 0.0
    worst = 0.0
    bound = Bound()
    by_shape = []
    buckets = {"800x1216": {"ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0},
               "608x1024": {"ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}}
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
        flops = 2.0 * 8 * h * w * (cin * mid + 9 * mid * mid + mid * cout
                                   + (cin * cout if proj else 0))
        b_ms = bound.add(nbytes(*(a for a in args if a is not None), k), flops,
                         BF16_TENSOR_FLOPS, count)
        if count:
            worst = max(worst, err)
        bucket = "608x1024" if name.startswith("train") else "800x1216"
        by_shape.append({"name": name, "bucket": bucket, "launches": count, "ms": k_ms,
                         "library_ms": t_ms, "bound_ms": b_ms})
        for key, val in (("ms", k_ms), ("library_ms", t_ms), ("bound_ms", b_ms)):
            buckets[bucket][key] += count * val
        log(f"K3 {name} x (8, {h}, {w}, {cin}) mid {mid}: max abs err {err:.3e} <= {tol:.3e} "
            f"(4 bf16 ulps of max|twin| {scale:.3f}), mean abs err {mean_err:.3e}; "
            f"kernel {k_ms:.4f} ms, plain twin (cuDNN bf16) {t_ms:.4f} ms, bound {b_ms:.4f} ms")
    for bucket, tot in buckets.items():
        log(f"K3 {bucket}, the 6 launches of a batch or step: kernel {tot['ms']:.4f} ms, cuDNN "
            f"bf16 {tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms")
    log(f"K3 time over the 12 main-path launches (6 per serving batch, 6 per train step): "
        f"kernel {k_total:.4f} ms, plain twin {t_total:.4f} ms; the twin is the library's "
        f"(cuDNN's) bf16 convolutions")
    return {"ms": k_total, "plain_ms": t_total, "library_ms": t_total, "max_abs_err": worst,
            **bound.result(), "by_shape": by_shape, "by_bucket": buckets, "ptxas": ptxas}


# ---------------------------------------------------------------------------
# The BN epilogue
# ---------------------------------------------------------------------------

L2_BYTES = 50 * 2 ** 20         # the H100's L2
EPILOGUE_ROIS = 8 * 300         # layer4's crops in a serving batch
# (name, (B, C, H, W), middle term, launches a batch): every frozen BN outside
# K3 in a res101 C4 serving batch of 8 at 608x1024
EPILOGUE_SHAPES = (
    ("stem", (8, 64, 304, 512), None, 1),
    ("layer2.0.conv1", (8, 128, 152, 256), None, 1),
    ("layer2.0.conv2", (8, 128, 76, 128), None, 1),
    ("layer2.0.conv3+shortcut", (8, 512, 76, 128), "shortcut", 1),
    ("layer3.0.conv1", (8, 256, 76, 128), None, 1),
    ("layer3.0.conv2", (8, 256, 38, 64), None, 1),
    ("layer3.0.conv3+shortcut", (8, 1024, 38, 64), "shortcut", 1),
    ("layer3.k.conv1/conv2", (8, 256, 38, 64), None, 44),
    ("layer3.k.conv3+residual", (8, 1024, 38, 64), "residual", 22),
    ("layer4.0.conv1", (EPILOGUE_ROIS, 512, 7, 7), None, 1),
    ("layer4.0.conv2", (EPILOGUE_ROIS, 512, 4, 4), None, 1),
    ("layer4.0.conv3+shortcut", (EPILOGUE_ROIS, 2048, 4, 4), "shortcut", 1),
    ("layer4.k.conv1/conv2", (EPILOGUE_ROIS, 512, 4, 4), None, 4),
    ("layer4.k.conv3+residual", (EPILOGUE_ROIS, 2048, 4, 4), "residual", 2),
)


def graphed_ms(fn, sets, launches=20):
    """Device ms a call of ``fn(*args)``: ``launches`` calls, cycling over the
    argument ``sets``, captured in one CUDA graph (as a served replay runs
    them: no host time between launches), the replay timed by ``cuda_ms``."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for args in sets[:2]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(launches):
            fn(*sets[i % len(sets)])
    ms = cuda_ms(graph.replay, iters=5, warmup=1) / launches
    del graph
    return ms


def epilogue_norm(c, g, dev):
    from frcnn_tpu_torch.models.backbones import FrozenBatchNorm

    bn = FrozenBatchNorm(c)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(c, generator=g) + 0.5)
        bn.bias.copy_(torch.randn(c, generator=g) * 0.2)
        bn.running_mean.copy_(torch.randn(c, generator=g) * 0.2)
        bn.running_var.copy_(torch.rand(c, generator=g) + 0.5)
    return bn.to(dev)


def check_bn_epilogue(dev):
    """The BN epilogue at every shape of a res101 C4 serving batch, in the
    form each site takes (no middle term, the identity residual, the
    projection shortcut with its own BN), relu on: bit-equal to its twin;
    timed (``graphed_ms``, over enough input copies that a replay reads more
    than L2 holds) beside the twin and the module-by-module path it replaces
    (``FrozenBatchNorm``'s fold and affine, ``+``, ``relu``); bound by its
    bytes (x, the residual or shortcut and the output, each once)."""
    import torch.nn.functional as F

    from frcnn_tpu_torch.ops.cuda import build
    from frcnn_tpu_torch.ops.cuda.bn_epilogue import (bn_epilogue, bn_epilogue_reference,
                                                      epilogue_plan)

    for entry in ptxas_report(build.BUILD_LOG, "bn_epilogue_kernel"):
        log(f"BN epilogue ptxas {entry['function'].split('bn_epilogue_kernel')[1][:10]}: "
            f"{entry['registers']} registers, spill stores {entry['spill_stores']} B, "
            f"loads {entry['spill_loads']} B")

    def module_path(x, o, bn, form, bn_ds):
        y = bn(x)
        if form == "residual":
            y = y + o
        elif form == "shortcut":
            y = y + bn_ds(o)
        return F.relu(y)

    g = torch.Generator().manual_seed(5)
    bound = Bound()
    total = {"ms": 0.0, "plain_ms": 0.0, "module_ms": 0.0}
    by_shape, launches = [], 0
    with torch.inference_mode():
        for name, (b, c, h, w), form, count in EPILOGUE_SHAPES:
            bn, bn_ds = epilogue_norm(c, g, dev), epilogue_norm(c, g, dev)
            n_bytes = (2 if form is None else 3) * b * c * h * w * 2
            sets = [tuple((torch.randn(b, c, h, w, device=dev) * 2).to(torch.bfloat16)
                          .contiguous(memory_format=torch.channels_last) for _ in range(2))
                    for _ in range(max(2, -(-2 * L2_BYTES // n_bytes)))]
            kw = (lambda o: {}) if form is None else (
                (lambda o: {"residual": o}) if form == "residual"
                else (lambda o: {"shortcut": o, "shortcut_bn": bn_ds}))
            for x, o in sets[:2]:
                got, want = bn_epilogue(x, bn, True, **kw(o)), bn_epilogue_reference(
                    x, bn, True, **kw(o))
                if not torch.equal(got, want):
                    err = (got.float() - want.float()).abs().max().item()
                    raise AssertionError(f"BN epilogue {name} {(b, c, h, w)}: differs from its "
                                         f"twin (max abs err {err})")
            ms = graphed_ms(lambda x, o: bn_epilogue(x, bn, True, **kw(o)), sets)
            plain_ms = graphed_ms(lambda x, o: bn_epilogue_reference(x, bn, True, **kw(o)), sets)
            module_ms = graphed_ms(lambda x, o: module_path(x, o, bn, form, bn_ds), sets)
            b_ms = bound.add(n_bytes, count=count)
            for key, val in (("ms", ms), ("plain_ms", plain_ms), ("module_ms", module_ms)):
                total[key] += count * val
            launches += count
            by_shape.append({"name": name, "shape": [b, c, h, w], "middle": form,
                             "launches": count, "plan": epilogue_plan(b * c * h * w, c),
                             "ms": ms, "plain_ms": plain_ms, "module_ms": module_ms,
                             "bound_ms": b_ms, "copies": len(sets)})
            log(f"BN epilogue {name} {(b, c, h, w)} x{count}: bit-equal to its twin; kernel "
                f"{ms:.4f} ms a launch, bound {b_ms:.4f} ({100 * b_ms / ms:.1f}%), twin "
                f"{plain_ms:.4f}, module path {module_ms:.4f}")
            del sets, got, want
            torch.cuda.empty_cache()
    log(f"BN epilogue, the {launches} launches of a res101 C4 serving batch (8 at 608x1024, "
        f"{EPILOGUE_ROIS} crops): kernel {total['ms']:.4f} ms, bound {bound.ms:.4f} ms "
        f"({100 * bound.ms / total['ms']:.1f}%), twin {total['plain_ms']:.4f} ms, module path "
        f"{total['module_ms']:.4f} ms")
    return {**total, "library_ms": None, "max_abs_err": 0.0, **bound.result(),
            "launches_a_batch": launches, "by_shape": by_shape}


# ---------------------------------------------------------------------------
# The train path's kernels: K1 at the train shape, K2b, K4, K5
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_H, TRAIN_W = 8, 608, 1024        # batch and bucket of the train path
TRAIN_FEAT = (TRAIN_H // 16, TRAIN_W // 16)      # 38 x 64 C4 features
FPN_TRAIN_LEVELS = ((152, 256), (76, 128), (38, 64), (19, 32))   # P2-P5 of 608x1024
FPN_TRAIN_ANCHORS = 3 * (sum(h * w for h, w in FPN_TRAIN_LEVELS) + 10 * 16)   # + P6: 155520
FPN_TRAIN_CANDIDATES = 4 * 2000 + 10 * 16 * 3   # top 2000 of P2-P5 and all of P6: 8480


def check_nms_train(dev):
    from frcnn_tpu_torch.ops.cuda.nms_kernel import nms_mask_batched, nms_mask_reference
    from frcnn_tpu_torch.ops.nms import nms_fixed_batched

    rng = np.random.RandomState(6)
    cap = 2000
    parts = []
    # the C4 train proposals (top 12000 of 21888) and the FPN train candidates
    # (top 2000 of P2-P5 and all 480 of P6)
    for name, n, n_valid_min in (("C4 train", 12000, 9000),
                                 ("FPN train", FPN_TRAIN_CANDIDATES, 6000)):
        b = TRAIN_B
        boxes = torch.from_numpy(random_boxes(rng, b, n, size=1000.0, clusters=120)).to(dev)
        scores = torch.from_numpy(-np.sort(-rng.uniform(0, 1, (b, n)), axis=1)
                                  .astype(np.float32)).to(dev)
        valid = torch.from_numpy(np.arange(n)[None, :]
                                 < rng.randint(n_valid_min, n + 1, (b, 1))).to(dev)
        ki, kv = nms_fixed_batched(boxes, scores, 0.7, cap, valid=valid, presorted=True)
        ti, tv = nms_fixed_batched(boxes, scores, 0.7, cap, valid=valid, presorted=True,
                                   use_kernels=False)
        torch.cuda.synchronize()
        if not (torch.equal(ki, ti) and torch.equal(kv, tv)):
            raise AssertionError(f"K1 {name} shape: nms_fixed_batched idx/valid differ from "
                                 "the twin")
        keep = check_capped_mask(f"{name} (8, {n}, t=0.7)", boxes, 0.7, valid, (20, n + 1, cap))
        k_ms = cuda_ms(lambda: nms_mask_batched(boxes, 0.7, valid, max_keep=cap))
        t_ms = cuda_ms(lambda: nms_mask_reference(boxes, 0.7, valid), iters=3, warmup=1)
        bound = Bound()
        bound.add(nbytes(boxes, valid, keep), nms_pairs(keep, valid, cap) * IOU_FLOPS)
        log(f"K1 {name} shape (8, {n}, t=0.7, cap 2000): idx/valid equal to the twin, kept per "
            f"problem {kv.sum(1).float().mean().item():.1f}; kernel {k_ms:.4f} ms, "
            f"plain twin {t_ms:.4f} ms, bound {bound.ms:.4f} ms")
        parts.append({"ms": k_ms, "plain_ms": t_ms, **bound.result(),
                      "max_abs_err": float((ki.long() - ti.long()).abs().max().item())})
    return merge_results(*parts)


# backward plans timed beside the default (tile rows, tile columns, channel chunk)
BWD_PLANS = ((8, 8, 128), (8, 8, 64), (16, 8, 64), (16, 16, 32))


def time_bwd_plans(call, c, element_size):
    """The kernel's time under each of BWD_PLANS: {"HxW/chunk": ms}."""
    from frcnn_tpu_torch.ops.cuda.roi_align_kernel import roi_bwd_plan

    out = {}
    for th, tw, chunk in BWD_PLANS:
        plan = roi_bwd_plan(c, element_size, tile=(th, tw), chunk=chunk)
        out[f"{th}x{tw}/{plan['chunk']}"] = cuda_ms(lambda: call(plan))
    return out


def check_twice(name, call):
    """The kernel called twice on the same inputs gives the same bits."""
    first, second = call(), call()
    torch.cuda.synchronize()
    first, second = (x if isinstance(x, (list, tuple)) else [x] for x in (first, second))
    if not all(torch.equal(a.view(torch.int8), b.view(torch.int8))
               for a, b in zip(first, second)):
        raise AssertionError(f"{name}: two calls on the same inputs differ")


def check_roi_align_bwd(dev):
    from frcnn_tpu_torch.ops.cuda.roi_align_kernel import (roi_align_backward,
                                                           roi_align_backward_reference)

    rng = np.random.RandomState(7)
    b, r = TRAIN_B, 128
    h, w = TRAIN_FEAT
    rois = random_boxes(rng, b, r, size=1000.0)
    rois[:, :10] = rng.uniform(-400, 1400, (b, 10, 4))             # partly / wholly outside
    rois[:, 10:15, 2:] = rois[:, 10:15, :2]                        # zero size
    rois[:, 15:20] = 0.0                                           # padding rois
    rois_t = torch.from_numpy(rois).to(dev)
    out, by_shape, plans = {}, {}, None
    bound = Bound()
    # the ResNet C4 train shape (C 1024), VGG-16's and MobileNet's (C 512), and
    # MobileNet's at width 0.25 (C 128)
    for c in (1024, 512, 128):
        g32 = torch.from_numpy(rng.randn(b, r, 7, 7, c).astype(np.float32)).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            g = g32.to(dtype)
            k = roi_align_backward(g, rois_t, (h, w))
            t = roi_align_backward_reference(g, rois_t, (h, w))
            torch.cuda.synchronize()
            if k.dtype != dtype or k.shape != (b, h, w, c):
                raise AssertionError(f"K2b C={c} {dtype}: got {k.dtype} {tuple(k.shape)}")
            err = (k.float() - t.float()).abs().max().item()
            scale = t.float().abs().max().item()
            tol, rule = roi_tolerance(dtype, scale)
            if not err <= tol:
                raise AssertionError(f"K2b C={c} {dtype}: max abs err {err} > {tol} ({rule})")
            check_twice(f"K2b C={c} {dtype}", lambda: roi_align_backward(g, rois_t, (h, w)))
            log(f"K2b {str(dtype)[6:]} (dOut 8 x 128 x 7x7x{c} -> dF 8 x 38x64x{c}): max abs "
                f"err {err:.3e} <= {tol:.3e} ({rule}, max|twin| {scale:.3f}); two calls "
                "bit-equal")
            out[dtype] = max(out.get(dtype, 0.0), err)
        k_ms = cuda_ms(lambda: roi_align_backward(g, rois_t, (h, w)))
        t_ms = cuda_ms(lambda: roi_align_backward_reference(g, rois_t, (h, w)), iters=5)
        b_ms = bound.add(nbytes(g, rois_t, k), g.numel() * ROI_FLOPS)
        by_shape[f"C{c}"] = {"ms": k_ms, "plain_ms": t_ms, "bound_ms": b_ms}
        if plans is None:
            plans = time_bwd_plans(
                lambda plan: roi_align_backward(g, rois_t, (h, w), plan=plan), c,
                g.element_size())
        log(f"K2b time bf16 C={c}: kernel {k_ms:.4f} ms, plain twin {t_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms" + (f"; by plan (tile/chunk) {plans}" if c == 1024 else ""))
    return {"ms": sum(v["ms"] for v in by_shape.values()),
            "plain_ms": sum(v["plain_ms"] for v in by_shape.values()),
            "max_abs_err": out[torch.bfloat16], **bound.result(), "by_plan": plans,
            "by_shape": by_shape}


def check_roi_align_ml_bwd(dev):
    from frcnn_tpu_torch.ops.cuda.roi_align_kernel import (
        roi_align_backward, roi_align_multilevel_backward,
        roi_align_multilevel_backward_reference)

    rng = np.random.RandomState(12)
    b, r, c = TRAIN_B, 128, 256
    hws = FPN_TRAIN_LEVELS
    rois = random_boxes(rng, b, r, size=1000.0)
    rois[:, :10] = rng.uniform(-400, 1400, (b, 10, 4))             # partly / wholly outside
    rois[:, 10:15, 2:] = rois[:, 10:15, :2]                        # zero size
    rois[:, 15:20] = 0.0                                           # padding rois
    rois_t = torch.from_numpy(rois).to(dev)
    g32 = torch.from_numpy(rng.randn(b, r, 7, 7, c).astype(np.float32)).to(dev)
    every = torch.from_numpy(rng.randint(0, 4, (b, r)).astype(np.int32)).to(dev)
    one_empty = torch.where(every == 2, 1, every).to(torch.int32)

    worst = 0.0
    for case, levels in (("every level populated", every), ("level 2 empty", one_empty)):
        for dtype in (torch.float32, torch.bfloat16):
            g = g32.to(dtype)
            k = roi_align_multilevel_backward(g, rois_t, levels, hws, FPN_STRIDES)
            t = roi_align_multilevel_backward_reference(g, rois_t, levels, hws, FPN_STRIDES)
            torch.cuda.synchronize()
            scale = max(x.float().abs().max().item() for x in t)
            tol, rule = roi_tolerance(dtype, scale)
            err = 0.0
            for kl, tl, hw in zip(k, t, hws):
                if kl.dtype != dtype or kl.shape != (b, *hw, c):
                    raise AssertionError(f"K6b {case} {dtype}: got {kl.dtype} {tuple(kl.shape)}")
                err = max(err, (kl.float() - tl.float()).abs().max().item())
            if not err <= tol:
                raise AssertionError(f"K6b {case} {dtype}: max abs err {err} > {tol} ({rule})")
            if case == "level 2 empty" and k[2].any():
                raise AssertionError(f"K6b {case} {dtype}: the empty level's gradient is not zero")
            check_twice(f"K6b {case} {dtype}", lambda: roi_align_multilevel_backward(
                g, rois_t, levels, hws, FPN_STRIDES))
            if dtype == torch.bfloat16:
                worst = max(worst, err)
            log(f"K6b {case} {str(dtype)[6:]} (dOut 8 x 128 x 7x7x256 -> dF P2-P5 of 608x1024): "
                f"max abs err {err:.3e} <= {tol:.3e} ({rule}, max|twin| {scale:.3f}); two calls "
                "bit-equal")
            del k, t
    # every roi on P4: K6b and K2b add the same values in the same order
    on_p4 = torch.full_like(every, 2)
    for dtype in (torch.float32, torch.bfloat16):
        g = g32.to(dtype)
        k6b = roi_align_multilevel_backward(g, rois_t, on_p4, hws, FPN_STRIDES)
        k2b = roi_align_backward(g, rois_t, hws[2], 7, 1.0 / FPN_STRIDES[2], 2)
        torch.cuda.synchronize()
        if not torch.equal(k6b[2].view(torch.int8), k2b.view(torch.int8)) or any(
                k6b[i].any() for i in (0, 1, 3)):
            raise AssertionError(f"K6b on one level {dtype}: not bit-equal to K2b, or another "
                                 "level is not zero")
        log(f"K6b with every roi on P4, {str(dtype)[6:]}: bit-equal to K2b on P4; P2, P3, P5 all "
            "zero")
        del k6b, k2b
    g = g32.to(torch.bfloat16)
    k_ms = cuda_ms(lambda: roi_align_multilevel_backward(g, rois_t, every, hws, FPN_STRIDES))
    t_ms = cuda_ms(lambda: roi_align_multilevel_backward_reference(g, rois_t, every, hws,
                                                                   FPN_STRIDES), iters=5)
    plans = time_bwd_plans(lambda plan: roi_align_multilevel_backward(
        g, rois_t, every, hws, FPN_STRIDES, plan=plan), c, g.element_size())
    bound = Bound()
    out_bytes = sum(b * h * w * c for h, w in hws) * g.element_size()
    bound.add(nbytes(g, rois_t, every) + out_bytes, g.numel() * ROI_FLOPS)
    log(f"K6b time bf16 (every level populated): kernel {k_ms:.4f} ms, plain twin {t_ms:.4f} ms, "
        f"bound {bound.ms:.4f} ms ({out_bytes / 1e6:.1f} MB of dF written once); by plan "
        f"(tile/chunk) {plans}")
    return {"ms": k_ms, "plain_ms": t_ms, "max_abs_err": worst, **bound.result(),
            "by_plan": plans}


def fpn_train_anchors():
    """The FPN model's anchor table at 608x1024: P2-P6, one size a level."""
    from frcnn_tpu_torch.ops.anchors import generate_anchors_pre

    levels = FPN_TRAIN_LEVELS + ((10, 16),)
    return np.concatenate([generate_anchors_pre(h, w, 2 ** lv, scales=(8.0,))[0]
                           for lv, (h, w) in enumerate(levels, start=2)])


def overlap_inputs(rng, dev, anchors):
    """Train-shape anchors and padded gt: 3-64 valid gt per image, exact
    anchor copies, duplicated gt (argmax ties), a gt overlapping nothing,
    images smaller than the bucket (anchors outside), an image with no valid
    gt (1), one with every anchor outside (2), and in image 3 gts whose edge
    touches the box of one chunk's inside anchors exactly (iw = 0 or ih = 0:
    the kernel culls them for that chunk) or overlaps it by one pixel."""
    k = len(anchors)
    b, g = TRAIN_B, 64
    xy = rng.uniform(0, 900, (b, g, 2))
    wh = rng.uniform(16, 400, (b, g, 2))
    gt = np.round(np.concatenate([xy, xy + wh], axis=-1) / 8) * 8   # grid-aligned ties
    gt = gt.astype(np.float32)
    gt[:, :4] = anchors[rng.randint(0, k, (b, 4))]                  # IoU exactly 1
    gt[:, 4] = gt[:, 5]                                             # duplicate gt
    gt[:, 6] = [5000.0, 5000.0, 5010.0, 5010.0]                     # overlaps nothing
    n_valid = rng.randint(3, g + 1, b)
    n_valid[0], n_valid[1], n_valid[3] = g, 0, max(n_valid[3], 10)
    valid = np.arange(g)[None, :] < n_valid[:, None]
    hw = np.stack([rng.randint(400, TRAIN_H + 1, b), rng.randint(600, TRAIN_W + 1, b)], 1)
    hw[0] = (TRAIN_H, TRAIN_W)
    inside = ((anchors[None, :, 0] >= 0) & (anchors[None, :, 1] >= 0)
              & (anchors[None, :, 2] < hw[:, 1:2]) & (anchors[None, :, 3] < hw[:, 0:1]))
    inside[2] = False
    chunks = np.flatnonzero(inside[3, :k // 32 * 32].reshape(-1, 32).sum(1) >= 16)
    c = chunks[len(chunks) // 2]
    box = anchors[32 * c:32 * c + 32][inside[3, 32 * c:32 * c + 32]]
    x1, y1 = box[:, :2].min(0)
    x2, y2 = box[:, 2:].max(0)
    gt[3, 7] = [x2 + 1, y1, x2 + 60, y2]                            # iw = 0 exactly
    gt[3, 8] = [x2, y1, x2 + 60, y2]                                # iw = 1
    gt[3, 9] = [x1, y2 + 1, x2, y2 + 60]                            # ih = 0 exactly
    return tuple(torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                 for v in (anchors, gt, valid, inside))


def overlap_pairs(anchors, gt, valid, inside):
    """(image, inside anchor, valid gt) pairs with inter > 0: the IoUs the
    data needs (the twin's dense IoU, computed in slices)."""
    from frcnn_tpu_torch.ops.boxes import bbox_overlaps

    n = 0
    for i in range(gt.shape[0]):
        live = (bbox_overlaps(anchors[inside[i]], gt[i, valid[i]]) > 0)
        n += int(live.sum().item())
    return n


def overlap_device_ms(args):
    """The device time of one K4 call (torch.profiler); fails unless the
    call's only device operation is one K4 kernel: no memset."""
    from frcnn_tpu_torch.ops.cuda.overlap_kernel import anchor_overlap_stats

    _, kernels = device_profile(lambda: anchor_overlap_stats(*args), n_steps=5)
    # (the profiler may drop an interval at the window's edge: at most one launch a call)
    if len(kernels) != 1 or not 0.0 < kernels[0][2] <= 1.0 or "overlap" not in kernels[0][0]:
        raise AssertionError(f"K4: want one kernel a call and no memset, got {kernels}")
    return kernels[0][1] / kernels[0][2]


def check_overlap(dev):
    from frcnn_tpu_torch.ops.cuda.overlap_kernel import (anchor_overlap_stats,
                                                         anchor_overlap_stats_reference)

    from frcnn_tpu_torch.ops.anchors import generate_anchors_pre

    rng = np.random.RandomState(8)
    parts = {}
    for name, anchors in (("C4 train", generate_anchors_pre(*TRAIN_FEAT, 16)[0]),
                          ("FPN train", fpn_train_anchors()),
                          ("COCO C4 train", generate_anchors_pre(*TRAIN_FEAT, 16,
                                                                 scales=(4, 8, 16, 32))[0])):
        args = overlap_inputs(rng, dev, anchors)
        got = anchor_overlap_stats(*args)
        want = anchor_overlap_stats_reference(*args)
        torch.cuda.synchronize()
        for out, k, t in zip(("max_overlaps", "argmax", "is_gt_argmax"), got, want):
            if k.dtype != t.dtype or not torch.equal(k, t):
                raise AssertionError(f"K4 {name} {out}: not bit-equal to the twin "
                                     f"({(k != t).sum().item()} differ)")
        device_ms = overlap_device_ms(args)
        k_ms = cuda_ms(lambda: anchor_overlap_stats(*args))
        t_ms = cuda_ms(lambda: anchor_overlap_stats_reference(*args))
        pairs = overlap_pairs(*args)
        bound = Bound()
        bound.add(nbytes(*args, *got), pairs * IOU_FLOPS)
        log(f"K4 {name} ({len(anchors)} anchors, 8 x 64 padded gt, {int(args[2].sum())} valid; "
            "image 1 no valid gt, image 2 every anchor outside, image 3 gts touching a chunk's "
            "box): max_overlaps, argmax, is_gt_argmax bit-equal to the twin "
            f"({got[2].sum().item()} gt-argmax anchors, {(got[0] == 1.0).sum().item()} at IoU "
            f"1); kernel {k_ms:.4f} ms a call, on the device {device_ms:.4f} ms in one "
            f"kernel and no memset; plain twin {t_ms:.4f} ms; bound {bound.ms:.4f} ms "
            f"({pairs} pairs with inter > 0)")
        parts[name] = {"ms": k_ms, "plain_ms": t_ms, **bound.result(),
                       "max_abs_err": (got[0] - want[0]).abs().max().item(),
                       "device_ms": device_ms}
    out = merge_results(*parts.values())
    out["device_ms"] = sum(p["device_ms"] for p in parts.values())
    out["by_shape"] = parts
    return out


def check_select(dev):
    from frcnn_tpu_torch.ops.anchors import generate_anchors_pre
    from frcnn_tpu_torch.ops.cuda.select_kernel import (topk_descending, topk_threshold,
                                                        topk_threshold_reference)
    from frcnn_tpu_torch.ops.nms import NEG_INF

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
    # ties at the cut in several segments of the cluster's decomposition: at
    # S = 182400 three values scattered (every block holds ties) and in three
    # runs (the middle run crosses every segment boundary; r is spent in
    # index order across blocks), for all eight rows and for B = 1; a row
    # length that is no multiple of 4 (scalar loads, segments that start
    # unaligned) and one below the cluster size (blocks that own nothing)
    long_s = 3 * FPN_LEVELS[0][0] * FPN_LEVELS[0][1]
    three = rng.randint(0, 3, (b, long_s)).astype(np.float32)
    runs = np.ascontiguousarray(np.sort(three, axis=1)[:, ::-1])
    for name, arr in (("three values", three), ("three runs", runs)):
        tens = torch.from_numpy(arr).to(dev)
        for k in (1000, long_s // 2, long_s - 1):
            same(f"{name} (8, {long_s})", tens, k)
            same(f"{name} (1, {long_s})", tens[3:4].contiguous(), k)
    ragged = torch.from_numpy(rng.randint(-3, 4, (b, n + 3)).astype(np.float32)).to(dev)
    for k in (1, 256, n + 3):
        same(f"ties, S = {n + 3} (no multiple of 4)", ragged, k)
    tiny = torch.from_numpy(rng.randint(0, 3, (b, 5)).astype(np.float32)).to(dev)
    for k in (1, 3, 5):
        same("S = 5 (below the cluster size)", tiny, k)
    k_ms = sum(cuda_ms(lambda kind=kind, k=k: topk_threshold(prios[kind], k))
               for kind, k in (("fg", 128), ("bg", 256)))
    t_ms = sum(cuda_ms(lambda kind=kind, k=k: topk_threshold_reference(prios[kind], k))
               for kind, k in (("fg", 128), ("bg", 256)))
    log(f"K5 ((8, {n}) production priorities at k 128 and 256; rows of ties, NaN and +-inf at "
        f"k 1..S; ties across the cluster's segments at (8, {long_s}) and (1, {long_s}); "
        f"S = {n + 3} and S = 5): indices and value bits equal to the twin; kernel {k_ms:.4f} ms, "
        f"plain twin (stable sort) {t_ms:.4f} ms for the two launches")
    # the FPN serving rows: P2 and P3 of 800x1216 (3 anchors a cell), k 1000,
    # probabilities on a grid (runs of exact ties, as over padding)
    fpn = {}
    for name, (h, w) in (("P2", FPN_LEVELS[0]), ("P3", FPN_LEVELS[1])):
        p = np.round(rng.uniform(0, 1, (b, 3 * h * w)) * 4096) / 4096
        fpn[name] = torch.from_numpy(p.astype(np.float32)).to(dev)
        same(f"FPN {name} {tuple(p.shape)}", fpn[name], 1000)
    fk_ms = sum(cuda_ms(lambda v=v: topk_threshold(v, 1000)) for v in fpn.values())
    ft_ms = sum(cuda_ms(lambda v=v: topk_threshold_reference(v, 1000)) for v in fpn.values())
    log(f"K5 FPN serving rows (8, 182400) and (8, 45600), k 1000, with ties: indices and value "
        f"bits equal to the twin; kernel {fk_ms:.4f} ms, plain twin (stable sort) "
        f"{ft_ms:.4f} ms for the two launches")
    # the FPN train step's rows: the anchor subsampling priorities over all
    # 155520 level anchors (k 128 and 256) and P2's probabilities (k 2000)
    n = FPN_TRAIN_ANCHORS
    ramp = np.arange(n, dtype=np.float32) * np.float32(2.0 ** -17)
    u = rng.uniform(0, 1, (b, n)).astype(np.float32)
    rows = []
    for frac, k in ((0.001, 128), (0.6, 256)):
        mask = rng.uniform(0, 1, (b, n)) < frac
        pri = np.where(mask, np.float32(1.0) + u, np.float32(-1.0) - ramp).astype(np.float32)
        rows.append((torch.from_numpy(pri).to(dev), k))
    p2 = np.round(rng.uniform(0, 1, (b, 3 * 152 * 256)) * 4096) / 4096
    rows.append((torch.from_numpy(p2.astype(np.float32)).to(dev), 2000))
    for v, k in rows:
        same(f"FPN train row {tuple(v.shape)}", v, k)
    tk_ms = sum(cuda_ms(lambda v=v, k=k: topk_threshold(v, k)) for v, k in rows)
    tt_ms = sum(cuda_ms(lambda v=v, k=k: topk_threshold_reference(v, k)) for v, k in rows)
    log(f"K5 FPN train rows (8, {n}) k 128 and 256, (8, 116736) k 2000: indices and value bits "
        f"equal to the twin; kernel {tk_ms:.4f} ms, plain twin (stable sort) {tt_ms:.4f} ms for "
        f"the three launches")
    # the COCO C4 train rows: the anchor subsampling priorities over 38 x 64 x
    # 12 = 29184 anchors (four scales), k 128 and 256
    n = TRAIN_FEAT[0] * TRAIN_FEAT[1] * 12
    ramp = np.arange(n, dtype=np.float32) * np.float32(2.0 ** -17)
    u = rng.uniform(0, 1, (b, n)).astype(np.float32)
    coco_rows = []
    for frac, k in ((0.004, 128), (0.6, 256)):
        mask = rng.uniform(0, 1, (b, n)) < frac
        pri = np.where(mask, np.float32(1.0) + u, np.float32(-1.0) - ramp).astype(np.float32)
        coco_rows.append((torch.from_numpy(pri).to(dev), k))
    # the C4 proposal rows under the threshold route (TEST.RPN_PRE_NMS_TOP_N
    # 1000): RPN probabilities over 50 x 76 x 12 = 45600 (COCO) and 50 x 76 x 9
    # = 34200 (VOC) anchors at 800x1216, on a grid (runs of ties), NEG_INF on
    # the anchors centred on the padding of the 600x912 images (every other row)
    prop_rows = []
    for scales in ((4, 8, 16, 32), (8, 16, 32)):
        anchors = generate_anchors_pre(50, 76, 16, scales=scales)[0]
        cx, cy = (anchors[:, 0] + anchors[:, 2]) / 2, (anchors[:, 1] + anchors[:, 3]) / 2
        p = (np.round(rng.uniform(0, 1, (b, len(anchors))) * 4096) / 4096).astype(np.float32)
        p[1::2, (cx >= 912) | (cy >= 600)] = NEG_INF
        prop_rows.append((torch.from_numpy(p).to(dev), 1000))
    for v, k in coco_rows + prop_rows:
        same(f"C4 row {tuple(v.shape)}", v, k)
    ck_ms = sum(cuda_ms(lambda v=v, k=k: topk_threshold(v, k)) for v, k in coco_rows)
    ct_ms = sum(cuda_ms(lambda v=v, k=k: topk_threshold_reference(v, k)) for v, k in coco_rows)
    pk_ms = sum(cuda_ms(lambda v=v, k=k: topk_threshold(v, k)) for v, k in prop_rows)
    pt_ms = sum(cuda_ms(lambda v=v, k=k: topk_threshold_reference(v, k)) for v, k in prop_rows)
    for v, k in prop_rows:                 # the proposal layer's route: K5, the k re-ranked
        sc, idx = topk_descending(v, k, use_threshold=True)
        want_sc, want_idx = torch.sort(v, dim=1, descending=True, stable=True)
        if not (torch.equal(idx, want_idx[:, :k]) and torch.equal(sc, want_sc[:, :k])):
            raise AssertionError(f"K5 route {tuple(v.shape)} k {k}: not the stable sort's first k")
    route_ms = sum(cuda_ms(lambda v=v, k=k: topk_descending(v, k, use_threshold=True))
                   for v, k in prop_rows)
    stable_ms = sum(cuda_ms(lambda v=v: torch.sort(v, dim=1, descending=True, stable=True))
                    for v, _ in prop_rows)
    log(f"K5 COCO train rows (8, {n}) k 128 and 256, C4 proposal rows (8, 45600) and (8, 34200) "
        f"k 1000 with a NEG_INF tail: indices and value bits equal to the twin; kernel "
        f"{ck_ms:.4f} and {pk_ms:.4f} ms, plain twin (stable sort) {ct_ms:.4f} and {pt_ms:.4f} "
        f"ms for the two launches each; the proposal route (kernel + stable re-rank of the "
        f"1000) {route_ms:.4f} ms, the first 1000 of its full stable sort bit for bit, against "
        f"that sort's {stable_ms:.4f} ms")
    # every timed launch once more: its bound (the row read once, k values
    # and indices written) and the library's calls for the same top-k
    groups = (("C4 train rows", [(prios["fg"], 128), (prios["bg"], 256)], k_ms),
              ("FPN serving rows", [(v, 1000) for v in fpn.values()], fk_ms),
              ("FPN train rows", rows, tk_ms),
              ("COCO C4 train rows", coco_rows, ck_ms),
              ("C4 proposal rows", prop_rows, pk_ms))
    bound = Bound()
    topk_ms = sort_ms = 0.0
    by_group = {}
    for name, timed, kernel_ms in groups:
        g_topk = sum(cuda_ms(lambda v=v, k=k: torch.topk(v, k, dim=1)) for v, k in timed)
        g_sort = sum(cuda_ms(lambda v=v: torch.sort(v, dim=1, descending=True)) for v, _ in timed)
        g_bound = sum(bound.add(nbytes(v) + v.shape[0] * k * 8, v.numel()) for v, k in timed)
        log(f"K5 {name}, {len(timed)} launches: kernel {kernel_ms:.4f} ms, torch.topk "
            f"{g_topk:.4f} ms, torch.sort {g_sort:.4f} ms, bound {g_bound:.4f} ms")
        topk_ms += g_topk
        sort_ms += g_sort
        by_group[name] = {"ms": kernel_ms, "library_ms": g_topk, "library_sort_ms": g_sort,
                          "bound_ms": g_bound}
    by_group["C4 proposal rows"].update(route_ms=route_ms, stable_sort_ms=stable_ms)
    total = k_ms + fk_ms + tk_ms + ck_ms + pk_ms
    log(f"K5 over its 11 timed launches: kernel {total:.4f} ms, torch.topk {topk_ms:.4f} ms, "
        f"torch.sort {sort_ms:.4f} ms, bound {bound.ms:.4f} ms")
    return {"ms": total, "plain_ms": t_ms + ft_ms + tt_ms + ct_ms + pt_ms, "library_ms": topk_ms,
            "library_sort_ms": sort_ms, "max_abs_err": 0.0, **bound.result(),
            "by_group": by_group}


# ---------------------------------------------------------------------------
# The FPN serving path's kernels: K6, and K1 for one problem (K1b)
# ---------------------------------------------------------------------------

FPN_LEVELS = ((200, 304), (100, 152), (50, 76), (25, 38))   # P2-P5 of 800x1216
FPN_STRIDES = (4, 8, 16, 32)
FPN_CANDIDATES = 4 * 1000 + 13 * 19 * 3   # top 1000 of P2-P5 and all of P6: 4741


def check_roi_align_ml(dev):
    from frcnn_tpu_torch.ops.cuda.roi_align_kernel import (roi_align_forward,
                                                           roi_align_multilevel_forward,
                                                           roi_align_multilevel_reference)

    rng = np.random.RandomState(10)
    b, c = 8, 256
    worst = k_total = t_total = 0.0
    bound = Bound()
    # (name, level sizes, rois per image, image width): FPN serving and FPN train
    for name, hws, r, size in (("serving, P2-P5 of 800x1216", FPN_LEVELS, 300, 1216.0),
                               ("train, P2-P5 of 608x1024", FPN_TRAIN_LEVELS, 128, 1024.0)):
        feats32 = [torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32)).to(dev)
                   for h, w in hws]
        rois = random_boxes(rng, b, r, size=size)
        rois[:, :20] = rng.uniform(-400, size + 400, (b, 20, 4))       # partly / wholly outside
        rois[:, 20:30, 2:] = rois[:, 20:30, :2]                        # degenerate: zero size
        rois[:, 30:40] = 0.0                                           # padding rois
        rois[:, 40:50, 2:] = rois[:, 40:50, :2] - 5.0                  # inverted corners
        rois_t = torch.from_numpy(rois).to(dev)
        every = torch.from_numpy(rng.randint(0, 4, (b, r)).astype(np.int32)).to(dev)
        one_empty = torch.where(every == 2, 1, every).to(torch.int32)
        for case, levels in (("every level populated", every), ("level 2 empty", one_empty)):
            for dtype in (torch.float32, torch.bfloat16):
                feats = [f.to(dtype) for f in feats32]
                k = roi_align_multilevel_forward(feats, rois_t, levels, FPN_STRIDES)
                t = roi_align_multilevel_reference(feats, rois_t, levels, FPN_STRIDES)
                torch.cuda.synchronize()
                err = (k.float() - t.float()).abs().max().item()
                scale = t.float().abs().max().item()
                tol, rule = roi_tolerance(dtype, scale)
                if dtype == torch.bfloat16:
                    worst = max(worst, err)
                if not (k.shape == (b, r, 7, 7, c) and err <= tol):
                    raise AssertionError(f"K6 {name}, {case} {dtype}: max abs err {err} > {tol} "
                                         f"({rule})")
                log(f"K6 {name}, {case} {str(dtype)[6:]} (256 channels, 8 x {r} rois): max abs "
                    f"err {err:.3e} <= {tol:.3e} ({rule})")
        # every roi on P4: K6 and K2 share the sample geometry and interpolation
        on_p4 = torch.full_like(every, 2)
        for dtype in (torch.float32, torch.bfloat16):
            feats = [f.to(dtype) for f in feats32]
            k6 = roi_align_multilevel_forward(feats, rois_t, on_p4, FPN_STRIDES)
            k2 = roi_align_forward(feats[2], rois_t, 7, 1.0 / FPN_STRIDES[2], 2)
            torch.cuda.synchronize()
            if not torch.equal(k6, k2):
                raise AssertionError(f"K6 {name} on one level {dtype}: not bit-equal to K2 "
                                     f"({(k6 != k2).sum().item()} values differ)")
        log(f"K6 {name} with every roi on P4: bit-equal to K2 on P4, f32 and bf16")
        feats = [f.to(torch.bfloat16) for f in feats32]
        k_ms = cuda_ms(lambda: roi_align_multilevel_forward(feats, rois_t, every, FPN_STRIDES))
        t_ms = cuda_ms(lambda: roi_align_multilevel_reference(feats, rois_t, every, FPN_STRIDES),
                       iters=5)
        read = roi_read_bytes(rois_t, every, hws, [1.0 / st for st in FPN_STRIDES], c,
                              feats[0].element_size())
        b_ms = bound.add(read + nbytes(rois_t, every, k6), k6.numel() * ROI_FLOPS)
        k_total += k_ms
        t_total += t_ms
        log(f"K6 time {name} bf16 (every level populated): kernel {k_ms:.4f} ms, plain twin "
            f"{t_ms:.4f} ms, bound {b_ms:.4f} ms ({read / 1e6:.1f} of the maps' "
            f"{nbytes(*feats) / 1e6:.1f} MB lie under a roi)")
        del feats32, feats
    return {"ms": k_total, "plain_ms": t_total, "max_abs_err": worst, **bound.result()}


def check_nms_single(dev):
    from frcnn_tpu_torch.ops.cuda.nms_kernel import nms_mask_batched
    from frcnn_tpu_torch.ops.nms import nms_fixed

    rng = np.random.RandomState(11)
    n = 6000
    boxes = torch.from_numpy(random_boxes(rng, 1, n)[0]).to(dev)
    scores = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32)).to(dev)
    valid = torch.from_numpy(rng.uniform(0, 1, n) > 0.1).to(dev)
    ki, kv = nms_fixed(boxes, scores, 0.7, 300, valid=valid)
    ti, tv = nms_fixed(boxes, scores, 0.7, 300, valid=valid, use_kernels=False)
    torch.cuda.synchronize()
    if not (torch.equal(ki, ti) and torch.equal(kv, tv)):
        raise AssertionError("K1b (nms_fixed, one problem of 6000): idx/valid differ from the twin")
    k_ms = cuda_ms(lambda: nms_fixed(boxes, scores, 0.7, 300, valid=valid))
    t_ms = cuda_ms(lambda: nms_fixed(boxes, scores, 0.7, 300, valid=valid, use_kernels=False),
                   iters=3, warmup=1)
    # the kernel's launch alone, on the sorted boxes: nms_fixed adds a sort,
    # gathers and a dozen small ops, which the host enqueues
    order = torch.argsort(-torch.where(valid, scores, -1e10), stable=True)
    sboxes, svalid = boxes[order][None].contiguous(), valid[order][None].contiguous()
    check_capped_mask("one problem (1, 6000, t=0.7)", sboxes, 0.7, svalid, (1, 20, n + 1, 300))
    m_ms = cuda_ms(lambda: nms_mask_batched(sboxes, 0.7, svalid, max_keep=300))
    log(f"K1b (nms_fixed: K1 at B = 1, 6000 boxes, t=0.7, cap 300): idx/valid equal to the "
        f"twin, {kv.sum().item()} kept; nms_fixed with the kernel {k_ms:.4f} ms (the kernel's "
        f"launch alone {m_ms:.4f} ms), with the plain twin {t_ms:.4f} ms")
    return {"ms": k_ms, "mask_ms": m_ms, "plain_ms": t_ms}


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


# the COCO recipe (experiments/scripts/train_faster_rcnn.sh coco): 80 classes and
# the background, four anchor scales (12 anchors a cell)
COCO_CLASSES = 81
COCO_CONFIG = ("ANCHOR_SCALES", "(4, 8, 16, 32)")


def smoke_config(extra=()):
    from frcnn_tpu_torch import cfg_from_list, default_config

    return cfg_from_list(default_config(), [
        "TEST.SCALES", "(800,)", "TEST.MAX_SIZE", "1333",
        "DEVICE.BUCKETS", "((800, 1216),)", "TEST.SCORE_THRESH", "0.0", *extra])


def build_seeded(cfg, dtype, seed=0, net="res50", classes=21):
    """``net`` with seeded weights: a GroupNorm net the JAX package's
    from-scratch init (``init_reference_``), a frozen-BN net
    ``init_random_``'s (activations O(1) at full size)."""
    from frcnn_tpu_torch.models.fpn import init_reference_
    from frcnn_tpu_torch.models.network import build_model, init_random_

    model = build_model(net, classes, cfg, dtype=dtype)
    init = init_reference_ if net.endswith("_gn") else init_random_
    init(model, torch.Generator().manual_seed(seed))
    return model.eval()


# per C4 detect batch at 800x1216: the proposal NMS and the per-class NMS, one
# RoIAlign, the 6 stride-1 blocks of layer1-2, and the BN epilogue after every
# other frozen BN: the stem, layer2.0's three, three in each block of layer3
# (6 in ResNet-50) and layer4 (3), the same at any bucket
SERVE_LAUNCHES = {"nms": 2, "roi_align": 1, "fused_block": 6, "bn_epilogue": 31}
# the same for ResNet-101 (23 blocks in layer3)
COCO_SERVE_LAUNCHES = {**SERVE_LAUNCHES, "bn_epilogue": 82}
# the same for VGG-16 and MobileNet, which have no bottleneck block for K3
C4_PLAIN_SERVE_LAUNCHES = {"nms": 2, "roi_align": 1}
# under TEST.MODE top: no proposal NMS, the per-class NMS over 5000 rois a class
TOP_SERVE_LAUNCHES = {"nms": 1, "roi_align": 1}


# ---------------------------------------------------------------------------
# Graphed serving: on the card a Detector replays one captured CUDA graph per
# (B, bh, bw, input dtype, max_per_image) (frcnn_tpu_torch/engine/graphs.py)
# ---------------------------------------------------------------------------

# label -> the launches the replays of a checked run made (the wrappers count
# only the eager warm-up and the capture of each key)
REPLAYED: dict = {}


def launches_during(fn):
    """(fn(), the launches the kernel wrappers counted during it)."""
    from frcnn_tpu_torch.ops.cuda import build

    before = dict(build.LAUNCH_COUNTS)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v - before.get(k, 0) for k, v in build.LAUNCH_COUNTS.items()
                 if v != before.get(k, 0)}


def check_graphed(label, detector, per_batch, batches, counts):
    """A run through a new graphed ``detector``: every key it replayed was
    captured with ``per_batch`` wrapper calls (the kernels one replay
    launches), the wrappers counted ``counts`` = the eager warm-up and the
    capture of every key (a replay calls no wrapper), and it replayed
    ``batches`` times.  Records and returns the launches the replays made."""
    g = detector.graphs
    if g is None:
        raise AssertionError(f"{label}: the Detector on the card replays no graph")
    captured, replays = sum(g.captures.values()), dict(g.replays)
    off = {k: g.launches[k] for k in replays if g.launches[k] != per_batch}
    want = {name: 2 * n * captured for name, n in per_batch.items()}
    if off or counts != want or sum(replays.values()) != batches:
        raise AssertionError(f"{label}: {sum(replays.values())} replays ({batches} batches); "
                             f"capture-time launches {off or per_batch} (want {per_batch} a "
                             f"batch); the wrappers counted {counts}, want {want} (the warm-up "
                             f"and the capture of {captured} keys)")
    REPLAYED[label] = {name: n * batches for name, n in per_batch.items()}
    return REPLAYED[label]


@contextlib.contextmanager
def made_detectors(eager=False):
    """The list of every ``Detector`` that ``test_net`` makes inside the
    block; with ``eager`` their executors are removed (``detect`` runs op
    by op: the figure graphed serving is compared with)."""
    from frcnn_tpu_torch.engine import serve, test

    made, plain = [], test.Detector

    class Recorded(serve.Detector):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            if eager:
                self.graphs = None
            made.append(self)

    test.Detector = Recorded
    try:
        yield made
    finally:
        test.Detector = plain


def eager_copy(detector):
    """``detector`` without its executor: the same model and settings, with
    ``detect`` run op by op."""
    eager = copy.copy(detector)
    eager.graphs = None
    return eager


def main_path(dev, card, net="res50", per_batch=SERVE_LAUNCHES, extra=(), classes=21):
    """A C4 net's serving path at full width: 3 requests of 8 through
    ``Detector`` with the launch counts per batch, then the steady-state batch
    time and peak device memory."""
    from frcnn_tpu_torch.engine.serve import Detector, iter_bucket_batches
    from frcnn_tpu_torch.ops.cuda import build

    label = ("main path" if net == "res50" and not extra else
             f"{net} ({classes} classes) serving path {list(extra)}")
    cfg = smoke_config(extra)
    model = build_seeded(cfg, torch.bfloat16, net=net, classes=classes)
    detector = Detector(model, uint8_input=True)          # no device given: the card
    if detector.device != dev or next(model.parameters()).device != dev:
        raise AssertionError(f"Detector did not move the model to {dev}: {detector.device}")
    bh, bw = cfg.DEVICE.BUCKETS[0]
    rng = np.random.RandomState(3)
    # 800x1216 and 600x912 images both land in the one bucket
    requests = [synthetic_images(rng, [(bh, bw), (bh * 3 // 4, bw * 3 // 4)] * 4)
                for _ in range(3)]

    # finite trunk activations at full size (outside the counted window)
    (_, blob, _), = iter_bucket_batches(requests[0], cfg, keep_uint8=True)
    with torch.inference_mode():
        from frcnn_tpu_torch.models.backbones import preprocess_images

        x = preprocess_images(torch.from_numpy(blob).to(dev), cfg, torch.bfloat16)
        feat = model.backbone.extract_features(x.permute(0, 3, 1, 2)).float()
    if not torch.isfinite(feat).all():
        raise AssertionError(f"{net} trunk activations are not finite at 800x1216")
    log(f"{net} trunk features {tuple(feat.shape)}: finite, std {feat.std().item():.4f}, "
        f"max |x| {feat.abs().max().item():.4f}")
    del feat

    torch.cuda.synchronize()
    build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    results = [detector(images) for images in requests]
    torch.cuda.synchronize()
    # the requests' peak: the eager warm-up, the capture and the replays (a replay
    # allocates nothing: its memory is the graph's pool, held since the capture)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = dict(build.LAUNCH_COUNTS)
    log(f"{label}: 3 requests x 8 images served; kernel launches counted by the wrappers "
        f"{counts}")
    n_det = 0
    for req in results:
        for dets in req:
            if dets.ndim != 2 or dets.shape[1] != 6 or not np.isfinite(dets).all():
                raise AssertionError(f"{label}: bad detections: shape {dets.shape}")
            n_det += len(dets)
    if n_det == 0:
        raise AssertionError(f"{label}: no detections at SCORE_THRESH 0.0")
    check_graphed(label, detector, per_batch, 3, counts)
    (key, seconds), = detector.graphs.capture_seconds.items()
    log(f"{label}: {n_det} finite detections of shape (k, 6) over 24 images; one graph "
        f"captured ({seconds:.3f} s) and replayed 3 times, per batch K1 "
        f"{per_batch.get('nms', 0)}, K2 {per_batch.get('roi_align', 0)}, K3 "
        f"{per_batch.get('fused_block', 0)} launches")

    data = torch.from_numpy(blob).to(dev)
    im_info = torch.tensor([[float(bh), float(bw), 1.0]] * 8, device=dev)
    ms = cuda_ms(lambda: detector.detect_blobs(data, im_info), iters=10, warmup=2)
    log(f"{label} steady state ({net}, batch 8, {bh}x{bw}, bf16 trunk, graphed): {ms:.3f} ms "
        f"per batch (median of 10, CUDA events), {8000.0 / ms:.2f} images/s, peak device memory "
        f"{peak:.3f} GiB over the requests (warm-up, capture, replays) on {card}")
    return counts, ms, detector, data, im_info


def dets_mismatch(want, got, score_atol=1e-3, box_atol=5e-2):
    """Why detection rows [x1, y1, x2, y2, score, class] do not match one to
    one (the rule of the JAX pipeline-parity test, per class), or None."""
    if len(want) != len(got):
        return f"CPU kept {len(want)}, card kept {len(got)}"
    used = np.zeros(len(got), bool)
    for row in want:
        cand = np.where(~used & (got[:, 5] == row[5])
                        & (np.abs(got[:, 4] - row[4]) <= score_atol)
                        & (np.abs(got[:, :4] - row[:4]).max(axis=1) <= box_atol))[0]
        if not len(cand):
            return f"no card detection matches CPU row {row}"
        used[cand[0]] = True
    return None


def match_dets(want, got, label, score_atol=1e-3, box_atol=5e-2):
    """Raise unless ``dets_mismatch`` finds the rows matched one to one."""
    why = dets_mismatch(want, got, score_atol, box_atol)
    if why is not None:
        raise AssertionError(f"{label}: {why}")


def match_im_detect(want, got, label, score_atol=1e-3, box_atol=5e-2):
    """One-to-one match of ``im_detect``'s valid rois, each a row of per-class
    scores and boxes; the order of the rois may differ."""
    ws, wb, gs, gb = want[0][want[2]], want[1][want[2]], got[0][got[2]], got[1][got[2]]
    if len(ws) != len(gs) or len(ws) == 0:
        raise AssertionError(f"{label}: CPU kept {len(ws)} rois, card kept {len(gs)}")
    used = np.zeros(len(gs), bool)
    for s, b in zip(ws, wb):
        cand = np.where(~used & (np.abs(gs - s).max(axis=1) <= score_atol)
                        & (np.abs(gb - b).max(axis=1) <= box_atol))[0]
        if not len(cand):
            raise AssertionError(f"{label}: no card roi matches a CPU roi (best score gap "
                                 f"{np.abs(gs - s).max(axis=1).min():.3g})")
        used[cand[0]] = True
    return len(ws)


E2E_LAUNCHES = {"nms": 2, "roi_align": 1}


def end_to_end(dev, net="res50", extra=(), launches=E2E_LAUNCHES, classes=21):
    """One image through a C4 net's f32 ``detect`` on the card and on a CPU
    copy of the same model (320x480), detections matched one to one;
    ``launches`` the kernels the card's detect must run."""
    from frcnn_tpu_torch.engine.serve import Detector
    from frcnn_tpu_torch.ops.cuda import build

    cfg = smoke_config(["TEST.SCALES", "(320,)", "TEST.MAX_SIZE", "480",
                        "DEVICE.BUCKETS", "((320, 480),)", "TEST.SCORE_THRESH", "0.05", *extra])
    cpu_model = build_seeded(cfg, torch.float32, seed=1, net=net, classes=classes)
    card_model = build_seeded(cfg, torch.float32, seed=1, net=net, classes=classes)
    im = synthetic_images(np.random.RandomState(5), [(320, 480)])
    card = Detector(card_model)
    first, ran = launches_during(lambda: card(im)[0])
    got = card(im)[0]                  # replayed again: the outputs are the replay's own
    want = Detector(cpu_model, device="cpu")(im)[0]
    check_graphed(f"f32 {net} {list(extra)} card detect", card, launches, 2, ran)
    if not np.array_equal(first, got):
        raise AssertionError(f"f32 {net} {list(extra)}: a second replay differs from the first")
    if len(want) == 0:
        raise AssertionError(f"f32 {net} {list(extra)} detect: no detections to compare")
    match_dets(want, got, f"f32 {net} {list(extra)} detect, card vs CPU")
    log(f"{net} {list(extra)} end to end (f32, TF32 off, 320x480): card detect (graphed, "
        f"{launches} a replay) matches the CPU copy (twins): {len(want)} detections, score atol "
        f"1e-3, box atol 5e-2")


def top_path(dev, card):
    """TEST.MODE top at full width: VGG-16, bf16, one 800x1216 bucket, 3
    requests of 8 through ``Detector`` (K1 once a batch: the per-class NMS
    over 168 problems of 5000 rois; K2 once over 8 x 5000 rois), then the
    steady-state batch time and peak memory; then the per-class NMS of one
    batch's real outputs through K1 and through its twin: detections and
    valid masks equal."""
    from frcnn_tpu_torch.models.network import postprocess_detections

    counts, ms, detector, data, im_info = main_path(dev, card, "vgg16", TOP_SERVE_LAUNCHES,
                                                    ("TEST.MODE", "top"))
    model, cfg = detector.model, detector.cfg
    with torch.inference_mode():
        out = model.predict(data, im_info)
        n = out["rois"].shape[1]
        if n != cfg.TEST.RPN_TOP_N or not out["roi_valid"].all():
            raise AssertionError(f"TEST.MODE top: {n} rois a image, "
                                 f"{int(out['roi_valid'].sum())} valid")
        got = postprocess_detections(out, im_info, cfg, 21, cfg.TEST.MAX_PER_IMAGE)
        want = postprocess_detections(out, im_info, cfg, 21, cfg.TEST.MAX_PER_IMAGE,
                                      use_kernels=False)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("TEST.MODE top: the per-class NMS through K1 (168 x 5000, cap "
                             "100) differs from its twin")
    with torch.inference_mode():
        k_ms = cuda_ms(lambda: postprocess_detections(out, im_info, cfg, 21,
                                                      cfg.TEST.MAX_PER_IMAGE))
        t_ms = cuda_ms(lambda: postprocess_detections(out, im_info, cfg, 21,
                                                      cfg.TEST.MAX_PER_IMAGE,
                                                      use_kernels=False), iters=3, warmup=1)
    log(f"TEST.MODE top: the per-class NMS of a served batch (168 problems x {n} rois, cap 100) "
        f"through K1 equals its twin's: detections and valid masks equal "
        f"({int(got[1].sum())} detections); postprocess_detections {k_ms:.4f} ms with K1, "
        f"{t_ms:.4f} ms with the twin")
    return counts, ms, detector


# per FPN detect batch at 800x1216: the 6 stride-1 blocks of layer1-2, K5 on
# the P2 and P3 rows, the proposal NMS and the per-class NMS, one K6 launch, the
# BN epilogue as in the C4 trunk (layer4 on the C5 map)
FPN_LAUNCHES = {"fused_block": 6, "select": 2, "nms": 2, "roi_align_ml": 1, "bn_epilogue": 31}
# per GroupNorm FPN detect batch: the same without K3, which folds a frozen BN
FPN_GN_LAUNCHES = {"select": 2, "nms": 2, "roi_align_ml": 1}
# the GroupNorm FPN trained from scratch: nothing frozen (as scripts/ap_regression.py)
GN_CONFIG = ("RESNET.FIXED_BLOCKS", "0")


def check_rpn_logits(model, pyramid):
    """The served RPN's logit product at P2 in bf16 (``fg_logit_diff`` as
    ``_rpn_all_levels`` calls it: a bf16 mm with an f32 result) against the
    f32 product of the same bf16 operands; then the P2 block of fg_prob
    against the sigmoid of that plain product, laid out A-major."""
    from frcnn_tpu_torch.models import fpn

    calls = []
    plain = fpn.fg_logit_diff

    def recording(tokens, dw, db):
        out = plain(tokens, dw, db)
        calls.append((tokens, dw, db, out))
        return out

    fpn.fg_logit_diff = recording
    try:
        with torch.inference_mode():
            fg_prob, _, _ = model._rpn_all_levels(pyramid)
    finally:
        fpn.fg_logit_diff = plain
    tokens, dw, db, got = calls[0]                              # P2
    b, hw, c = tokens.shape
    a_n = dw.shape[1]
    if tokens.dtype != torch.bfloat16 or got.dtype != torch.float32 or hw != 200 * 304:
        raise AssertionError(f"RPN logits at P2: tokens {tokens.dtype} {tuple(tokens.shape)}, "
                             f"result {got.dtype}")
    with torch.inference_mode():
        want = tokens.float() @ dw.to(torch.bfloat16).float() + db
        prob_want = torch.sigmoid(want).transpose(1, 2).reshape(b, a_n * hw)
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    perr = (fg_prob[:, :a_n * hw] - prob_want).abs().max().item()
    tol = 1e-5 * scale
    if not (err <= tol and perr <= tol):
        raise AssertionError(f"RPN logits at P2 (bf16 mm, f32 result): max abs err {err}, "
                             f"fg_prob err {perr} > {tol} (1e-5 of max|plain logit|)")
    log(f"FPN RPN at P2 ({b} x {hw} x {c} bf16 tokens, {a_n} anchors): logits of the bf16 mm "
        f"with an f32 result within {err:.3e}, A-major fg_prob within {perr:.3e} of the f32 "
        f"product <= {tol:.3e} (1e-5 of max|logit| {scale:.3f})")


def fpn_path(dev, card, net="res50_fpn", per_batch=FPN_LAUNCHES):
    from frcnn_tpu_torch.engine.serve import Detector, iter_bucket_batches
    from frcnn_tpu_torch.ops.cuda import build

    cfg = smoke_config(GN_CONFIG if net.endswith("_gn") else ())
    model = build_seeded(cfg, torch.bfloat16, net=net)
    detector = Detector(model, uint8_input=True)
    bh, bw = cfg.DEVICE.BUCKETS[0]
    rng = np.random.RandomState(3)
    requests = [synthetic_images(rng, [(bh, bw), (bh * 3 // 4, bw * 3 // 4)] * 4)
                for _ in range(3)]

    # finite pyramid activations at full size (outside the counted window)
    (_, blob, _), = iter_bucket_batches(requests[0], cfg, keep_uint8=True)
    with torch.inference_mode():
        pyramid = model._pyramid(torch.from_numpy(blob).to(dev))
    for level, p in enumerate(pyramid, start=2):
        p = p.float()
        if not torch.isfinite(p).all():
            raise AssertionError(f"{net} P{level} is not finite at 800x1216")
    log(f"{net} pyramid at 800x1216: " + ", ".join(
        f"P{lv} {tuple(p.shape[2:])} std {p.float().std().item():.3f}"
        for lv, p in enumerate(pyramid, start=2)))
    check_rpn_logits(model, pyramid)
    del pyramid

    torch.cuda.synchronize()
    build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    results = [detector(images) for images in requests]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30        # as in main_path
    counts = dict(build.LAUNCH_COUNTS)
    log(f"{net} path: 3 requests x 8 images served; kernel launches counted by the wrappers "
        f"{counts}")
    n_det = 0
    for req in results:
        for dets in req:
            if dets.ndim != 2 or dets.shape[1] != 6 or not np.isfinite(dets).all():
                raise AssertionError(f"{net}: bad detections: shape {dets.shape}")
            n_det += len(dets)
    if n_det == 0:
        raise AssertionError(f"{net}: no detections at SCORE_THRESH 0.0")
    check_graphed(f"{net} serving path", detector, per_batch, 3, counts)
    (_, seconds), = detector.graphs.capture_seconds.items()
    log(f"{net} path: {n_det} finite detections of shape (k, 6) over 24 images; one graph "
        f"captured ({seconds:.3f} s) and replayed 3 times, per batch "
        + ", ".join(f"{name} {per_batch.get(name, 0)}" for name in ("fused_block", "select",
                                                                     "nms", "roi_align_ml"))
        + " launches")

    data = torch.from_numpy(blob).to(dev)
    im_info = torch.tensor([[float(bh), float(bw), 1.0]] * 8, device=dev)
    ms = cuda_ms(lambda: detector.detect_blobs(data, im_info), iters=10, warmup=2)
    log(f"FPN serving path steady state ({net}, batch 8, {bh}x{bw}, bf16 trunk, graphed): {ms:.3f} ms "
        f"per batch (median of 10, CUDA events), {8000.0 / ms:.2f} images/s, peak device memory "
        f"{peak:.3f} GiB over the requests (warm-up, capture, replays) on {card}")
    return counts, detector, data, im_info, ms


def fpn_end_to_end(dev, net="res50_fpn"):
    from frcnn_tpu_torch.engine.serve import Detector
    from frcnn_tpu_torch.ops.cuda import build

    cfg = smoke_config(["TEST.SCALES", "(320,)", "TEST.MAX_SIZE", "480",
                        "DEVICE.BUCKETS", "((320, 480),)", "TEST.SCORE_THRESH", "0.05",
                        *(GN_CONFIG if net.endswith("_gn") else ())])
    cpu_model = build_seeded(cfg, torch.float32, seed=1, net=net)
    card_model = build_seeded(cfg, torch.float32, seed=1, net=net)
    im = synthetic_images(np.random.RandomState(5), [(320, 480)])
    card = Detector(card_model)
    got, ran = launches_during(lambda: card(im)[0])
    want = Detector(cpu_model, device="cpu")(im)[0]
    # P2 of 320x480 (28800 anchors) passes the K5 gate, P3 (7200) does not
    check_graphed(f"f32 {net} card detect", card, {"nms": 2, "roi_align_ml": 1, "select": 1},
                  1, ran)
    if len(want) == 0:
        raise AssertionError(f"f32 {net} detect: no detections to compare")
    match_dets(want, got, f"f32 {net} detect, card vs CPU")
    log(f"{net} end to end (f32, TF32 off, 320x480): card detect (graphed; K1 x2, K5 x1, K6 x1 "
        f"a replay) matches "
        f"the CPU copy (twins): {len(want)} detections, score atol 1e-3, box atol 5e-2")


# ---------------------------------------------------------------------------
# The train path
# ---------------------------------------------------------------------------

# per C4 train step: proposals NMS, RoIAlign fwd + bwd, the 6 stride-1 blocks
# of layer1-2 (forward; their backward is autograd of the twin), anchor
# overlaps, fg + bg subsampling
TRAIN_LAUNCHES = {"nms": 1, "roi_align": 1, "roi_align_bwd": 1, "fused_block": 6,
                  "overlap": 1, "select": 2}
# per FPN train step: the same blocks, anchor overlaps over all level anchors,
# fg + bg subsampling and P2's pre-NMS top-k (P3's 29184 < 24 x 2000 misses
# the K5 gate), the cross-level NMS, multilevel RoIAlign fwd + bwd
FPN_TRAIN_LAUNCHES = {"fused_block": 6, "overlap": 1, "select": 3, "nms": 1,
                      "roi_align_ml": 1, "roi_align_ml_bwd": 1}
# per VGG-16 or MobileNet train step: the C4 step without K3
C4_PLAIN_TRAIN_LAUNCHES = {"nms": 1, "roi_align": 1, "roi_align_bwd": 1, "overlap": 1,
                           "select": 2}
# per GroupNorm FPN train step: the same without K3
FPN_GN_TRAIN_LAUNCHES = {"overlap": 1, "select": 3, "nms": 1, "roi_align_ml": 1,
                         "roi_align_ml_bwd": 1}
# the from-scratch recipe's clip and warmup (scripts/ap_regression.py), at 10x its
# learning rate: the bf16 RPN head weights (~0.01, a bf16 ulp ~6e-5) must move
# within the path's 6 steps at the warmup's first rate
GN_TRAIN_CONFIG = GN_CONFIG + ("TRAIN.GRAD_CLIP", "10.0", "TRAIN.WARMUP_ITERS", "500",
                               "TRAIN.WARMUP_FACTOR", "0.1", "TRAIN.LEARNING_RATE", "0.01")


# peak device memory of the steady-state train steps (GiB) when K2b and K6b
# accumulated into an f32 buffer the size of dF (PERF.md §5, H100 80GB HBM3)
PEAK_WITH_F32_ACCUMULATOR_GIB = {"res50": 2.279, "res50_fpn": 3.427}


def synthetic_roidb(rng, shapes, max_boxes=20, classes=21):
    """In-memory roidb over synthetic images: each entry has 3-max_boxes gt
    boxes of classes 1..classes-1, painted as flat rectangles.  Returns
    (roidb, reader)."""
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
                      "gt_classes": rng.randint(1, classes, n).astype(np.int32),
                      "height": h, "width": w, "max_overlaps": np.ones(n, np.float32)})
    table = {e["image"]: im for e, im in zip(roidb, images)}
    return roidb, table.__getitem__


def train_config(extra=()):
    from frcnn_tpu_torch import cfg_from_list, default_config

    return cfg_from_list(default_config(), [
        "TRAIN.IMS_PER_BATCH", str(TRAIN_B), "DEVICE.BUCKETS", f"(({TRAIN_H}, {TRAIN_W}),)",
        "TRAIN.DISPLAY", "1", *extra])


def train_path(dev, card, net="res50", per_step=TRAIN_LAUNCHES, extra=()):
    from frcnn_tpu_torch.engine.train import SolverWrapper, filter_roidb
    from frcnn_tpu_torch.ops.cuda import build

    label = "train" if net == "res50" else f"{net} train"
    cfg = train_config(extra)
    model = build_seeded(cfg, torch.bfloat16, net=net)
    rng = np.random.RandomState(4)
    # landscape images whose 600-pixel rescale fits the 608x1024 bucket
    shapes = []
    for _ in range(16):
        h = int(rng.choice([375, 450, 480, 600]))
        shapes.append((h, int(h * rng.uniform(1.3, 1.66))))
    roidb, reader = synthetic_roidb(rng, shapes)
    roidb = filter_roidb(roidb, cfg)
    solver = SolverWrapper(model, roidb, cfg, reader=reader)      # no device given: the card
    if solver.device != dev or next(model.parameters()).device != dev:
        raise AssertionError(f"SolverWrapper did not move the model to {dev}: {solver.device}")
    before = {name: p.detach().clone() for name, p in model.named_parameters()}

    steps = 5
    torch.cuda.synchronize()
    build.reset_launch_counts()
    history = solver.train_model(1)
    n_fg, n_prop = int(solver.aux["n_fg"]), int(solver.aux["n_proposals"])
    if n_fg <= 0 or n_prop <= 0:
        raise AssertionError(f"{label} step 1: n_fg {n_fg}, proposals {n_prop}")
    # step 1's gradients: none missing, none all zero (a wrapper without an
    # autograd Function would cut the graph silently)
    trained = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    dead = [n for n, p in trained
            if p.grad is None or not torch.isfinite(p.grad).all() or not p.grad.any()]
    if dead:
        raise AssertionError(f"{label} step 1: no (or a non-finite) gradient for {dead}")
    history += solver.train_model(steps)
    torch.cuda.synchronize()
    counts = dict(build.LAUNCH_COUNTS)
    log(f"{label} path: {steps} steps of batch {TRAIN_B} at {TRAIN_H}x{TRAIN_W} over a "
        f"{len(roidb)}-entry synthetic roidb ({n_fg} fg rois, {n_prop} proposals in step "
        f"1); kernel launches {counts}")
    for i, losses in enumerate(history):
        if not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"{label} step {i + 1}: non-finite losses {losses}")
    want = {name: n * steps for name, n in per_step.items()}
    if len(history) != steps or counts != want:
        raise AssertionError(f"{label} launch counts {counts} != {want} ({per_step} per step)")
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    params = dict(model.named_parameters())
    moved = [n for n in frozen if not torch.equal(params[n], before[n])]
    still = [n for n, _ in trained if torch.equal(params[n], before[n])]
    if moved or still:
        raise AssertionError(f"frozen params changed: {moved}; trainable params unchanged: {still}")
    groups = sorted({n.split(".")[0] for n, _ in trained})
    log(f"{label} path: losses finite, first {history[0]}, last {history[-1]}; step 1 gave all "
        f"{len(trained)} trainable tensors ({', '.join(groups)}) a non-zero gradient; "
        f"{len(frozen)} frozen tensors ({', '.join(sorted({n.rsplit('.', 1)[0] for n in frozen}))}"
        f") bit-unchanged, {len(trained)} trainable tensors changed")

    blobs = {k: torch.as_tensor(v).to(dev) for k, v in solver.data_layer.forward().items()}
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: solver.train_step(blobs), iters=10, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    was = PEAK_WITH_F32_ACCUMULATOR_GIB.get(net)
    log(f"{label} step steady state ({net}, batch {TRAIN_B}, {TRAIN_H}x{TRAIN_W}, bf16 trunk): "
        f"{ms:.3f} ms per step (median of 10, CUDA events), "
        f"{TRAIN_B * 1000.0 / ms:.2f} images/s, peak device memory {peak:.3f} GiB on {card}"
        + (f" ({was:.3f} GiB when the RoI backward accumulated into an f32 scratch buffer, "
           "PERF.md)" if was else ""))
    return counts, solver, ms


# (net, config cuts, anchors at 320x480, proposals, launches on the card,
# tensors whose updates are compared) of the f32 card-vs-CPU train step
CARD_VS_CPU = {
    "res50": (["TRAIN.RPN_PRE_NMS_TOP_N", "400", "TRAIN.RPN_POST_NMS_TOP_N", "64"],
              (320 // 16) * (480 // 16) * 9, 64,
              {"nms": 1, "roi_align": 1, "roi_align_bwd": 1, "overlap": 1},
              ("rpn_net.weight", "cls_score.weight", "layer2.1.conv2.weight")),
    # 38370 anchors over P2-P6: the fg/bg subsampling and P2's top-k pass K5's gate
    "res50_fpn": (["FPN.PRE_NMS_PER_LEVEL_TRAIN", "200", "TRAIN.RPN_POST_NMS_TOP_N", "64"],
                  3 * (80 * 120 + 40 * 60 + 20 * 30 + 10 * 15 + 5 * 8), 64,
                  {"overlap": 1, "select": 3, "nms": 1, "roi_align_ml": 1, "roi_align_ml_bwd": 1},
                  ("rpn_net.weight", "rpn_cls_w", "cls_score.weight", "box_head.fc1.weight",
                   "neck.output2.weight", "neck.lateral5.weight", "layer2.1.conv2.weight")),
    # VGG-16 and MobileNet (width 1.0): the C4 cuts and launches without K3; VGG's
    # conv3_* are left out of the compared updates (a relu input within rounding
    # of zero passes the gradient on one device only: tests/test_torch_vgg_mobile.py)
    "vgg16": (["TRAIN.RPN_PRE_NMS_TOP_N", "400", "TRAIN.RPN_POST_NMS_TOP_N", "64"],
              (320 // 16) * (480 // 16) * 9, 64,
              {"nms": 1, "roi_align": 1, "roi_align_bwd": 1, "overlap": 1},
              ("rpn_net.weight", "cls_score.weight", "classifier.0.weight",
               "classifier.3.weight", "features.28.weight")),
    # MobileNet at lr 1.0: at 1e-3 a depthwise weight (N(0, 2/9)) moves by ~400 of its
    # f32 ulps, and the rounding of p + delta alone exceeds 1e-3 of max|delta|
    "mobile": (["TRAIN.RPN_PRE_NMS_TOP_N", "400", "TRAIN.RPN_POST_NMS_TOP_N", "64",
                "TRAIN.LEARNING_RATE", "1.0"],
               (320 // 16) * (480 // 16) * 9, 64,
               {"nms": 1, "roi_align": 1, "roi_align_bwd": 1, "overlap": 1},
               ("rpn_net.weight", "cls_score.weight", "sep13.pointwise.weight",
                "sep11.depthwise.weight", "sep6.pointwise.weight")),
    # the same under the from-scratch recipe (nothing frozen, clip, warmup) at lr 1.0:
    # at the recipe's rates under the clip an update is a few ulps of its weight
    # (tests/test_torch_train.py).  The trunk's tensors are held by direction only:
    # every relu of a trunk that trains whole lies on their gradient's path
    "res50_fpn_gn": (["FPN.PRE_NMS_PER_LEVEL_TRAIN", "200", "TRAIN.RPN_POST_NMS_TOP_N", "64",
                      *GN_TRAIN_CONFIG, "TRAIN.LEARNING_RATE", "1.0"],
                     3 * (80 * 120 + 40 * 60 + 20 * 30 + 10 * 15 + 5 * 8), 64,
                     {"overlap": 1, "select": 3, "nms": 1, "roi_align_ml": 1,
                      "roi_align_ml_bwd": 1},
                     ("rpn_net.weight", "rpn_cls_w", "cls_score.weight", "box_head.fc1.weight",
                      "neck.output2.weight", "neck.lateral5.weight")),
    # the COCO recipe's model (phase 50, at classes=COCO_CLASSES): res101, four anchor scales
    "res101": (["TRAIN.RPN_PRE_NMS_TOP_N", "400", "TRAIN.RPN_POST_NMS_TOP_N", "64",
                *COCO_CONFIG], (320 // 16) * (480 // 16) * 12, 64,
               {"nms": 1, "roi_align": 1, "roi_align_bwd": 1, "overlap": 1},
               ("rpn_net.weight", "cls_score.weight", "bbox_pred.weight",
                "layer3.22.conv2.weight", "layer2.1.conv2.weight")),
}


def train_card_vs_cpu(dev, net="res50", pooling="align", classes=21):
    """One f32 train step on the card (kernels) and on a CPU copy (twins)
    from the same weights, minibatch and draws (VGG-16's dropout uniforms
    too).  The proposal and RoI counts are cut (C4: pre-NMS 400; FPN: 200 a
    level; post-NMS 64) so that the proposal order, which decides which roi
    each random priority lands on, is not flipped by near-tied RPN scores
    that differ in the last bits between cuDNN and the CPU convolutions.
    POOLING_MODE "pool" or "crop" pools in plain PyTorch on both: K2 and K2b
    do not run."""
    from frcnn_tpu_torch.data.loader import get_minibatch
    from frcnn_tpu_torch.engine.train import SolverWrapper
    from frcnn_tpu_torch.ops.cuda import build

    cuts, k, post, card_launches, compared = CARD_VS_CPU[net]
    if pooling != "align":
        card_launches = {n: c for n, c in card_launches.items() if not n.startswith("roi_align")}
    cfg = train_config(["TRAIN.IMS_PER_BATCH", "2", "DEVICE.BUCKETS", "((320, 480),)",
                        "TRAIN.SCALES", "(320,)", "TRAIN.MAX_SIZE", "480", "POOLING_MODE",
                        pooling, *cuts])
    rng = np.random.RandomState(5)
    roidb, reader = synthetic_roidb(rng, [(320, 480), (320, 480)], classes=classes)
    blobs = get_minibatch(roidb, cfg, np.random.RandomState(0), reader=reader)
    n = post + cfg.DEVICE.MAX_GT
    draws = {name: torch.from_numpy(rng.uniform(0, 1, (2, size)).astype(np.float32))
             for name, size in (("anchor_fg", k), ("anchor_bg", k), ("roi_fg", n),
                                ("roi_bg", n))}
    if net == "vgg16":                      # fc6's and fc7's dropout, as uniform_draws shapes it
        draws["dropout"] = torch.from_numpy(
            rng.uniform(0, 1, (2, 2 * cfg.TRAIN.BATCH_SIZE, 4096)).astype(np.float32))
    results = []
    for device in (None, "cpu"):                         # None: the card
        model = build_seeded(cfg, torch.float32, seed=2, net=net, classes=classes)
        solver = SolverWrapper(model, roidb, cfg, reader=reader, device=device)
        before = {name: p.detach().clone() for name, p in model.named_parameters()}
        start = dict(build.LAUNCH_COUNTS)
        losses = solver.train_step(blobs, {k_: v.to(solver.device) for k_, v in draws.items()})
        ran = {k_: v - start.get(k_, 0) for k_, v in build.LAUNCH_COUNTS.items()
               if v != start.get(k_, 0)}
        delta = {name: (p.detach() - before[name]).cpu() for name, p in model.named_parameters()}
        results.append(({k_: float(v) for k_, v in losses.items()}, delta, ran, solver.device))
    (card_l, card_d, card_ran, card_dev), (cpu_l, cpu_d, cpu_ran, _) = results
    if card_dev != dev or card_ran != card_launches or cpu_ran:
        raise AssertionError(f"f32 {net} {pooling} train step on {card_dev}: card launches "
                             f"{card_ran} "
                             f"(want {card_launches}), CPU launches {cpu_ran}")
    for name, want in cpu_l.items():
        rel = abs(card_l[name] - want) / max(abs(want), 1e-6)
        if not rel <= 1e-4:
            raise AssertionError(f"f32 {net} {pooling} train step {name}: card {card_l[name]} "
                                 f"vs CPU {want} "
                                 f"(rel {rel:.2e} > 1e-4)")
    worst = {}
    for name in compared:
        scale = cpu_d[name].abs().max().item()
        err = (card_d[name] - cpu_d[name]).abs().max().item()
        if not (scale > 0 and err <= 1e-3 * scale):
            raise AssertionError(f"f32 {net} {pooling} train step update of {name}: err {err} vs "
                                 f"max|delta| {scale} (tolerance 1e-3 relative)")
        worst[name] = err / scale
    log(f"f32 {net} {pooling} train step, card ({card_ran}) vs CPU copy (twins), 320x480, "
        f"batch 2: losses "
        f"{cpu_l} within 1e-4 relative; updates within 1e-3 of max|delta| "
        f"({ {k_: f'{v:.2e}' for k_, v in worst.items()} })")
    if net.endswith("_gn"):
        # in f32 a relu whose input lies within rounding of zero may pass the
        # gradient on one device and not on the other (the f64 comparison with
        # the JAX package in tests/test_torch_fpn_gn.py shows it), so the
        # trunk's updates are held by their direction: cosine >= 0.99, or
        # exactly zero on both (a bias that no sampled anchor or roi reaches)
        cos, rel, still = {}, {}, []
        for name, want in cpu_d.items():
            got, want = card_d[name].double().flatten(), want.double().flatten()
            if not got.any() and not want.any():
                still.append(name)
                continue
            denom = (got.norm() * want.norm()).item()
            cos[name] = (got @ want).item() / denom if denom > 0 else 0.0
            rel[name] = (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)
        low = {name: c for name, c in cos.items() if not c >= 0.99}
        if low or "conv1.weight" not in cos or "bn1.weight" not in cos:
            raise AssertionError(f"f32 {net} train step: updates of {len(low)} tensors point "
                                 f"elsewhere on the card (cosine < 0.99): {low}")
        lowest, far = min(cos, key=cos.get), max(rel, key=rel.get)
        log(f"f32 {net} train step: {len(cos)} tensors (conv1, the GroupNorms, ...) move on "
            f"both, each update's cosine with the CPU's >= 0.99 (lowest {cos[lowest]:.6f}, "
            f"{lowest}; conv1.weight {cos['conv1.weight']:.6f}, bn1.weight "
            f"{cos['bn1.weight']:.6f}); the largest max|difference| / max|CPU update| "
            f"{rel[far]:.3e} ({far}); {still} move on neither")


# ---------------------------------------------------------------------------
# The train -> snapshot -> resume -> test -> evaluate path
# ---------------------------------------------------------------------------

def devkit_shapes(rng):
    """Image shapes of the synthetic devkit's splits, each image's short side
    at its split's scale so that nothing is resized: trainval at the train
    path's 600 (16 images, 32 entries with the flips: 4 batches of 8 an
    epoch), test at the serving bucket's 800 (two batches of 8), val at 320
    for the card-vs-CPU comparison."""
    return {"trainval": [(600, int(w)) for w in rng.randint(800, 1001, 16)],
            "test": [(800, int(w)) for w in rng.randint(1000, 1217, 16)],
            "val": [(320, 480)] * 4}


def write_voc_devkit(root, splits, rng):
    """A VOCdevkit2007 under ``root`` for a machine without an image codec:
    Annotations XML and ImageSets written with the standard library, an
    empty placeholder for each JPEGImages path, and a reader (image path →
    BGR uint8 array) that serves the pixels: ``synthetic_images`` with each
    annotated box painted flat.  ``splits``: {split: [(h, w), ...]}, each
    split with images of its own."""
    import xml.etree.ElementTree as ET

    from frcnn_tpu_torch.data.pascal_voc import VOC_CLASSES

    voc = os.path.join(root, "VOCdevkit2007", "VOC2007")
    for sub in ("Annotations", os.path.join("ImageSets", "Main"), "JPEGImages"):
        os.makedirs(os.path.join(voc, sub), exist_ok=True)
    pixels = {}
    for split, shapes in splits.items():
        names = []
        for im, (h, w) in zip(synthetic_images(rng, shapes), shapes):
            name = f"{len(pixels):06d}"
            ann = ET.Element("annotation")
            size = ET.SubElement(ann, "size")
            for tag, v in (("width", w), ("height", h), ("depth", 3)):
                ET.SubElement(size, tag).text = str(v)
            for _ in range(rng.randint(3, 13)):
                bw, bh = rng.randint(w // 10, w // 2), rng.randint(h // 10, h // 2)
                x1, y1 = rng.randint(0, w - bw), rng.randint(0, h - bh)
                im[y1:y1 + bh, x1:x1 + bw] = rng.randint(0, 255, 3)
                obj = ET.SubElement(ann, "object")
                ET.SubElement(obj, "name").text = VOC_CLASSES[rng.randint(1, len(VOC_CLASSES))]
                ET.SubElement(obj, "difficult").text = "0"
                box = ET.SubElement(obj, "bndbox")
                for tag, v in (("xmin", x1), ("ymin", y1), ("xmax", x1 + bw - 1),
                               ("ymax", y1 + bh - 1)):
                    ET.SubElement(box, tag).text = str(v + 1)          # VOC pixels are 1-based
            ET.ElementTree(ann).write(os.path.join(voc, "Annotations", name + ".xml"))
            path = os.path.join(voc, "JPEGImages", name + ".jpg")
            open(path, "wb").close()
            pixels[path] = im
            names.append(name)
        with open(os.path.join(voc, "ImageSets", "Main", split + ".txt"), "w") as f:
            f.write("\n".join(names) + "\n")
    return pixels.__getitem__


def state_spread(a, b):
    """(bit-equal, max |a - b|) over the tensors of two state_dicts."""
    equal, worst = True, 0.0
    for name, x in a.items():
        if not torch.equal(x, b[name]):
            equal = False
            worst = max(worst, (x.float() - b[name].float()).abs().max().item())
    return equal, worst


def nondeterministic_ops(step):
    """The ops PyTorch names as having no deterministic CUDA implementation,
    from the warnings of one call of ``step`` under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``."""
    import warnings

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            step()
    finally:
        torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).split(" does not have a deterministic")[0]
                   for w in caught if "deterministic" in str(w.message)})


def read_train_log(out):
    with open(os.path.join(out, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def train_net_path(dev, card, step_ms, workdir, reader):
    """``train_net`` at full width over the synthetic devkit: A straight to 6
    iterations (twice, to see whether the card's step is deterministic), B
    to 3 with a snapshot, then a new ``train_net`` on B's directory to 6;
    B's final state_dict against A's.  Returns {"snapshot": A's final
    snapshot, "counts": A's launch counts, "iter_ms": the median iteration
    time, "equal": whether two straight runs were bit-equal, "spread": their
    max |delta|, "deterministic": the cudnn.deterministic of A}."""
    import dataclasses

    from frcnn_tpu_torch.engine.train import combined_roidb, train_net
    from frcnn_tpu_torch.ops.cuda import build

    base = train_config(["DATA_DIR", workdir, "TRAIN.SNAPSHOT_KEPT", "1"])
    imdb, roidb = combined_roidb("voc_2007_trainval", base, reader=reader)
    if len(roidb) != 32:
        raise AssertionError(f"train_net: {len(roidb)} roidb entries, not 16 images + flips")

    def run(name, iters, snapshot_iters):
        cfg = dataclasses.replace(base, TRAIN=dataclasses.replace(
            base.TRAIN, SNAPSHOT_ITERS=snapshot_iters))
        out = os.path.join(workdir, name)
        solver = train_net(build_seeded(cfg, torch.bfloat16), imdb, roidb, None, out, cfg=cfg,
                           max_iters=iters, reader=reader)      # no device given: the card
        torch.cuda.synchronize()
        return solver, out

    deterministic = torch.backends.cudnn.deterministic
    try:
        torch.cuda.synchronize()
        build.reset_launch_counts()
        sw_a, out_a = run("a", 6, 100)
        counts = dict(build.LAUNCH_COUNTS)
        want = {name: 6 * n for name, n in TRAIN_LAUNCHES.items()}
        if counts != want:
            raise AssertionError(f"train_net launch counts {counts} != {want} "
                                 f"({TRAIN_LAUNCHES} per step, as the train path)")
        off = [n for n, t in list(sw_a.model.named_parameters()) + list(sw_a.model.named_buffers())
               if t.device != dev]
        if sw_a.device != dev or off:
            raise AssertionError(f"train_net: solver on {sw_a.device}, tensors off {dev}: {off}")
        log_a = read_train_log(out_a)
        if [r["iter"] for r in log_a] != list(range(1, 7)) or not all(
                np.isfinite(v) for r in log_a for k, v in r.items() if k not in ("iter", "ts")):
            raise AssertionError(f"train_net: train_log.jsonl {log_a}")
        iter_ms = statistics.median(1000.0 * (log_a[k]["ts"] - log_a[k - 1]["ts"])
                                    for k in range(2, 6))
        log(f"train_net path (res50 C4, batch {TRAIN_B}, {TRAIN_H}x{TRAIN_W}, bf16 trunk, "
            f"{len(roidb)}-entry devkit roidb): 6 iterations, launches per step "
            f"{ {k: v // 6 for k, v in counts.items()} } (the train path's), every parameter and "
            f"buffer on {dev}, losses finite ({log_a[0]['total_loss']:.4f} -> "
            f"{log_a[-1]['total_loss']:.4f})")
        log(f"train_net iteration (prefetch thread on; the batch's host prep, host-to-device copy, "
            f"step and loss readback): {iter_ms:.3f} ms, median of iterations 3-6 from "
            f"train_log.jsonl, against the train path's train_step {step_ms:.3f} ms on a "
            f"device-resident batch; on {card}")

        sw_a2, _ = run("a_again", 6, 100)
        equal, spread = state_spread(sw_a.model.state_dict(), sw_a2.model.state_dict())
        culprits = []
        if not equal:
            log(f"train_net: two straight runs differ (max |delta| {spread:.3e}); again with "
                "torch.backends.cudnn.deterministic = True")
            torch.backends.cudnn.deterministic = True
            sw_a, out_a = run("a_det", 6, 100)
            sw_a2, _ = run("a_det_again", 6, 100)
            equal, spread = state_spread(sw_a.model.state_dict(), sw_a2.model.state_dict())
            if not equal:
                blobs = sw_a2.data_layer.forward()
                culprits = nondeterministic_ops(lambda: sw_a2.train_step(blobs))
                log(f"train_net: straight runs still differ under deterministic cuDNN: max "
                    f"|delta| {spread:.3e}; ops without a deterministic CUDA implementation: "
                    f"{culprits or 'none named'}")
        log(f"train_net: two straight runs {'bit-equal' if equal else f'spread {spread:.3e}'} "
            f"(cudnn.deterministic {torch.backends.cudnn.deterministic})")

        sw_b, out_b = run("b", 3, 3)
        files = sorted(os.listdir(out_b))
        if files != ["default_iter_3.pkl", "default_iter_3.pth", "train_log.jsonl"]:
            raise AssertionError(f"train_net B to 3: files {files}")
        sw_b, _ = run("b", 6, 100)                          # resumes from iter 3
        files = sorted(os.listdir(out_b))
        if files != ["default_iter_6.pkl", "default_iter_6.pth", "train_log.jsonl"]:
            raise AssertionError(f"train_net B resumed to 6: files {files} (SNAPSHOT_KEPT 1)")
        log_b = read_train_log(out_b)
        if [r["iter"] for r in log_b] != list(range(1, 7)):
            raise AssertionError(f"train_net B did not resume at iteration 3: logged "
                                 f"{[r['iter'] for r in log_b]}")
        b_equal, b_spread = state_spread(sw_a.model.state_dict(), sw_b.model.state_dict())
        if equal and not b_equal:
            raise AssertionError(f"train_net: resumed run differs from the straight run, "
                                 f"max |delta| {b_spread:.3e}, where two straight runs are "
                                 "bit-equal")
        if not equal and not b_spread <= spread:
            raise AssertionError(f"train_net: resumed run off by {b_spread:.3e}, beyond the "
                                 f"spread of two straight runs {spread:.3e} ({culprits})")
        log(f"train_net resume: 3 iterations, snapshot, a new train_net on the same directory "
            f"to 6 (resumed at 3; SNAPSHOT_KEPT 1 pruned iter 3): final state_dict "
            + ("bit-equal to the straight run's" if b_equal else
               f"within {b_spread:.3e} of the straight run's (straight runs' spread "
               f"{spread:.3e})"))
        used = torch.backends.cudnn.deterministic
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return {"snapshot": os.path.join(out_a, "default_iter_6.pth"), "counts": counts,
            "iter_ms": iter_ms, "equal": equal, "spread": spread, "deterministic": used}


def test_net_path(dev, card, workdir, reader, snapshot, serve_ms):
    """``test_net`` at full width over the devkit's test split (16 images at
    800x1216, batch 8): phase (a)'s C4 model from its snapshot and a seeded
    res50_fpn.  Returns the launch counts of each run and the C4 run's
    results (per-class APs and mAP)."""
    import pickle

    from frcnn_tpu_torch.data.factory import get_imdb
    from frcnn_tpu_torch.engine.checkpoint import load_params
    from frcnn_tpu_torch.engine.test import test_net
    from frcnn_tpu_torch.models.network import build_model
    from frcnn_tpu_torch.ops.cuda import build

    cfg = smoke_config(["DATA_DIR", workdir])
    imdb = get_imdb("voc_2007_test", data_dir=workdir)
    c4 = build_model("res50", 21, cfg, dtype=torch.bfloat16)
    c4.load_state_dict(load_params(snapshot))
    nets = (("res50", c4.eval(), SERVE_LAUNCHES, serve_ms[0]),
            ("res50_fpn", build_seeded(cfg, torch.bfloat16, net="res50_fpn"), FPN_LAUNCHES,
             serve_ms[1]))
    all_counts, all_aps = [], []
    for net, model, per_batch, batch_ms in nets:
        out = os.path.join(workdir, "test_" + net)
        # eager first (the figure before graphs), then graphed, which is counted
        with made_detectors(eager=True):
            t0 = time.perf_counter()
            test_net(model, imdb, cfg, out + "_eager", max_per_image=100, batch=8,
                     reader=reader)
            torch.cuda.synchronize()
            eager_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        build.reset_launch_counts()
        with made_detectors() as made:
            t0 = time.perf_counter()
            aps = test_net(model, imdb, cfg, out, max_per_image=100, batch=8, reader=reader)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        counts = dict(build.LAUNCH_COUNTS)
        check_graphed(f"test_net {net}", made[0], per_batch, 2, counts)
        capture_s = sum(made[0].graphs.capture_seconds.values())
        if next(model.parameters()).device != dev:
            raise AssertionError(f"test_net {net}: model on {next(model.parameters()).device}")
        with open(os.path.join(out, "detections.pkl"), "rb") as f:
            all_boxes = pickle.load(f)
        if len(all_boxes) != 21 or any(len(c) != 16 for c in all_boxes) or not all(
                b.ndim == 2 and b.shape[1] == 5 and np.isfinite(b).all()
                for c in all_boxes for b in c):
            raise AssertionError(f"test_net {net}: malformed detections.pkl")
        n_det = sum(len(b) for c in all_boxes for b in c)
        if n_det == 0 or not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in aps.values()) \
                or len(aps) != 21:
            raise AssertionError(f"test_net {net}: {n_det} detections, APs {aps}")
        log(f"test_net {net} (16 images at 800x1216, batch 8, bf16 trunk, SCORE_THRESH 0.0): "
            f"detections.pkl read back ({n_det} detections), 20 per-class APs and mAP "
            f"{aps['mAP']:.4f} finite in [0, 1]; launches a replay {per_batch} (2 replays of "
            f"one graph); graphed {16 / seconds:.2f} images/s end to end (reader, prep thread, "
            f"detect, readback, VOC eval; {seconds:.3f} s, of which the warm-up and capture "
            f"{capture_s:.3f} s: {16 / (seconds - capture_s):.2f} images/s without them) against "
            f"eager {16 / eager_s:.2f} ({eager_s:.3f} s) and Detector.detect_blobs' "
            f"{8000.0 / batch_ms:.2f} on a device-resident batch; on {card}")
        all_counts.append(counts)
        all_aps.append(aps)
    return all_counts, all_aps[0]


def test_net_card_vs_cpu(dev, workdir, reader):
    """``test_net`` in f32 over the devkit's 4 val images (320x480) on the
    card and on a CPU copy of the same model: detections matched one to one
    per image and class; then ``im_detect`` of the first image on each,
    its rois matched one to one."""
    import pickle

    from frcnn_tpu_torch.data.factory import get_imdb
    from frcnn_tpu_torch.engine.test import im_detect, test_net
    from frcnn_tpu_torch.ops.cuda import build

    cfg = smoke_config(["TEST.SCALES", "(320,)", "TEST.MAX_SIZE", "480", "DATA_DIR", workdir,
                        "DEVICE.BUCKETS", "((320, 480),)", "TEST.SCORE_THRESH", "0.05"])
    imdb = get_imdb("voc_2007_val", data_dir=workdir)
    dets, ran, single, single_ran = [], [], [], []
    for device in (None, "cpu"):                              # None: the card
        out = os.path.join(workdir, f"val_{device or 'card'}")
        model = build_seeded(cfg, torch.float32, seed=1)
        with made_detectors() as made:
            ran.append(launches_during(lambda: test_net(model, imdb, cfg, out, batch=4,
                                                        reader=reader, device=device))[1])
        if device is None:       # one batch of 4: one graph captured and replayed once
            check_graphed("f32 test_net on the card", made[0], {"nms": 2, "roi_align": 1}, 1,
                          ran[0])
        before = dict(build.LAUNCH_COUNTS)
        single.append(im_detect(model, reader(imdb.image_path_at(0)), cfg, device=device))
        single_ran.append({k: v - before.get(k, 0) for k, v in build.LAUNCH_COUNTS.items()
                           if v != before.get(k, 0)})
        if device is None and next(model.parameters()).device != dev:
            raise AssertionError(f"im_detect left the model on {next(model.parameters()).device}")
        with open(os.path.join(out, "detections.pkl"), "rb") as f:
            all_boxes = pickle.load(f)
        dets.append([np.concatenate([np.concatenate([c[i], np.full((len(c[i]), 1), float(k))], 1)
                                     for k, c in enumerate(all_boxes)]) for i in range(4)])
    if ran[1] or made[0].graphs is not None:
        raise AssertionError(f"f32 test_net on the CPU launched {ran[1]} or made graphs")
    total = 0
    for i, (got, want) in enumerate(zip(*dets)):
        match_dets(want, got, f"f32 test_net image {i}, card vs CPU")
        total += len(want)
    if total == 0:
        raise AssertionError("f32 test_net: no detections to compare")
    if single_ran != [{"nms": 1, "roi_align": 1}, {}]:
        raise AssertionError(f"f32 im_detect launches: card {single_ran[0]} (want K1 x1, K2 x1), "
                             f"CPU {single_ran[1]}")
    rois = match_im_detect(single[1], single[0], "f32 im_detect, card vs CPU")
    log(f"test_net end to end (f32, TF32 off, 4 images at 320x480, batch 4): card (graphed, "
        f"K1 x2, K2 x1 a replay) "
        f"matches the CPU copy per image and class: {total} detections, score atol 1e-3, "
        f"box atol 5e-2; im_detect of image 0 on the card (K1 x1, K2 x1, model on {dev}): "
        f"{rois} rois of per-class scores and boxes matched to the CPU copy's, the same "
        "tolerances")


# ---------------------------------------------------------------------------
# The host data path: the resized-image cache, throughput, the host ops
# ---------------------------------------------------------------------------

def cached_train_net_path(dev, card, workdir, reader, straight, step_ms):
    """``train_net`` of phase 20 (a) with TRAIN.IMAGE_CACHE: C straight to 6
    iterations (the cache built through the reader, at the dataset level),
    then D to 3 with a snapshot and a new ``train_net`` to 6, both reusing
    the cache; C against 20's straight run A, D against C, under 20's rule
    (bit-equal where 20's two straight runs were, else within their spread);
    then one cached batch through ``train_step`` against the same batch cast
    to f32.  Returns C's launch counts."""
    import copy
    import dataclasses

    from frcnn_tpu_torch.data.cache import ResizedImageCache
    from frcnn_tpu_torch.engine.checkpoint import load_params
    from frcnn_tpu_torch.engine.train import combined_roidb, train_net
    from frcnn_tpu_torch.ops.cuda import build

    base = train_config(["DATA_DIR", workdir, "TRAIN.SNAPSHOT_KEPT", "1",
                         "TRAIN.IMAGE_CACHE", "True"])
    imdb, roidb = combined_roidb("voc_2007_trainval", base, reader=reader)
    prefix = os.path.join(workdir, "cache", "voc_2007_trainval_resized")
    reads, builds, seen = [], [], set()

    def counting_reader(path):
        reads.append(path)
        return reader(path)

    build_cache = ResizedImageCache.build

    def timed_build(*args, **kwargs):
        t0 = time.perf_counter()
        out = build_cache(*args, **kwargs)
        builds.append(time.perf_counter() - t0)
        return out

    def run(name, iters, snapshot_iters):
        cfg = dataclasses.replace(base, TRAIN=dataclasses.replace(
            base.TRAIN, SNAPSHOT_ITERS=snapshot_iters))
        model = build_seeded(cfg, torch.bfloat16)
        forward = model.train_forward

        def recorded(images, *args):
            seen.add((images.dtype, images.device))
            return forward(images, *args)

        model.train_forward = recorded
        out = os.path.join(workdir, name)
        solver = train_net(model, imdb, roidb, None, out, cfg=cfg, max_iters=iters,
                           reader=counting_reader)               # no device given: the card
        torch.cuda.synchronize()
        model.train_forward = forward
        return solver, out

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = straight["deterministic"]
    ResizedImageCache.build = timed_build
    try:
        torch.cuda.synchronize()
        build.reset_launch_counts()
        sw_c, out_c = run("c", 6, 100)
        counts = dict(build.LAUNCH_COUNTS)
        want = {name: 6 * n for name, n in TRAIN_LAUNCHES.items()}
        if counts != want:
            raise AssertionError(f"cached train_net launch counts {counts} != {want}")
        unique = sorted(set(e["image"] for e in roidb))
        if sorted(reads) != unique or not all(os.path.exists(prefix + ext)
                                              for ext in (".dat", ".idx")):
            raise AssertionError(f"cached train_net: {len(reads)} reads for {len(unique)} "
                                 f"images, cache files at {prefix}: "
                                 f"{sorted(os.listdir(os.path.dirname(prefix)))}")
        if seen != {(torch.uint8, dev)}:
            raise AssertionError(f"cached train_net: batches reached train_forward as {seen}, "
                                 f"not torch.uint8 on {dev}")
        off = [n for n, t in list(sw_c.model.named_parameters()) + list(sw_c.model.named_buffers())
               if t.device != dev]
        log_c = read_train_log(out_c)
        if off or [r["iter"] for r in log_c] != list(range(1, 7)) or not all(
                np.isfinite(v) for r in log_c for k, v in r.items() if k not in ("iter", "ts")):
            raise AssertionError(f"cached train_net: tensors off {dev}: {off}; log {log_c}")
        iter_ms = statistics.median(1000.0 * (log_c[k]["ts"] - log_c[k - 1]["ts"])
                                    for k in range(2, 6))
        dat_mb = os.path.getsize(prefix + ".dat") / 1e6
        log(f"cached train_net (res50 C4, batch {TRAIN_B}, {TRAIN_H}x{TRAIN_W}, bf16 trunk, "
            f"TRAIN.IMAGE_CACHE): cache built at {prefix}.{{dat,idx}} ({len(unique)} images, "
            f"{dat_mb:.1f} MB) in {builds[0]:.3f} s, {len(reads)} reader calls; batches reach "
            f"the card as torch.uint8; launches per step "
            f"{ {k: v // 6 for k, v in counts.items()} } (the train path's); losses finite "
            f"({log_c[0]['total_loss']:.4f} -> {log_c[-1]['total_loss']:.4f})")
        log(f"cached train_net iteration: {iter_ms:.3f} ms (median of iterations 3-6) against "
            f"phase 20's uncached {straight['iter_ms']:.3f} ms and the train path's train_step "
            f"{step_ms:.3f} ms ({iter_ms / step_ms:.3f}x the step); on {card}")

        rule = (f"bit-equal (20's straight runs were)" if straight["equal"] else
                f"within 20's spread {straight['spread']:.3e}")
        a_state = load_params(straight["snapshot"])
        c_state = {k: v.cpu() for k, v in sw_c.model.state_dict().items()}
        c_equal, c_spread = state_spread(a_state, c_state)
        if not (c_equal if straight["equal"] else c_spread <= straight["spread"]):
            raise AssertionError(f"cached train_net: final state_dict off 20's straight run by "
                                 f"{c_spread:.3e}; want {rule}")

        del reads[:]
        sw_d, out_d = run("d", 3, 3)
        sw_d, _ = run("d", 6, 100)                                 # resumes from iter 3
        log_d = read_train_log(out_d)
        files = sorted(os.listdir(out_d))
        if reads or len(builds) != 3 or [r["iter"] for r in log_d] != list(range(1, 7)) or \
                files != ["default_iter_6.pkl", "default_iter_6.pth", "train_log.jsonl"]:
            raise AssertionError(f"cached train_net resume: {len(reads)} reader calls (want 0), "
                                 f"{len(builds)} cache builds, iterations "
                                 f"{[r['iter'] for r in log_d]}, files {files}")
        d_equal, d_spread = state_spread(c_state, {k: v.cpu() for k, v in
                                                   sw_d.model.state_dict().items()})
        if not (d_equal if straight["equal"] else d_spread <= straight["spread"]):
            raise AssertionError(f"cached train_net: resumed run off the straight cached run "
                                 f"by {d_spread:.3e}; want {rule}")
        log(f"cached train_net exactness ({rule}): C's final state_dict against 20's straight "
            f"run A {'bit-equal' if c_equal else f'within {c_spread:.3e}'}; D (3 iterations, "
            f"snapshot, a new train_net to 6, resumed at 3) against C "
            f"{'bit-equal' if d_equal else f'within {d_spread:.3e}'}; both D runs reused the "
            f"cache (0 reader calls, cache reuse {builds[1]:.3f} / {builds[2]:.3f} s)")

        # one cached batch through train_step, then the same batch cast to f32 from
        # the same model, optimizer, step and draws
        blobs = sw_c.data_layer.forward()
        if blobs["data"].dtype != np.uint8:
            raise AssertionError(f"cached batch dtype {blobs['data'].dtype}")
        start = (copy.deepcopy(sw_c.model.state_dict()),
                 copy.deepcopy(sw_c.optimizer.state_dict()), sw_c.step)
        results = []
        for data in (blobs["data"], blobs["data"].astype(np.float32)):
            sw_c.model.load_state_dict(start[0])
            # a copy each time: the optimizer keeps the loaded momentum tensors and
            # updates them in place
            sw_c.optimizer.load_state_dict(copy.deepcopy(start[1]))
            sw_c.step = start[2]
            draws = torch.Generator(device=dev).manual_seed(12)
            losses = sw_c.train_step({**blobs, "data": data}, draws)
            results.append(({k: v.cpu() for k, v in losses.items()},
                            {k: v.cpu() for k, v in sw_c.model.state_dict().items()}))
        (l8, s8), (l32, s32) = results
        diff = max((l8[k].float() - l32[k].float()).abs().item() for k in l8)
        step_equal, step_spread = state_spread(s8, s32)
        if straight["equal"] and (diff != 0.0 or not step_equal):
            raise AssertionError(f"uint8 vs f32 batch through train_step: losses off by {diff:.3e}, "
                                 f"parameters by {step_spread:.3e}; want bit-equal")
        if not straight["equal"] and step_spread > straight["spread"]:
            raise AssertionError(f"uint8 vs f32 batch: parameters off by {step_spread:.3e}, beyond "
                                 f"20's spread {straight['spread']:.3e}")
        log(f"cached batch (uint8) through train_step against the same batch cast to f32: losses "
            f"{'bit-equal' if diff == 0.0 else f'within {diff:.3e}'}, parameters after the step "
            f"{'bit-equal' if step_equal else f'within {step_spread:.3e}'}")
    finally:
        ResizedImageCache.build = build_cache
        torch.backends.cudnn.deterministic = deterministic
    return counts


def throughput_path(dev, card, detector, serve_ms, iters=20, warmup=2):
    """``serve.throughput`` on phase 12's seeded res50 C4 (800x1216, bf16,
    batch 8), graphed: images/s > 0, one graph captured and replayed ``iters
    + warmup`` times with the serving launches; beside it the same loop
    eager (``eager_copy``).  Returns the launch counts."""
    from frcnn_tpu_torch.engine.serve import Detector, throughput
    from frcnn_tpu_torch.ops.cuda import build

    det = Detector(detector.model)
    eager_rate = throughput(eager_copy(det), 8, iters=iters, warmup=warmup)
    torch.cuda.synchronize()
    build.reset_launch_counts()
    rate = throughput(det, 8, iters=iters, warmup=warmup)
    torch.cuda.synchronize()
    counts = dict(build.LAUNCH_COUNTS)
    check_graphed("serve.throughput", det, SERVE_LAUNCHES, iters + warmup, counts)
    if not (np.isfinite(rate) and rate > 0):
        raise AssertionError(f"throughput: {rate} images/s")
    # 12's timing on throughput's own batch (its seed and noise), outside the counted
    # window: what separates the loop from the data (detect's time depends on it)
    h, w = det.cfg.DEVICE.BUCKETS[0]
    noise = torch.from_numpy(np.random.RandomState(0).uniform(0, 255, (8, h, w, 3))
                             .astype(np.float32)).to(dev)
    im_info = torch.tensor([[float(h), float(w), 1.0]] * 8, device=dev)
    noise_ms = cuda_ms(lambda: det.detect_blobs(noise, im_info), iters=10, warmup=2)
    log(f"serve.throughput (res50 C4, batch 8, 800x1216, bf16 trunk, {iters} timed batches after "
        f"{warmup}): graphed {rate:.2f} images/s against eager {eager_rate:.2f} "
        f"({rate / eager_rate:.4f}x), 8000 / phase 12's graphed batch time "
        f"{8000.0 / serve_ms:.2f} ({rate * serve_ms / 8000.0:.4f}x) and 8000 / 12's timing on "
        f"throughput's noise batch {8000.0 / noise_ms:.2f} ({noise_ms:.3f} ms); launches a "
        f"replay {SERVE_LAUNCHES}; on {card}")
    return counts


def host_ops_path(workdir, aps):
    """The host libraries on this machine: ``host_ops`` must build and load;
    ``apply_nms`` over phase 21's C4 detections.pkl keeps the rows of
    ``nms_fixed(..., use_kernels=False)``; ``tools/reval.py`` on that
    directory gives phase 21's APs; whether ``data_prep`` built."""
    import contextlib
    import io
    import pickle

    from frcnn_tpu_torch.engine.test import apply_nms
    from frcnn_tpu_torch.native import data_prep, host_ops
    from frcnn_tpu_torch.ops.nms import nms_fixed
    from frcnn_tpu_torch.tools import reval

    if not host_ops.have_native():
        raise AssertionError("native.host_ops: the C++ library did not build or load (g++)")
    out = os.path.join(workdir, "test_res50")
    with open(os.path.join(out, "detections.pkl"), "rb") as f:
        all_boxes = pickle.load(f)
    total = sum(len(b) for c in all_boxes for b in c)
    kept = {}
    for thresh in (0.3, 0.1):
        got = apply_nms(all_boxes, thresh)
        for cls, per_class in enumerate(all_boxes):
            for im, dets in enumerate(per_class):
                if len(dets) == 0:
                    continue
                t = torch.from_numpy(np.asarray(dets, np.float32))
                idx, keep = nms_fixed(t[:, :4], t[:, 4], thresh, len(dets), use_kernels=False)
                if not np.array_equal(got[cls][im], dets[idx[keep].numpy()]):
                    raise AssertionError(f"apply_nms at {thresh}, class {cls} image {im}: "
                                         "nms_cpu keeps other rows than nms_fixed's twin")
        kept[thresh] = sum(len(b) for c in got for b in c)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        results = reval.main([out, "--imdb", "voc_2007_test", "--data-dir", workdir])
    mean_line = [line for line in printed.getvalue().splitlines() if line.startswith("Mean AP")]
    if results != aps or mean_line != [f"Mean AP = {aps['mAP']:.4f}"]:
        raise AssertionError(f"reval: {results} ({mean_line}) != test_net's {aps}")
    built = data_prep.have_native()
    log(f"host ops: native.host_ops built with g++ and loaded; apply_nms over phase 21's C4 "
        f"detections.pkl ({total} rows) keeps nms_fixed's twin rows exactly at 0.3 ({kept[0.3]} "
        f"kept) and 0.1 ({kept[0.1]}); tools/reval.py prints test_net's {mean_line[0]}; "
        f"native.data_prep {'built' if built else 'did not build (no opencv4 dev files)'} "
        "(the devkit's JPEGs are empty placeholders served by a reader, so the native prep "
        "route is not taken here)")


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

# the same for FPN detect: the owner is the fpn module (its globals) or the model
FPN_STAGES = (
    ("fpn", "preprocess_images", "preprocess"),
    ("backbone", "stages", "trunk (stem, layer1-4; K3 x6)"),
    ("neck", "forward", "neck (laterals, top-down, output convs)"),
    ("model", "_rpn_all_levels", "RPN head over P2-P6"),
    ("fpn", "select_pre_nms", "pre-NMS top-k per level (K5 x2, sorts, delta select)"),
    ("fpn", "nms_fixed_batched", "proposal NMS (K1, 8x4741, cap 300)"),
    ("model", "_propose", "proposals total (top-k, decode, sort, K1)"),
    ("model", "_pool", "level assignment + RoIAlign (K6)"),
    ("model", "_classify", "box head (2 fc) + cls/bbox"),
    ("fpn", "postprocess_detections", "postprocess (decode, K1 per class, top-k)"),
    ("model", "detect", "detect total"),
)


# the same for the FPN train step
FPN_TRAIN_STAGES = (
    ("fpn", "preprocess_images", "preprocess"),
    ("backbone", "stages", "trunk forward (stem, layer1-4; K3 x6)"),
    ("neck", "forward", "neck forward"),
    ("model", "_rpn_all_levels", "RPN head over P2-P6 (with the class cells)"),
    ("fpn", "select_pre_nms", "pre-NMS top-k per level (K5 on P2, sorts, delta select)"),
    ("fpn", "nms_fixed_batched", "proposal NMS (K1, 8x8480, cap 2000)"),
    ("model", "_propose", "proposals total (top-k, decode, sort, K1)"),
    ("fpn", "anchor_target_compact", "anchor targets over 155520 anchors (K4, K5 x2)"),
    ("fpn", "proposal_target_layer", "proposal targets"),
    ("model", "_pool", "level assignment + RoIAlign forward (K6)"),
    ("model", "_classify", "box head (2 fc) + cls/bbox forward"),
    ("fpn", "gather_anchor_rows", "RPN loss rows (2 gathers)"),
    ("fpn", "detection_losses_compact", "losses"),
    ("model", "train_forward", "forward total"),
    ("optimizer", "step", "SGD update"),
)
FPN_GN_TRAIN_STAGES = tuple(
    ("backbone", "stages", "trunk forward (stem, layer1-4; 53 GroupNorms, no K3)")
    if stage[:2] == ("backbone", "stages") else stage for stage in FPN_TRAIN_STAGES)


def stage_times(owners, stages, step, n_steps=12, warmup=2):
    """CUDA events recorded on the current stream just before and just after
    each call of ``stages`` (the calls are wrapped for this measurement only)
    while ``step()`` runs; returns one {stage: ms, "step total": ms} per step
    after the warm-up."""
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

    originals = [(owners[o], attr, getattr(owners[o], attr)) for o, attr, _ in stages]
    for (obj, attr, fn), (_, _, stage) in zip(originals, stages):
        setattr(obj, attr, timed(fn, stage))
    per_step = []
    try:
        for i in range(n_steps):
            events.clear()
            step_ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            step_ev[0].record()
            step()
            step_ev[1].record()
            torch.cuda.synchronize()
            if i < warmup:
                continue
            ms = {}
            for stage, start, end in events:          # a stage called twice adds up
                ms[stage] = ms.get(stage, 0.0) + start.elapsed_time(end)
            ms["step total"] = step_ev[0].elapsed_time(step_ev[1])
            per_step.append((ms, {stage: (start, end) for stage, start, end in events}))
    finally:
        for obj, attr, fn in originals:
            if isinstance(obj, types.ModuleType):
                setattr(obj, attr, fn)
            else:
                delattr(obj, attr)           # back to the class's method
    return per_step


def device_profile(step, n_steps=3):
    """torch.profiler over ``n_steps`` calls of ``step()``: the union of the
    device's kernel intervals against the host wall time gives the idle
    share; every kernel summed by name, per step, the largest first."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
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
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return ({"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
             "idle_share": 1.0 - busy_us / 1e3 / wall_ms},
            [(name[:100], total / n_steps, n / n_steps) for name, (total, n) in ranked])


def write_profile(name, label, card, stages, prof, top, extra=None):
    result = {"card": card, "stages_ms_median_of_10": stages,
              f"profiler_3_{label}s": prof, f"top_kernels_ms_per_{label}": top[:25],
              **(extra or {})}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, name), "w") as f:
        json.dump(result, f, indent=1)
    log(f"{label} stages (ms, median of 10, CUDA events): "
        + ", ".join(f"{stage} {ms:.3f}" for stage, ms in stages.items()))
    log(f"{label} under torch.profiler, 3 {label}s: wall {prof['wall_ms']:.3f} ms, device busy "
        f"{prof['device_busy_ms']:.3f} ms, idle share {prof['idle_share']:.4f}")
    for kname, total, n in top[:10]:
        log(f"  {total:8.4f} ms/{label}  {n:6.1f} launches/{label}  {kname}")


def profile_train_step(solver, card, stage_list=TRAIN_STAGES, name="profile_train.json"):
    """Stage breakdown of a steady-state train step (``stage_times`` over
    ``stage_list``, medians of 10 steps after 2 warm-up steps; "backward"
    runs from the end of train_forward to the start of the SGD update:
    zero_grad, backward, clip), then ``device_profile`` over 3 steps and the
    peak device memory of those steps; all into chiprun_out/``name``."""
    from frcnn_tpu_torch.models import fpn, network

    model = solver.model
    owners = {"network": network, "fpn": fpn, "backbone": model.backbone, "model": model,
              "neck": getattr(model, "neck", None), "optimizer": solver.optimizer}
    blobs = {k: torch.as_tensor(v).to(solver.device)
             for k, v in solver.data_layer.forward().items()}
    per_step = stage_times(owners, stage_list, lambda: solver.train_step(blobs))
    for ms, ends in per_step:
        ms["backward"] = ends["forward total"][1].elapsed_time(ends["SGD update"][0])
    stages = {stage: statistics.median(ms[stage] for ms, _ in per_step)
              for stage in per_step[0][0]}
    torch.cuda.reset_peak_memory_stats()
    prof, top = device_profile(lambda: solver.train_step(blobs))
    prof["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    k4 = [(kname, ms, n) for kname, ms, n in top if "overlap" in kname]
    if len(k4) != 1 or not 0.0 < k4[0][2] <= 1.0:
        raise AssertionError(f"K4: want one kernel launch a step, got {k4}")
    log(f"K4 in the step: {k4[0][1] / k4[0][2]:.4f} ms on the device, one launch a step")
    extra = {"k4_device_ms_per_step": k4[0][1] / k4[0][2]}
    if hasattr(model, "neck"):
        pool = profile_pool_backward(model)
        extra["pool_forward_backward_kernels_ms_per_call"] = pool
        log("FPN RoI pool forward + backward alone, every device kernel (ms per call, launches): "
            + "; ".join(f"{kname.split('(')[0][-60:]} {ms:.4f} x{n:.0f}" for kname, ms, n in pool))
    write_profile(name, "step", card, stages, prof, top, extra)


def profile_pool_backward(model):
    """Every device kernel of the FPN RoI pool's forward and backward alone
    (``_pool`` on seeded channels-last level maps that require grad, 128 rois
    an image, a seeded gradient): K6, K6b and whatever autograd adds around
    them (a copy of a level's gradient would show here) → [(kernel, ms per
    call, launches per call)].  Fails unless K6b is one launch a call and no
    memset or rounding kernel runs."""
    dev = next(model.parameters()).device
    g = torch.Generator().manual_seed(13)
    levels = FPN_TRAIN_LEVELS + ((10, 16),)
    pyramid = [torch.randn((TRAIN_B, 256, h, w), generator=g).to(dev, torch.bfloat16)
               .contiguous(memory_format=torch.channels_last).requires_grad_(True)
               for h, w in levels]
    rois = torch.from_numpy(random_boxes(np.random.RandomState(13), TRAIN_B, 128,
                                         size=1000.0)).to(dev)
    dout = torch.randn((TRAIN_B, 128, 7, 7, 256), generator=g).to(dev, torch.bfloat16)

    def call():
        for p in pyramid:
            p.grad = None
        model._pool(pyramid, rois).backward(dout)

    call()
    if pyramid[4].grad is not None or any(p.grad is None or p.grad.shape != p.shape
                                          for p in pyramid[:4]):
        raise AssertionError("FPN pool backward: P2-P5 must get a gradient of their shape, P6 none")
    _, kernels = device_profile(call)
    backward = [(name, n) for name, _, n in kernels if "roi_align_bwd" in name]
    extra = [name for name, _, _ in kernels if "emset" in name or "bf16_kernel" in name]
    if [n for _, n in backward] != [1.0] or extra:
        raise AssertionError(f"FPN pool backward: want one K6b launch and no memset or rounding "
                             f"kernel, got {backward}, {extra}")
    return kernels


def profile_fpn_detect(detector, data, im_info, card):
    """Stage breakdown of a steady-state FPN detect batch (``stage_times``
    over FPN_STAGES, eager: a replay calls no Python to wrap), then
    ``device_profile`` over 3 graphed batches; all into
    chiprun_out/profile_fpn.json."""
    from frcnn_tpu_torch.models import fpn

    model = detector.model
    eager = eager_copy(detector)
    owners = {"fpn": fpn, "backbone": model.backbone, "neck": model.neck, "model": model}
    per_step = stage_times(owners, FPN_STAGES, lambda: eager.detect_blobs(data, im_info))
    stages = {name: statistics.median(ms[name] for ms, _ in per_step) for name in per_step[0][0]}
    prof, top = device_profile(lambda: detector.detect_blobs(data, im_info))
    write_profile("profile_fpn.json", "batch", card, stages, prof, top)


# ---------------------------------------------------------------------------
# The data mesh (phases 45-47)
# ---------------------------------------------------------------------------

# (path, net, launches per rank and step) of the mesh train phases 45 and 46
MESH_TRAIN = (("c4_train_dp", "res50", TRAIN_LAUNCHES),
              ("fpn_train_dp", "res50_fpn", FPN_TRAIN_LAUNCHES))
# (net, dtype, steps) of a rank's train arms: the f32 step that is compared
# tensor by tensor, the bf16 step that is counted, then timed over 3 more
MESH_ARMS = tuple((net, dtype, 1 if dtype == "float32" else 4)
                  for _, net, _ in MESH_TRAIN for dtype in ("float32", "bfloat16"))
MESH_REQUESTS = (8, 8, 8, 5)       # phase 12's 3 requests of 8, then one of 5 (padded to 6)
# of the ranks' 2 x 29 images served in bf16, the least that must match the
# unsharded Detector's on the whole request (54 measured on an H100: two images
# of the request of 5 miss on both ranks; PERF.md)
MESH_BF16_MATCHED = 52


def mesh_batch(rows=None):
    """The mesh phases' global batch of 8 at 608x1024 over phase 16's
    synthetic roidb, or its ``rows``: only their images are resized."""
    from frcnn_tpu_torch.data.loader import get_minibatch
    from frcnn_tpu_torch.engine.train import filter_roidb

    cfg = train_config()
    rng = np.random.RandomState(4)
    shapes = []
    for _ in range(16):
        h = int(rng.choice([375, 450, 480, 600]))
        shapes.append((h, int(h * rng.uniform(1.3, 1.66))))
    roidb, reader = synthetic_roidb(rng, shapes)
    roidb = filter_roidb(roidb, cfg)[:TRAIN_B]
    return get_minibatch(roidb, cfg, np.random.RandomState(0), reader=reader, rows=rows)


def mesh_requests():
    """Phase 12's 3 requests of 8 (800x1216 and 600x912 images) and one of 5."""
    bh, bw = smoke_config().DEVICE.BUCKETS[0]
    rng = np.random.RandomState(3)
    return [synthetic_images(rng, ([(bh, bw), (bh * 3 // 4, bw * 3 // 4)] * 4)[:n])
            for n in MESH_REQUESTS]


def mesh_train_step(net, dtype, blobs, mesh=None, steps=1):
    """``steps`` train steps of the seeded ``net`` (phase 16's weights and
    generator seed) on ``blobs``, over ``mesh`` (``blobs`` this rank's rows)
    or unsharded on cuda:0.  Returns {losses, start, state, counts} of the
    first step, and the host ms of the others, each ended by synchronizing
    the card and the ranks.  An f32 step runs under ``cudnn.deterministic``:
    cuDNN's default f32 algorithms move a weight by up to 1.5e-8 from one run
    to the next (PERF.md), and the one-rank NCCL step is held to the
    unsharded one bit for bit; the bf16 step is deterministic as it is."""
    from frcnn_tpu_torch.engine.train import SolverWrapper
    from frcnn_tpu_torch.ops.cuda import build
    from frcnn_tpu_torch.parallel.mesh import barrier

    cfg = train_config()
    torch.backends.cudnn.deterministic = dtype == "float32"
    try:
        solver = SolverWrapper(build_seeded(cfg, getattr(torch, dtype), net=net), [], cfg,
                               mesh=mesh)
        state = solver.model.state_dict()
        out = {"start": {k: v.detach().cpu().clone() for k, v in state.items()}}
        blobs = {k: torch.as_tensor(v).to(solver.device) for k, v in blobs.items()}
        torch.cuda.synchronize()
        build.reset_launch_counts()
        out["losses"] = {k: float(v) for k, v in solver.train_step(blobs).items()}
        torch.cuda.synchronize()
        out["counts"] = dict(build.LAUNCH_COUNTS)
        out["state"] = {k: v.detach().cpu().clone() for k, v in state.items()}
        out["times"] = []
        for _ in range(steps - 1):
            t0 = time.perf_counter()
            solver.train_step(blobs)
            torch.cuda.synchronize()
            if mesh is not None:
                barrier(mesh)
            out["times"].append((time.perf_counter() - t0) * 1000.0)
        if mesh is not None and steps > 1:       # the gradient mean alone, 3 times
            out["allreduce_ms"] = mesh_allreduce_ms(solver, mesh)
    finally:
        torch.backends.cudnn.deterministic = False
    del solver, state
    torch.cuda.empty_cache()
    return out


def mesh_allreduce_ms(solver, mesh, n=3):
    """Host ms of ``all_reduce_grads_`` over the solver's last gradients
    (median of ``n``), the card and the ranks synchronised around each."""
    from frcnn_tpu_torch.parallel.mesh import all_reduce_grads_, barrier

    params = [p for g in solver.optimizer.param_groups for p in g["params"]]
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        barrier(mesh)
        t0 = time.perf_counter()
        all_reduce_grads_(params, mesh)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1000.0)
    return statistics.median(times)


def two_shard_step(net, dtype, blobs, world=2):
    """The mesh step's arithmetic in this process: each rank's rows of
    ``blobs`` through ``train_forward`` with that rank's ``ShardedDraws``,
    the gradients summed in f32 and divided by ``world``, the losses' f32
    mean, then the clip and the SGD update.  Each half runs at the rank's
    batch shape, so where the card's kernels give an image results that
    depend on its batch (bf16 cuDNN), this is the step the mesh must equal
    bit for bit.  Returns {losses, state}."""
    from frcnn_tpu_torch.engine.train import SolverWrapper, clip_by_global_norm_
    from frcnn_tpu_torch.models.targets import ShardedDraws

    cfg = train_config()
    solver = SolverWrapper(build_seeded(cfg, getattr(torch, dtype), net=net), [], cfg)
    for group in solver.optimizer.param_groups:
        group["lr"] = solver.schedule(0) * group["lr_scale"]
    params = [p for g in solver.optimizer.param_groups for p in g["params"]]
    n = TRAIN_B // world
    sums, losses = None, None
    for r in range(world):
        feed = {k: torch.as_tensor(v[r * n:(r + 1) * n]).to(solver.device)
                for k, v in blobs.items()}
        gen = torch.Generator(device=solver.device).manual_seed(cfg.RNG_SEED + 1)
        step_losses, _ = solver.model.train_forward(
            feed["data"], feed["im_info"], feed["gt_boxes"], feed["gt_labels"],
            feed["gt_valid"], ShardedDraws(gen, r, world))
        solver.optimizer.zero_grad(set_to_none=True)
        step_losses["total_loss"].backward()
        grads = [p.grad.float() for p in params if p.grad is not None]
        sums = grads if sums is None else [a + b for a, b in zip(sums, grads)]
        vals = torch.stack([v.detach().float() for v in step_losses.values()])
        losses = vals if losses is None else losses + vals
    for p, g in zip([p for p in params if p.grad is not None], sums):
        p.grad.copy_(g / world)
    if cfg.TRAIN.GRAD_CLIP > 0:
        clip_by_global_norm_(params, cfg.TRAIN.GRAD_CLIP)
    solver.optimizer.step()
    out = {"losses": dict(zip(step_losses, (losses / world).tolist())),
           "state": {k: v.detach().cpu().clone() for k, v in solver.model.state_dict().items()}}
    del solver
    torch.cuda.empty_cache()
    return out


def k3_batch_witness(blobs, world=2):
    """Where the bf16 mesh step's bits part from the global step's: the
    seeded bf16 res50 trunk on the global batch with every K3 launch's
    inputs kept, then K3 again on each rank's rows of those inputs, which
    must give the rows of its batch-8 output bit for bit (the kernel has no
    term across images), and K3's plain twin, whose convolutions are
    cuDNN's, on the same rows against its own batch-8 result; last the
    whole trunk on rank 0's rows against its batch-8 rows.  Returns (K3
    launches checked, twin max abs diff, trunk max abs diff)."""
    from frcnn_tpu_torch.models.backbones import preprocess_images
    from frcnn_tpu_torch.ops.cuda import fused_block

    cfg = train_config()
    model = build_seeded(cfg, torch.bfloat16).to("cuda")
    x = preprocess_images(torch.as_tensor(blobs["data"]).to("cuda"), cfg,
                          torch.bfloat16).permute(0, 3, 1, 2)
    launches, kernel = [], fused_block.fused_bottleneck

    def kept(*args):
        out = kernel(*args)
        launches.append((args, out))
        return out

    fused_block.fused_bottleneck = kept
    try:
        with torch.no_grad():
            feat = model.backbone.extract_features(x)
    finally:
        fused_block.fused_bottleneck = kernel
    n, twin_err = TRAIN_B // world, 0.0
    with torch.no_grad():
        for i, ((xb, w1, b1, w2cat, b2, w3, b3, wds, bds), out) in enumerate(launches):
            w2 = w2cat.reshape(3, 3, w1.shape[1], w1.shape[1])
            twin = fused_block.bottleneck_reference(xb, w1, b1, w2, b2, w3, b3, wds, bds)
            for r in range(world):
                rows = slice(r * n, (r + 1) * n)
                if not torch.equal(kernel(xb[rows], w1, b1, w2cat, b2, w3, b3, wds, bds),
                                   out[rows]):
                    raise AssertionError(f"phase 45: K3 launch {i} gives rank {r}'s rows other "
                                         "bits alone than in the batch of 8")
                part = fused_block.bottleneck_reference(xb[rows], w1, b1, w2, b2, w3, b3,
                                                        wds, bds)
                twin_err = max(twin_err, (part.float() - twin[rows].float()).abs().max().item())
        trunk_err = (model.backbone.extract_features(x[:n]).float()
                     - feat[:n].float()).abs().max().item()
    if len(launches) != TRAIN_LAUNCHES["fused_block"]:
        raise AssertionError(f"phase 45: {len(launches)} K3 launches in the trunk, not "
                             f"{TRAIN_LAUNCHES['fused_block']}")
    del model, launches, feat
    torch.cuda.empty_cache()
    return TRAIN_LAUNCHES["fused_block"], twin_err, trunk_err


def mesh_rank(mesh, arms, serve):
    """One rank of phases 45-47: each (net, dtype, steps) train arm on the
    rank's rows of the global batch, then, with ``serve``, ``Detector`` over
    the mesh on the requests (launches counted) and ``serve.throughput`` of
    a global batch of 8, graphed and eager.  Returns per arm the losses, the replica's digest,
    the launch counts and step times, and rank 0's state."""
    from frcnn_tpu_torch.engine.serve import Detector, throughput
    from frcnn_tpu_torch.ops.cuda import build
    from frcnn_tpu_torch.parallel.dryrun import state_digest

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    blobs = mesh_batch(mesh.rows(TRAIN_B))
    out = {"device": str(mesh.device), "arms": []}
    for net, dtype, steps in arms:
        step = mesh_train_step(net, dtype, blobs, mesh, steps)
        out["arms"].append({"losses": step["losses"], "digest": state_digest(step["state"]),
                            "counts": step["counts"], "times": step["times"],
                            "allreduce_ms": step.get("allreduce_ms"),
                            "state": step["state"] if mesh.rank == 0 else None})
    if serve:
        requests = mesh_requests()
        det = Detector(build_seeded(smoke_config(), torch.bfloat16), uint8_input=True,
                       mesh=mesh)
        torch.cuda.synchronize()
        build.reset_launch_counts()
        out["results"] = [det(images) for images in requests]
        torch.cuda.synchronize()
        out["serve_counts"] = dict(build.LAUNCH_COUNTS)
        g = det.graphs
        out["serve_graphs"] = {"launches": list(g.launches.values()),
                               "captures": sum(g.captures.values()),
                               "replays": sum(g.replays.values())}
        out["images_per_s"] = throughput(det, 8, iters=10, warmup=2)
        out["eager_images_per_s"] = throughput(eager_copy(det), 8, iters=10, warmup=2)
        del det
        det = Detector(build_seeded(smoke_config(), torch.float32), uint8_input=True,
                       mesh=mesh)
        out["results_f32"] = [det(images) for images in requests]
    return out


def update_cosines(base, state):
    """[(cosine, name)] of each tensor's update in ``state`` against
    ``base``'s (both from ``base["start"]``), least first; a tensor that
    moves on neither side is left out."""
    rows = []
    for name, w in base["state"].items():
        start = base["start"][name].double().reshape(-1)
        d_want, d_got = w.double().reshape(-1) - start, state[name].double().reshape(-1) - start
        if d_want.any() or d_got.any():
            rows.append((float(torch.nn.functional.cosine_similarity(d_got, d_want, dim=0)),
                         name))
    return sorted(rows)


def check_mesh_train(phase, net, per_step, ranks, one, single, where, card, unsharded_ms):
    """Phase 45 or 46 from the ranks' results (``one``: the one-rank NCCL
    group's) against the unsharded steps ``single[dtype]``.  Returns rank
    0's launch counts of its bf16 step."""
    f32, bf16 = MESH_ARMS.index((net, "float32", 1)), MESH_ARMS.index((net, "bfloat16", 4))
    for arm in (f32, bf16):
        if len({r["arms"][arm]["digest"] for r in ranks}) != 1:
            raise AssertionError(f"phase {phase} {net}: the replicas differ across the ranks")
    # f32: the losses and every tensor against the unsharded step
    got, want = ranks[0]["arms"][f32], single["float32"]
    loss_err = max(abs(got["losses"][k] - c) / max(abs(c), 1.0)
                   for k, c in want["losses"].items())
    if loss_err > 2e-4:
        raise AssertionError(f"phase {phase} {net} f32: losses {got['losses']} against the "
                             f"unsharded {want['losses']}")
    worst, frozen = 0.0, 0
    for name, w in want["state"].items():
        g = got["state"][name]
        if torch.equal(w, want["start"][name]):          # frozen, or a buffer
            if not torch.equal(g, w):
                raise AssertionError(f"phase {phase} {net} f32: frozen {name} moved")
            frozen += 1
            continue
        diff = (g.double() - w.double()).abs()
        if (diff - 2e-4 * w.double().abs()).max().item() > 2e-5:
            raise AssertionError(f"phase {phase} {net} f32: {name} off the unsharded step "
                                 f"beyond rtol 2e-4 / atol 2e-5 (max abs {diff.max().item():.3g})")
        worst = max(worst, diff.max().item())
    # bf16: finite losses; the two-shard step in this process bit for bit; the
    # cosines against the global step recorded (bf16 cuDNN gives an image other
    # bits in a batch of 4 than in one of 8, which moves proposals and the
    # sampled rois, so only the two-shard step is the mesh's exact reference)
    got16, want16, shards = ranks[0]["arms"][bf16], single["bfloat16"], single["two_shard"]
    if not all(np.isfinite(v) for v in got16["losses"].values()):
        raise AssertionError(f"phase {phase} {net} bf16: losses {got16['losses']}")
    if (got16["losses"] != shards["losses"]
            or not all(torch.equal(got16["state"][k], v) for k, v in shards["state"].items())):
        raise AssertionError(f"phase {phase} {net} bf16: the mesh step is not the two-shard "
                             "step of this process bit for bit")
    cos, cos_shards = update_cosines(want16, got16["state"]), update_cosines(want16,
                                                                             shards["state"])
    counts = got16["counts"]
    if counts != per_step:
        raise AssertionError(f"phase {phase} {net}: launches {counts} per rank and step, not "
                             f"{per_step}")
    # NCCL, world 1: the unsharded f32 step bit for bit
    nccl = one["arms"][[a for a in MESH_ARMS if a[1] == "float32"].index((net, "float32", 1))]
    if (nccl["losses"] != want["losses"]
            or not all(torch.equal(nccl["state"][k], v) for k, v in want["state"].items())):
        raise AssertionError(f"phase {phase} {net}: the one-rank NCCL step is not the "
                             "unsharded f32 step bit for bit")
    step_ms = statistics.median(got16["times"])
    log(f"phase {phase} {net} over the mesh ({where}; global batch {TRAIN_B}, {TRAIN_H}x"
        f"{TRAIN_W}): f32 losses within {loss_err:.2e} relative of the unsharded step, every "
        f"updated tensor within rtol 2e-4 / atol 2e-5 (max abs diff {worst:.3g}), {frozen} "
        f"frozen tensors and buffers bit-unchanged, replicas bit-equal; bf16 losses finite "
        f"(total {got16['losses']['total_loss']:.6f} against {want16['losses']['total_loss']:.6f} "
        f"unsharded), the step bit-equal to the two-shard step of one process; updates against "
        f"the unsharded global step: least cosine {cos[0][0]:.6f} ({cos[0][1]}), next "
        f"{cos[1][0]:.6f} ({cos[1][1]}); the two-shard step's own: {cos_shards[0][0]:.6f} "
        f"({cos_shards[0][1]}); launches per rank and step {counts}; NCCL world 1 bit-equal "
        f"to the unsharded f32 step; bf16 step {step_ms:.3f} ms (median of 3, host clock, "
        f"card and ranks synchronised), of which the f32 gradient all-reduce alone "
        f"{got16['allreduce_ms']:.3f} ms, against {unsharded_ms:.3f} ms unsharded (CUDA "
        f"events) on {card}")
    return counts


def mesh_phases(card, serve_detector, serve_ms, train_ms):
    """Phases 45-47 (module docstring).  ``train_ms``: phases 16 and 18's
    unsharded bf16 step ms by net.  Returns rank 0's launch counts by path."""
    from frcnn_tpu_torch.engine.serve import Detector
    from frcnn_tpu_torch.parallel.mesh import spawn

    cards = torch.cuda.device_count()
    if cards >= 2:
        backend, why, where = "nccl", f"{cards} cards, one a rank", "2 ranks on 2 cards"
    else:
        backend = "gloo"
        why = ("one card: NCCL refuses two ranks on one GPU; gloo all-reduces and "
               "broadcasts CUDA tensors")
        where = "2 ranks sharing one card over gloo: not a scaling figure"
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    blobs = mesh_batch()
    single = {net: {dtype: mesh_train_step(net, dtype, blobs)
                    for dtype in ("float32", "bfloat16")}
              for _, net, _ in MESH_TRAIN}
    for _, net, _ in MESH_TRAIN:
        single[net]["two_shard"] = two_shard_step(net, "bfloat16", blobs)
    k3_checked, twin_err, trunk_err = k3_batch_witness(blobs)
    log(f"phase 45 witness: K3 at its {k3_checked} launches of the bf16 res50 trunk (global "
        f"batch {TRAIN_B}) gives each rank's {TRAIN_B // 2} rows the same bits alone as in the "
        f"batch; its plain twin (cuDNN's convolutions) on the same rows differs by up to "
        f"{twin_err:.6g}, the whole trunk on rank 0's rows by up to {trunk_err:.6g}")
    requests = mesh_requests()
    want_served = [serve_detector(images) for images in requests]
    f32_detector = Detector(build_seeded(smoke_config(), torch.float32), uint8_input=True)
    want_f32 = [f32_detector(images) for images in requests]
    del f32_detector
    # each rank's rows (a request padded to an even count with its last image)
    # served alone: the batches the ranks' kernels see
    want_rows = [[serve_detector([images[min(i, len(images) - 1)]
                                  for i in range(r * m, (r + 1) * m)])
                  for r in range(2)]
                 for images in requests for m in [(len(images) + 1) // 2]]
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    log(f"mesh: the unsharded references in {t1 - t0:.1f} s; backend {backend}, world 2 "
        f"({why}); then backend nccl, world 1 (the NCCL path on one card)")
    ranks = spawn(mesh_rank, 2, backend, MESH_ARMS, True, device="cuda", timeout_s=600)
    t2 = time.perf_counter()
    one = spawn(mesh_rank, 1, "nccl", [a for a in MESH_ARMS if a[1] == "float32"], False,
                device="cuda", timeout_s=600)[0]
    log(f"mesh: ranks on {[r['device'] for r in ranks]} in {t2 - t1:.1f} s, the NCCL rank on "
        f"{one['device']} in {time.perf_counter() - t2:.1f} s")

    counts = {}
    for phase, (path, net, per_step) in zip((45, 46), MESH_TRAIN):
        counts[path] = check_mesh_train(phase, net, per_step, ranks, one, single[net], where,
                                        card, train_ms[net])
    # 47: every rank returns the same list; each rank's rows are the unsharded
    # Detector's on those rows bit for bit; in f32 every image is matched one to
    # one with the unsharded Detector's on the whole request; in bf16 at least
    # MESH_BF16_MATCHED images are (bf16 cuDNN gives an image other bits in a
    # batch of 3 than in one of 5; K3 does not, phase 45's witness)
    for rank, r in enumerate(ranks):
        for req, (want, got) in enumerate(zip(want_f32, r["results_f32"])):
            for i, (w, g) in enumerate(zip(want, got)):
                match_dets(w, g, f"phase 47 f32 rank {rank} request {req} image {i}")
    misses = []
    for rank, r in enumerate(ranks):
        for req, (want, got) in enumerate(zip(want_served, r["results"])):
            if len(got) != len(want):
                raise AssertionError(f"phase 47 rank {rank} request {req}: {len(got)} results "
                                     f"for {len(want)} images")
            m = (len(want) + 1) // 2
            for i, (w, g) in enumerate(zip(want, got)):
                if not np.array_equal(g, ranks[0]["results"][req][i]):
                    raise AssertionError(f"phase 47 request {req} image {i}: rank {rank}'s "
                                         "list differs from rank 0's")
                if not np.array_equal(g, want_rows[req][i // m][i % m]):
                    raise AssertionError(f"phase 47 request {req} image {i}: not the unsharded "
                                         f"Detector's detections on rank {i // m}'s rows")
                why = dets_mismatch(w, g)
                if why is not None:
                    misses.append(f"rank {rank} request {req} image {i}: {why}")
    if 2 * sum(MESH_REQUESTS) - len(misses) < MESH_BF16_MATCHED:
        raise AssertionError(f"phase 47 bf16: {len(misses)} of the ranks' images unmatched with "
                             f"the unsharded Detector's on the whole request, fewer than "
                             f"{MESH_BF16_MATCHED} matched: {misses[:4]}")
    # graphed: rank 0's rows of the requests, 4, 4, 4 and 3, make two keys
    graphs = ranks[0]["serve_graphs"]
    want = {name: 2 * n * graphs["captures"] for name, n in SERVE_LAUNCHES.items()}
    counts["c4_serve_dp"] = ranks[0]["serve_counts"]
    if (counts["c4_serve_dp"] != want or graphs["captures"] != 2
            or graphs["replays"] != len(MESH_REQUESTS)
            or any(n != SERVE_LAUNCHES for n in graphs["launches"])):
        raise AssertionError(f"phase 47: rank 0's graphs {graphs} (want 2 captures of "
                             f"{SERVE_LAUNCHES} a replay, {len(MESH_REQUESTS)} replays), the "
                             f"wrappers counted {counts['c4_serve_dp']}, want {want}")
    REPLAYED["phase 47 rank 0"] = {name: n * len(MESH_REQUESTS)
                                   for name, n in SERVE_LAUNCHES.items()}
    rate, eager_rate = ranks[0]["images_per_s"], ranks[0]["eager_images_per_s"]
    n_images = 2 * sum(MESH_REQUESTS)
    log(f"phase 47 Detector over the mesh ({where}; res50 C4, bf16 trunk, 800x1216): requests "
        f"of {list(MESH_REQUESTS)} (5 padded to 6): every rank's list the same, each rank's "
        f"rows the unsharded Detector's on those rows bit for bit; {n_images - len(misses)} "
        f"of the ranks' {n_images} images matched one to one with the unsharded Detector's on "
        f"the whole request (at least {MESH_BF16_MATCHED} must; {misses[:2]}); in f32 (TF32 off) all {n_images}; launches per "
        f"rank counted by the wrappers {counts['c4_serve_dp']} (2 graphs captured, "
        f"{SERVE_LAUNCHES} a replay); serve.throughput over the mesh, global batch 8: graphed "
        f"{rate:.2f} images/s, {8000.0 / rate:.3f} ms a batch (eager {eager_rate:.2f}), against "
        f"{serve_ms:.3f} ms unsharded (phase 12) on {card}")
    return counts


# ---------------------------------------------------------------------------
# The COCO recipe: res101 C4 at 81 classes and four anchor scales, the C4
# threshold route, train_net -> test_net -> COCOEval
# ---------------------------------------------------------------------------

# the 80 COCO categories at their ids (1-90, ten ids unused)
COCO_CATEGORIES = tuple(zip(
    (i for i in range(1, 91) if i not in (12, 26, 29, 30, 45, 66, 68, 69, 71, 83)),
    ("person", "bicycle", "car", "motorcycle", "airplane", "bus", "train", "truck", "boat",
     "traffic light", "fire hydrant", "stop sign", "parking meter", "bench", "bird", "cat",
     "dog", "horse", "sheep", "cow", "elephant", "bear", "zebra", "giraffe", "backpack",
     "umbrella", "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball",
     "kite", "baseball bat", "baseball glove", "skateboard", "surfboard", "tennis racket",
     "bottle", "wine glass", "cup", "fork", "knife", "spoon", "bowl", "banana", "apple",
     "sandwich", "orange", "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
     "couch", "potted plant", "bed", "dining table", "toilet", "tv", "laptop", "mouse",
     "remote", "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
     "refrigerator", "book", "clock", "vase", "scissors", "teddy bear", "hair drier",
     "toothbrush")))


def write_coco_dataset(root, splits, rng, many=None):
    """A COCO-format dataset under DATA_DIR ``root`` for a machine without an
    image codec: coco/annotations/instances_<split>.json for each split of
    ``splits`` ({split: [(h, w), ...]}: "train2014", "minival2014",
    "valminusminival2014"), the 80 categories at their COCO ids, an empty
    placeholder for each image path (images/train2014/..., and
    images/val2014/... for the val splits, as ``data.coco`` reads them), and
    a reader (image path → BGR uint8 array) that serves the pixels:
    ``synthetic_images`` with each annotated box painted flat.  An image has
    3-12 annotations of one to four categories, float xywh boxes, about one
    in six a crowd (iscrowd 1); each split's image 1 also has a zero-area
    annotation, which the roidb drops.  ``many`` = (split, n): that split's
    image 0 has n annotations."""
    pixels = {}
    image_id, ann_id = 1, 1
    ann_dir = os.path.join(root, "coco", "annotations")
    os.makedirs(ann_dir, exist_ok=True)
    categories = [{"id": i, "name": name, "supercategory": ""} for i, name in COCO_CATEGORIES]
    for split, shapes in splits.items():
        folder = "val2014" if split.startswith(("minival", "valminusminival")) else split
        img_dir = os.path.join(root, "coco", "images", folder)
        os.makedirs(img_dir, exist_ok=True)
        images, anns = [], []
        for i, (im, (h, w)) in enumerate(zip(synthetic_images(rng, shapes), shapes)):
            n = many[1] if many and many[0] == split and i == 0 else rng.randint(3, 13)
            cats = [COCO_CATEGORIES[j][0] for j in rng.choice(80, rng.randint(1, 5), replace=False)]
            for _ in range(n):
                bw, bh = rng.uniform(w / 12, w / 2), rng.uniform(h / 12, h / 2)
                x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
                im[int(y):int(y + bh), int(x):int(x + bw)] = rng.randint(0, 255, 3)
                anns.append({"id": ann_id, "image_id": image_id,
                             "category_id": int(cats[rng.randint(len(cats))]),
                             "bbox": [round(x, 2), round(y, 2), round(bw, 2), round(bh, 2)],
                             "area": round(bw * bh * rng.uniform(0.5, 0.9), 2),
                             "iscrowd": int(rng.uniform() < 1 / 6)})
                ann_id += 1
            if i == 1:
                anns.append({"id": ann_id, "image_id": image_id, "category_id": int(cats[0]),
                             "bbox": [10.0, 10.0, 0.0, 20.0], "area": 0.0, "iscrowd": 0})
                ann_id += 1
            name = f"COCO_{folder}_{image_id:012d}.jpg"
            path = os.path.join(img_dir, name)
            open(path, "wb").close()
            pixels[path] = im
            images.append({"id": image_id, "file_name": name, "width": w, "height": h})
            image_id += 1
        with open(os.path.join(ann_dir, f"instances_{split}.json"), "w") as f:
            json.dump({"images": images, "annotations": anns, "categories": categories}, f)
    return pixels.__getitem__


# the C4 threshold route's config: a pre-NMS list short enough for the K5 gate
# (K >= 24 x 1000) at 800x1216, 45600 anchors (COCO) and 34200 (VOC)
ROUTE_CONFIG = ("TEST.RPN_PRE_NMS_TOP_N", "1000")


def threshold_route_path(dev, card, detector, label, extra=(), per_batch=SERVE_LAUNCHES):
    """The C4 threshold route: ``detector``'s model (bf16, 800x1216) at
    TEST.RPN_PRE_NMS_TOP_N 1000 with DEVICE.THRESHOLD_SELECT on and off, one
    batch of 8 (half the images 600x912, so that the anchors centred on
    their padding give each row a NEG_INF tail): K5 once a batch with the
    route on and never with it off, the detections and valid masks
    bit-equal, the batch time of each.  Returns {True: launches on, False:
    launches off}."""
    from frcnn_tpu_torch.engine.serve import Detector, iter_bucket_batches
    from frcnn_tpu_torch.ops.cuda import build

    model, saved = detector.model, detector.model.config
    bh, bw = saved.DEVICE.BUCKETS[0]
    images = synthetic_images(np.random.RandomState(18), [(bh, bw), (bh * 3 // 4, bw * 3 // 4)] * 4)
    (_, blob, info), = iter_bucket_batches(images, saved, keep_uint8=True)
    data, im_info = torch.from_numpy(blob).to(dev), torch.from_numpy(info).to(dev)
    counts, outs, times = {}, {}, {}
    want = {True: {**per_batch, "select": 1}, False: per_batch}
    try:
        for route in (True, False):
            model.config = smoke_config([*extra, *ROUTE_CONFIG, "DEVICE.THRESHOLD_SELECT",
                                         str(route)])
            det = Detector(model, uint8_input=True)
            torch.cuda.synchronize()
            build.reset_launch_counts()
            dets, valid = det.detect_blobs(data, im_info)
            torch.cuda.synchronize()
            counts[route] = dict(build.LAUNCH_COUNTS)
            check_graphed(f"{label} threshold route {'on' if route else 'off'}", det,
                          want[route], 1, counts[route])
            outs[route] = (dets.clone(), valid.clone())
            times[route] = cuda_ms(lambda: det.detect_blobs(data, im_info), iters=10, warmup=2)
    finally:
        model.config = saved
    (d_on, v_on), (d_off, v_off) = outs[True], outs[False]
    if not (torch.equal(d_on, d_off) and torch.equal(v_on, v_off)):
        raise AssertionError(f"{label} threshold route: detections differ with the route on "
                             f"({(d_on != d_off).any(-1).sum().item()} rows)")
    log(f"{label} threshold route (TEST.RPN_PRE_NMS_TOP_N 1000, bf16, batch 8, {bh}x{bw}): "
        f"detections ({int(v_on.sum())} valid) and valid masks bit-equal with "
        f"DEVICE.THRESHOLD_SELECT on and off; K5 1 a replay on, 0 off; {times[True]:.3f} ms a "
        f"graphed batch on, {times[False]:.3f} off (median of 10, CUDA events) on {card}")
    return counts


def coco_shapes(rng):
    """The synthetic COCO's splits, each image's short side at its split's
    scale (nothing resized): train2014 16 images at the train path's 600
    (32 entries with the flips), minival2014 16 at the serving bucket's 800."""
    return {"train2014": [(600, int(w)) for w in rng.randint(800, 1001, 16)],
            "minival2014": [(800, int(w)) for w in rng.randint(1000, 1217, 16)]}


def host_cpu() -> str:
    """The host's CPU for host times (COCOEval's): lscpu's vendor, model name
    and architecture (a virtual CPU may name its model "unknown"), and the
    core count."""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        out = ""
    fields = dict(line.split(":", 1) for line in out.splitlines() if ":" in line)
    named = [fields.get(k, "").strip() for k in ("Vendor ID", "Model name", "Architecture")]
    return f"{' '.join(v for v in named if v and v != 'unknown') or 'an unnamed CPU'}, " \
           f"{os.cpu_count()} cores"


def coco_eval_load(rng, n_images=5000, per_image=100):
    """A minival-sized COCOEval input: ``n_images`` images, a count of gts an
    image drawn geometric with the COCO paper's mean of 7.7 instances (at
    most 90) over one to six of the 80 categories, float xywh boxes 8-400
    px, 1% crowds; ``per_image`` dets an image, 60 of them near gts of the
    image (jittered by 10%) and the rest anywhere in any category, scores
    uniform.  Returns (gts, dets, categories)."""
    ids = [i for i, _ in COCO_CATEGORIES]
    gts, dets = [], []
    ann_id = 1
    for img in range(n_images):
        cats = rng.choice(ids, rng.randint(1, 7), replace=False)
        n = min(int(rng.geometric(1 / 7.7)), 90)
        wh = np.exp(rng.uniform(np.log(8), np.log(400), (n, 2)))
        xy = rng.uniform(0, 1, (n, 2)) * (np.array([640.0, 480.0]) - wh).clip(1)
        labels = cats[rng.randint(0, len(cats), n)]
        for k in range(n):
            gts.append({"id": ann_id, "image_id": img, "category_id": int(labels[k]),
                        "bbox": [*map(float, xy[k]), *map(float, wh[k])],
                        "area": float(wh[k, 0] * wh[k, 1] * 0.8),
                        "iscrowd": int(rng.uniform() < 0.01)})
            ann_id += 1
        near = min(60, per_image) if n else 0
        pick = rng.randint(0, max(n, 1), near)
        jit = rng.normal(0, 0.1, (near, 4)) * np.tile(wh[pick], 2) if n else np.zeros((0, 4))
        boxes = np.concatenate([np.concatenate([xy[pick], wh[pick]], 1) + jit,
                                np.concatenate([rng.uniform(0, 600, (per_image - near, 2)),
                                                np.exp(rng.uniform(np.log(8), np.log(400),
                                                                   (per_image - near, 2)))], 1)])
        boxes[:, 2:] = boxes[:, 2:].clip(1)
        cat = np.concatenate([labels[pick], rng.choice(ids, per_image - near)])
        for box, c, score in zip(boxes.tolist(), cat.tolist(), rng.uniform(0, 1, per_image)):
            dets.append({"image_id": img, "category_id": int(c), "bbox": box,
                         "score": float(score)})
    return gts, dets, [{"id": i, "name": name} for i, name in COCO_CATEGORIES]


def coco_train_test_path(dev, card, serve_ms):
    """The COCO recipe at full width over a synthetic COCO written into a
    temporary directory: the roidb (80 categories, crowds, the zero-area
    annotation dropped, one image of 70 annotations cut to DEVICE.MAX_GT in
    its minibatch); ``train_net`` (res101, 81 classes, four anchor scales,
    batch 8, 608x1024, bf16) for 6 iterations with the launches of phase 16
    a step, finite losses, frozen tensors bit-unchanged, the median iteration
    beside the bare step and the peak memory; one f32 train step card vs
    CPU; ``test_net`` over minival2014 from the final snapshot (batch 8,
    800x1216, SCORE_THRESH 0.0): the results json and the 12 stats finite in
    [-1, 1], images/s beside ``serve_ms``'s; COCOEval's host seconds on those
    detections and on a minival-sized set (``coco_eval_load``).  Returns the
    launch counts of ``train_net`` and ``test_net``."""
    import pickle

    from frcnn_tpu_torch.data.coco_eval import COCOEval
    from frcnn_tpu_torch.data.factory import get_imdb
    from frcnn_tpu_torch.data.loader import get_minibatch
    from frcnn_tpu_torch.engine.checkpoint import load_params
    from frcnn_tpu_torch.engine.test import test_net
    from frcnn_tpu_torch.engine.train import combined_roidb, train_net
    from frcnn_tpu_torch.models.network import build_model
    from frcnn_tpu_torch.ops.cuda import build

    workdir = tempfile.mkdtemp(prefix="chip_smoke_coco_")
    try:
        rng = np.random.RandomState(19)
        reader = write_coco_dataset(workdir, coco_shapes(rng), rng, many=("train2014", 70))
        cfg = train_config(["DATA_DIR", workdir, "TRAIN.SNAPSHOT_ITERS", "100", *COCO_CONFIG])
        imdb, roidb = combined_roidb("coco_2014_train", cfg, reader=reader)
        ids = [i for i, _ in COCO_CATEGORIES]
        maps = [imdb._class_to_coco_cat_id[imdb.classes[c]] for c in range(1, 81)]
        crowds = sum(int((e["gt_overlaps"] == -1).all(1).sum()) for e in roidb)
        many = max(len(e["boxes"]) for e in roidb)
        if (imdb.num_classes != COCO_CLASSES or maps != ids or len(roidb) != 32 or not crowds
                or many != 70):
            raise AssertionError(f"COCO roidb: {imdb.num_classes} classes, {len(roidb)} entries, "
                                 f"{crowds} crowds, at most {many} gts an entry")
        cut = get_minibatch([e for e in roidb if len(e["boxes"]) == 70][:1], cfg,
                            np.random.RandomState(0), reader=reader)
        if int(cut["gt_valid"].sum()) != cfg.DEVICE.MAX_GT:
            raise AssertionError(f"COCO minibatch: {int(cut['gt_valid'].sum())} valid gts of 70, "
                                 f"not DEVICE.MAX_GT {cfg.DEVICE.MAX_GT}")
        log(f"COCO roidb (coco_2014_train, synthetic): {imdb.num_classes} classes over the "
            f"category ids {ids[0]}-{ids[-1]} ({len(ids)} of them), {len(roidb)} entries with the "
            f"flips, {crowds} crowd gts (gt_overlaps -1, kept as gts), an image of {many} gts cut "
            f"to DEVICE.MAX_GT {cfg.DEVICE.MAX_GT} in its minibatch")

        model = build_seeded(cfg, torch.bfloat16, net="res101", classes=COCO_CLASSES)
        frozen = {n: p.detach().clone() for n, p in model.named_parameters()
                  if not p.requires_grad}
        out = os.path.join(workdir, "train")
        torch.cuda.synchronize()
        build.reset_launch_counts()
        solver = train_net(model, imdb, roidb, None, out, cfg=cfg, max_iters=6,
                           reader=reader)                           # no device given: the card
        torch.cuda.synchronize()
        train_counts = dict(build.LAUNCH_COUNTS)
        want = {name: 6 * n for name, n in TRAIN_LAUNCHES.items()}
        if train_counts != want or solver.device != dev:
            raise AssertionError(f"COCO train_net on {solver.device}: launch counts "
                                 f"{train_counts} != {want} ({TRAIN_LAUNCHES} per step)")
        params = dict(model.named_parameters())
        moved = [n for n, p in frozen.items() if not torch.equal(params[n].cpu(), p)]
        records = read_train_log(out)
        if moved or [r["iter"] for r in records] != list(range(1, 7)) or not all(
                np.isfinite(v) for r in records for k, v in r.items() if k not in ("iter", "ts")):
            raise AssertionError(f"COCO train_net: frozen tensors moved {moved}; log {records}")
        iter_ms = statistics.median(1000.0 * (records[k]["ts"] - records[k - 1]["ts"])
                                    for k in range(2, 6))
        blobs = {k: torch.as_tensor(v).to(dev) for k, v in solver.data_layer.forward().items()}
        torch.cuda.reset_peak_memory_stats()
        step_ms = cuda_ms(lambda: solver.train_step(blobs), iters=10, warmup=2)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"COCO train_net (res101 C4, 81 classes, ANCHOR_SCALES (4, 8, 16, 32), batch "
            f"{TRAIN_B}, {TRAIN_H}x{TRAIN_W}, bf16 trunk): 6 iterations, launches per step "
            f"{ {k: v // 6 for k, v in train_counts.items()} }, losses finite "
            f"({records[0]['total_loss']:.4f} -> {records[-1]['total_loss']:.4f}), {len(frozen)} "
            f"frozen tensors bit-unchanged; iteration {iter_ms:.3f} ms (median of iterations 3-6) "
            f"against a bare train_step of {step_ms:.3f} ms (median of 10, CUDA events), peak "
            f"device memory {peak:.3f} GiB on {card}")
        del solver, model, blobs
        train_card_vs_cpu(dev, "res101", classes=COCO_CLASSES)

        test_cfg = smoke_config(["DATA_DIR", workdir, *COCO_CONFIG])
        val = get_imdb("coco_2014_minival", data_dir=workdir)
        model = build_model("res101", COCO_CLASSES, test_cfg, dtype=torch.bfloat16)
        model.load_state_dict(load_params(os.path.join(out, "default_iter_6.pth")))
        test_out = os.path.join(workdir, "test")
        torch.cuda.synchronize()
        build.reset_launch_counts()
        with made_detectors() as made:
            t0 = time.perf_counter()
            stats = test_net(model.eval(), val, test_cfg, test_out, max_per_image=100, batch=8,
                             reader=reader)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        test_counts = dict(build.LAUNCH_COUNTS)
        check_graphed("COCO test_net", made[0], COCO_SERVE_LAUNCHES, 2, test_counts)
        capture_s = sum(made[0].graphs.capture_seconds.values())
        with open(os.path.join(test_out, f"detections_{val.name}_results.json")) as f:
            results = json.load(f)
        bad = {r["category_id"] for r in results} - set(ids)
        if not results or bad or len(stats) != 12 or not all(
                np.isfinite(v) and -1.0 <= v <= 1.0 for v in stats.values()):
            raise AssertionError(f"COCO test_net: {len(results)} results (unknown category ids "
                                 f"{bad}), stats {stats}")
        with open(os.path.join(test_out, "detections.pkl"), "rb") as f:
            all_boxes = pickle.load(f)
        t1 = time.perf_counter()
        again = val.evaluate_detections(all_boxes)
        eval_s = time.perf_counter() - t1
        if again != stats:
            raise AssertionError(f"COCO evaluate_detections again: {again} != {stats}")
        log(f"COCO test_net (res101 from the train_net snapshot, minival2014: 16 images at "
            f"800x1216, batch 8, bf16, SCORE_THRESH 0.0): {len(results)} results in the json at "
            f"their COCO category ids, the 12 stats finite in [-1, 1] (AP {stats['AP']:.4f}, "
            f"AR100 {stats['AR100']:.4f}); launches a replay {COCO_SERVE_LAUNCHES} (2 replays of "
            f"one graph); {16 / seconds:.2f} images/s end to end ({seconds:.3f} s: reader, prep "
            f"thread, detect with the graph's warm-up and capture ({capture_s:.3f} s), readback, "
            f"COCOEval) against "
            f"detect_blobs' {8000.0 / serve_ms:.2f} on a device-resident batch; on {card}")

        t2 = time.perf_counter()
        gts, dets, categories = coco_eval_load(np.random.RandomState(20))
        made_s = time.perf_counter() - t2
        t3 = time.perf_counter()
        ev = COCOEval(gts, dets, categories)
        ev.evaluate()
        ev.accumulate()
        big = ev.summarize(verbose=False)
        big_s = time.perf_counter() - t3
        if not all(np.isfinite(v) and -1.0 <= v <= 1.0 for v in big.values()):
            raise AssertionError(f"COCOEval on the minival-sized set: stats {big}")
        log(f"COCOEval host time: {eval_s:.3f} s over test_net's {len(results)} detections of "
            f"16 images; {big_s:.3f} s over a minival-sized set (5000 images, 80 categories, "
            f"{len(gts)} gts, {len(dets)} dets; made in {made_s:.3f} s; AP {big['AP']:.4f}) on "
            f"{host_cpu()}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return train_counts, test_counts


def coco_phases(dev, card, serve_detector, models):
    """Phases 48-50: res101 at 81 classes and four anchor scales served, the
    C4 threshold route on it and on phase 12's res50 (``serve_detector``),
    then train_net -> test_net -> COCOEval.  Returns the launch counts by
    path (48, 49 on and off for each model, and 50's driven runs); the
    served model goes into ``models`` for phase 51."""
    paths = {}
    paths["coco_serve"], coco_ms, coco_detector = main_path(dev, card, "res101",
                                                            COCO_SERVE_LAUNCHES, COCO_CONFIG,
                                                            COCO_CLASSES)[:3]
    end_to_end(dev, "res101", COCO_CONFIG, classes=COCO_CLASSES)
    for name, det, extra, per_batch in (
            ("coco", coco_detector, COCO_CONFIG, COCO_SERVE_LAUNCHES),
            ("voc", serve_detector, (), SERVE_LAUNCHES)):
        label = "res101 COCO" if name == "coco" else "res50 VOC"
        route = threshold_route_path(dev, card, det, label, extra, per_batch)
        paths[f"c4_route_{name}_on"], paths[f"c4_route_{name}_off"] = route[True], route[False]
    models["res101_coco"] = coco_detector.model
    del coco_detector
    paths["coco_train_net"], paths["coco_test_net"] = coco_train_test_path(dev, card, coco_ms)
    return paths


# ---------------------------------------------------------------------------
# Phase 51: graphed serving against eager detect
# ---------------------------------------------------------------------------

# the serving families of phases 12, 14, 23, 27, 31, 36 and 48: (name, net,
# config, classes, launches a batch)
SERVING_FAMILIES = (
    ("res50", "res50", (), 21, SERVE_LAUNCHES),
    ("res50_fpn", "res50_fpn", (), 21, FPN_LAUNCHES),
    ("res50_fpn_gn", "res50_fpn_gn", GN_CONFIG, 21, FPN_GN_LAUNCHES),
    ("vgg16", "vgg16", (), 21, C4_PLAIN_SERVE_LAUNCHES),
    ("mobile", "mobile", (), 21, C4_PLAIN_SERVE_LAUNCHES),
    ("vgg16_top", "vgg16", ("TEST.MODE", "top"), 21, TOP_SERVE_LAUNCHES),
    ("res101_coco", "res101", COCO_CONFIG, COCO_CLASSES, COCO_SERVE_LAUNCHES),
)
# the device kernel each wrapper's count stands for, as torch.profiler names it
KERNEL_SYMBOLS = {"nms": "nms_chunk_kernel", "roi_align": "roi_align_fwd_kernel",
                  "roi_align_ml": "roi_align_ml_fwd_kernel",
                  "fused_block": "fused_bottleneck_kernel", "select": "topk_select_kernel",
                  "overlap": "overlap_stats_kernel", "roi_align_bwd": "roi_align_bwd_tile_kernel",
                  "bn_epilogue": "bn_epilogue_kernel"}


def profiled_kernels(step):
    """torch.profiler over a warm ``step()`` and a counted one: the port's
    kernels the counted step ran on the device, by wrapper name.  Late in a
    full run the profiler lost the first ~19 device records of its window
    (phase 51: a replay's copy-in and first 17 kernels, the stem's BN
    epilogue among them), so the counted step is the second.  Its kernels
    are those that start after a marker kernel (``torch.cuda._sleep``'s)
    run between the two steps: device times against device times, where a
    range's host times once took in the warm step's last NMS."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
        torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()
        step()
        torch.cuda.synchronize()
    cuda = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    marks = [e for e in cuda if "spin_kernel" in e.name]
    if len(marks) != 1:
        raise AssertionError(f"profiled_kernels: {len(marks)} marker kernels in the profile")
    ran = {}
    for e in cuda:
        if e.time_range.start >= marks[0].time_range.end:
            for wrapper, symbol in KERNEL_SYMBOLS.items():
                if symbol in e.name:
                    ran[wrapper] = ran.get(wrapper, 0) + 1
    return ran


def wall_ms(step, n=10):
    """Host milliseconds of ``n`` calls of ``step()`` queued back to back,
    from a synchronized device to the last call's end."""
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def eager_detections(model, images, cfg, max_per_image, dev):
    """``model.detect`` op by op on ``images``' bucket groups (uint8, as
    ``Detector(uint8_input=True)`` prepares them) → per image (k, 6)
    arrays, and the groups' (dets, valid) tensors."""
    from frcnn_tpu_torch.engine.serve import iter_bucket_batches

    results, groups = [None] * len(images), []
    for indices, data, info in iter_bucket_batches(images, cfg, keep_uint8=True):
        data, info = torch.from_numpy(data).to(dev), torch.from_numpy(info).to(dev)
        with torch.inference_mode():
            dets, valid = model.detect(data, info, max_per_image)
        groups.append((data, info, dets, valid))
        d, v = dets.cpu().numpy(), valid.cpu().numpy()
        for bi, i in enumerate(indices):
            results[i] = d[bi][v[bi]]
    return results, groups


def graphed_family(dev, card, name, model, per_batch):
    """One serving family graphed against eager: a new ``Detector`` on the
    phase's model, 3 requests of 8 at 800x1216 (phase 12's images), each
    image's detections and each batch's (dets, valid) bit-equal to eager
    ``model.detect`` on the same batches; the capture-time launches equal to
    eager detect's and to a profiled replay's device kernels; batch ms
    (median of 10 after 2, CUDA events) and the host ms of 10 queued calls,
    both ways; the device's idle share both ways (torch.profiler, 3 calls);
    the capture's seconds and the peak device memory with the graph
    captured."""
    from frcnn_tpu_torch.engine.serve import Detector

    cfg = model.config
    bh, bw = cfg.DEVICE.BUCKETS[0]
    rng = np.random.RandomState(3)
    requests = [synthetic_images(rng, [(bh, bw), (bh * 3 // 4, bw * 3 // 4)] * 4)
                for _ in range(3)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    det = Detector(model, uint8_input=True)
    got, counts = launches_during(lambda: [det(images) for images in requests])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    reserved = torch.cuda.memory_reserved() / 2 ** 30
    check_graphed(f"phase 51 {name}", det, per_batch, 3, counts)
    (key, capture_s), = det.graphs.capture_seconds.items()
    for r, images in enumerate(requests):
        want, groups = eager_detections(model, images, cfg, det.max_per_image, dev)
        for i, (w, g) in enumerate(zip(want, got[r])):
            if not np.array_equal(w, g):
                raise AssertionError(f"phase 51 {name} request {r} image {i}: the graphed "
                                     f"detections differ from eager detect's ({len(g)} rows, "
                                     f"{len(w)} eager)")
        for data, info, dets, valid in groups:
            gd, gv = det.detect_blobs(data, info)
            if not (torch.equal(gd, dets) and torch.equal(gv, valid)):
                raise AssertionError(f"phase 51 {name} request {r}: detect_blobs' (dets, valid) "
                                     f"differ from eager detect's by up to "
                                     f"{(gd - dets).abs().max().item():.6g}")
    data, info = groups[0][:2]

    def eager():
        with torch.inference_mode():
            return model.detect(data, info, det.max_per_image)

    def graphed():
        return det.detect_blobs(data, info)

    _, eager_counts = launches_during(eager)
    on_device = profiled_kernels(graphed)
    if not (eager_counts == det.graphs.launches[key] == per_batch == on_device):
        raise AssertionError(f"phase 51 {name}: eager detect called {eager_counts}, the capture "
                             f"{det.graphs.launches[key]}, a profiled replay ran {on_device}; "
                             f"want {per_batch}")
    out = {"capture_s": capture_s, "peak_gib": peak, "reserved_gib": reserved,
           "launches": per_batch}
    for way, step in (("eager", eager), ("graphed", graphed)):
        out[f"{way}_ms"] = cuda_ms(step, iters=10, warmup=2)
        out[f"{way}_wall10_ms"] = wall_ms(step)
        prof, _ = device_profile(step, n_steps=3)
        out[f"{way}_idle_share"] = prof["idle_share"]
        out[f"{way}_busy_ms"] = prof["device_busy_ms"] / 3
    log(f"phase 51 {name} (batch 8, {bh}x{bw}, bf16): graphed detections bit-equal to eager "
        f"detect over 3 requests of 8; launches a batch {per_batch} at capture, in eager detect "
        f"and in a profiled replay; eager {out['eager_ms']:.3f} ms, graphed "
        f"{out['graphed_ms']:.3f} ms a batch (median of 10, CUDA events); 10 queued calls "
        f"{out['eager_wall10_ms']:.3f} / {out['graphed_wall10_ms']:.3f} ms; device idle "
        f"{out['eager_idle_share']:.4f} / {out['graphed_idle_share']:.4f} (busy "
        f"{out['eager_busy_ms']:.3f} / {out['graphed_busy_ms']:.3f} ms a batch); capture "
        f"{capture_s:.3f} s (warm-up included); peak device memory {peak:.3f} GiB, reserved "
        f"{reserved:.3f} GiB with the graph captured; on {card}")
    return out


class HostRead(torch.nn.Module):
    """A toy ``detect`` that reads a value back (``.item()``): legal op by
    op, refused under CUDA graph capture."""

    def __init__(self, dev):
        super().__init__()
        self.scale = torch.nn.Parameter(torch.ones((), device=dev))
        self.config = None

    def detect(self, data, im_info, max_per_image):
        s = data.float().sum(dim=(1, 2, 3)) * self.scale
        if s[0].item() > 0:
            s = s + 1.0
        return s[:, None, None].expand(-1, 1, 6).contiguous(), (s > 0)[:, None]


def graphed_serving(dev, card, models):
    """Phase 51: ``graphed_family`` for each of ``SERVING_FAMILIES`` on the
    models of their phases (``models`` by name); then two keys in one
    ``Detector`` (phase 12's model, buckets 800x1216 and 1216x800: a request
    of 8 landscape and 3 portrait images captures B 8 then B 3, and a
    request with the portrait images first replays them in the reverse
    order, both groups pending until read back), each request bit-equal to
    eager detect, with the peak memory after the two captures; then a
    capture that fails (``HostRead``) raises, naming its key and line, with
    no replay, and phase 12's model still serves bit-equal to eager."""
    from frcnn_tpu_torch.engine.graphs import DetectGraphs
    from frcnn_tpu_torch.engine.serve import Detector

    t0 = time.perf_counter()
    families = {name: graphed_family(dev, card, name, models[name], per_batch)
                for name, _, _, _, per_batch in SERVING_FAMILIES}

    model = models["res50"]
    cfg = smoke_config(["DEVICE.BUCKETS", "((800, 1216), (1216, 800))"])
    rng = np.random.RandomState(19)
    land = synthetic_images(rng, [(800, 1216), (600, 912)] * 4)
    port = synthetic_images(rng, [(1216, 800), (912, 600), (1216, 800)])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    det = Detector(model, cfg, uint8_input=True)
    first = det(land + port)              # captures B 8 (800x1216), then B 3 (1216x800)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    reserved = torch.cuda.memory_reserved() / 2 ** 30
    second = det(port + land)             # replays B 3, then B 8
    keys = dict(det.graphs.captures)
    if sorted(k[:3] for k in keys) != [(3, 1216, 800), (8, 800, 1216)] or \
            set(keys.values()) != {1} or set(det.graphs.replays.values()) != {2}:
        raise AssertionError(f"phase 51 two keys: captures {keys}, replays "
                             f"{dict(det.graphs.replays)}")
    for label, request, got in (("capture order", land + port, first),
                                ("reverse order", port + land, second)):
        want, _ = eager_detections(model, request, cfg, det.max_per_image, dev)
        for i, (w, g) in enumerate(zip(want, got)):
            if not np.array_equal(w, g):
                raise AssertionError(f"phase 51 two keys, {label}, image {i}: the graphed "
                                     "detections differ from eager detect's")
    two_keys = {"peak_gib": peak, "reserved_gib": reserved,
                "capture_s": sum(det.graphs.capture_seconds.values())}
    log(f"phase 51 two keys in one Detector (res50 C4, buckets 800x1216 and 1216x800, one pool): "
        f"B 8 and B 3 captured in that order, then replayed in the reverse order inside one "
        f"request, both groups pending until read back: every image bit-equal to eager detect; "
        f"peak device memory after the two captures {peak:.3f} GiB, reserved {reserved:.3f} GiB; "
        f"captures {two_keys['capture_s']:.3f} s; on {card}")
    del det

    toy = DetectGraphs(HostRead(dev), 1, dev)
    try:
        toy(torch.ones(2, 4, 6, 3, device=dev), torch.ones(2, 3, device=dev))
    except RuntimeError as e:
        why = str(e)
        if "(2, 4, 6, torch.float32, 1)" not in why or ".item()" not in why:
            raise AssertionError(f"phase 51: a failed capture's error names no key or line: "
                                 f"{why}") from e
    else:
        raise AssertionError("phase 51: a host read under capture did not raise")
    if toy.captures or toy.replays:
        raise AssertionError("phase 51: a failed capture was kept or replayed")
    again = Detector(model, uint8_input=True)
    request = synthetic_images(np.random.RandomState(3), [(800, 1216), (600, 912)] * 4)
    want, _ = eager_detections(model, request, model.config, again.max_per_image, dev)
    if not all(np.array_equal(w, g) for w, g in zip(want, again(request))):
        raise AssertionError("phase 51: after the failed capture a new graph differs from eager")
    seconds = time.perf_counter() - t0
    log(f"phase 51 a capture that fails: a host read (.item()) under capture raised "
        f"RuntimeError naming the key and the line ({why.splitlines()[0][:240]}), nothing kept "
        f"or replayed; a new Detector then captured and served bit-equal to eager")
    log(f"phase 51: {seconds:.1f} s")
    result = {"card": card, "families": families, "two_keys": two_keys, "seconds": seconds}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "graphed_serving.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


def parse_args(argv):
    parser = argparse.ArgumentParser(description="Smoke run of frcnn_tpu_torch on one card.")
    parser.add_argument("--only", choices=("kernels", "coco", "graphs"),
                        help="kernels: stop after the kernel phases; coco: the kernel phases, "
                             "12 and the COCO phases 48-50; graphs: 12, then phase 51 on "
                             "models built for it (a partial run: no ok line)")
    parser.add_argument("--profile", action="store_true",
                        help="time each stage of the C4, FPN and GroupNorm FPN train steps "
                             "and of an FPN detect batch and profile the device (chiprun_out/"
                             "profile_{train,fpn,fpn_train,fpn_gn_train}.json)")
    return parser.parse_args(argv)


KERNELS = (  # name, source, the TPU kernel it replaces
    ("nms", "frcnn_tpu_torch/csrc/nms_kernel.cu", "frcnn_tpu/ops/pallas/nms_kernel.py:318"),
    ("roi_align_ml", "frcnn_tpu_torch/csrc/roi_align_kernel.cu",
     "frcnn_tpu/ops/pallas/roi_align_kernel.py:555"),
    ("roi_align", "frcnn_tpu_torch/csrc/roi_align_kernel.cu",
     "frcnn_tpu/ops/pallas/roi_align_kernel.py:702"),
    ("roi_align_bwd", "frcnn_tpu_torch/csrc/roi_align_kernel.cu",
     "frcnn_tpu/ops/pallas/roi_align_kernel.py:752"),
    ("roi_align_ml_bwd", "frcnn_tpu_torch/csrc/roi_align_kernel.cu",
     "frcnn_tpu/ops/pallas/roi_align_kernel.py:634"),
    ("fused_block", "frcnn_tpu_torch/csrc/fused_block.cu",
     "frcnn_tpu/ops/pallas/fused_block.py:133"),
    ("overlap", "frcnn_tpu_torch/csrc/overlap_kernel.cu",
     "frcnn_tpu/ops/pallas/overlap_kernel.py:153"),
    ("select", "frcnn_tpu_torch/csrc/select_kernel.cu",
     "frcnn_tpu/ops/pallas/select_kernel.py:213"),
    ("bn_epilogue", "frcnn_tpu_torch/csrc/bn_epilogue.cu",
     "none: XLA fuses frozen BN, the residual add and the relu into the convolutions"),
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

    if args.only == "graphs":
        # a partial run: 12, then phase 51 on models built for it; no ok line
        models = {"res50": main_path(dev, card)[2].model}
        for name, net, extra, classes, _ in SERVING_FAMILIES[1:]:
            models[name] = build_seeded(smoke_config(extra), torch.bfloat16, net=net,
                                        classes=classes)
        graphed_serving(dev, card, models)
        print(json.dumps({"replayed_launches_by_path": REPLAYED}))
        print(card)
        return 0

    k1 = check_nms(dev)
    k2 = check_roi_align(dev)
    k3 = check_fused_block(dev)
    results = {
        "nms": merge_results(k1, check_nms_train(dev)),
        "roi_align": k2, "fused_block": k3, "roi_align_bwd": check_roi_align_bwd(dev),
        "roi_align_ml_bwd": check_roi_align_ml_bwd(dev),
        "overlap": check_overlap(dev), "select": check_select(dev),
        "roi_align_ml": check_roi_align_ml(dev), "bn_epilogue": check_bn_epilogue(dev)}
    for res in results.values():
        res.setdefault("library_ms", None)       # no one library call computes it
    k1b = check_nms_single(dev)
    if args.only == "kernels":
        # a partial run: no main path ran, so no launch count and no ok line
        print(json.dumps({"kernel_checks": [{"name": name, **results[name]}
                                            for name, _, _ in KERNELS]}))
        print(card)
        return 0

    serve_counts, serve_ms, serve_detector = main_path(dev, card)[:3]
    models = {"res50": serve_detector.model}      # phase 51's, by SERVING_FAMILIES name
    if args.only == "coco":
        # a partial run: 12, then the COCO phases alone; no ok line
        coco_paths = coco_phases(dev, card, serve_detector, models)
        print(json.dumps({"kernel_checks": [{"name": name, **results[name]}
                                            for name, _, _ in KERNELS],
                          "launches_by_path": coco_paths}))
        print(card)
        return 0
    end_to_end(dev)
    fpn_counts, fpn_detector, fpn_data, fpn_info, fpn_ms = fpn_path(dev, card)
    models["res50_fpn"] = fpn_detector.model
    fpn_end_to_end(dev)
    train_counts, solver, train_ms = train_path(dev, card)
    train_card_vs_cpu(dev)
    fpn_train_counts, fpn_solver, fpn_train_ms = train_path(dev, card, "res50_fpn",
                                                            FPN_TRAIN_LAUNCHES)
    train_card_vs_cpu(dev, "res50_fpn")
    workdir = tempfile.mkdtemp(prefix="chip_smoke_voc_")
    try:
        reader = write_voc_devkit(workdir, devkit_shapes(np.random.RandomState(6)),
                                  np.random.RandomState(7))
        straight = train_net_path(dev, card, train_ms, workdir, reader)
        (c4_test_counts, fpn_test_counts), c4_aps = test_net_path(
            dev, card, workdir, reader, straight["snapshot"], (serve_ms, fpn_ms))
        test_net_card_vs_cpu(dev, workdir, reader)
        cached_counts = cached_train_net_path(dev, card, workdir, reader, straight, train_ms)
        throughput_counts = throughput_path(dev, card, serve_detector, serve_ms)
        host_ops_path(workdir, c4_aps)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    gn_counts, gn_detector = fpn_path(dev, card, "res50_fpn_gn", FPN_GN_LAUNCHES)[:2]
    models["res50_fpn_gn"] = gn_detector.model
    del gn_detector
    fpn_end_to_end(dev, "res50_fpn_gn")
    gn_train_counts, gn_solver, _ = train_path(dev, card, "res50_fpn_gn", FPN_GN_TRAIN_LAUNCHES,
                                               GN_TRAIN_CONFIG)
    train_card_vs_cpu(dev, "res50_fpn_gn")
    # VGG-16 and MobileNet (width 1.0), the other pooling modes, TEST.MODE top
    new_paths = {}
    for net in ("vgg16", "mobile"):
        new_paths[f"{net}_serve"], _, served = main_path(dev, card, net,
                                                        C4_PLAIN_SERVE_LAUNCHES)[:3]
        models[net] = served.model
        del served
        end_to_end(dev, net)
        new_paths[f"{net}_train"] = train_path(dev, card, net, C4_PLAIN_TRAIN_LAUNCHES)[0]
        train_card_vs_cpu(dev, net)
    for pooling in ("pool", "crop"):
        end_to_end(dev, "mobile", ("POOLING_MODE", pooling), {"nms": 2})
        train_card_vs_cpu(dev, "mobile", pooling)
    new_paths["vgg16_top_serve"], _, served = top_path(dev, card)
    models["vgg16_top"] = served.model
    del served
    # 300 rois an image: VGG-16's fc6 over the full 5000 would take the CPU copy ~10 s
    end_to_end(dev, "vgg16", ("TEST.MODE", "top", "TEST.RPN_TOP_N", "300"), TOP_SERVE_LAUNCHES)
    # the data mesh: rank 0's counts of phases 45-47
    new_paths.update(mesh_phases(card, serve_detector, serve_ms,
                                 {"res50": train_ms, "res50_fpn": fpn_train_ms}))
    coco_paths = coco_phases(dev, card, serve_detector, models)
    coco_train_counts = coco_paths.pop("coco_train_net")
    coco_test_counts = coco_paths.pop("coco_test_net")
    new_paths.update(coco_paths)
    graphed_serving(dev, card, models)
    del models
    if args.profile:
        profile_train_step(solver, card)
        profile_fpn_detect(fpn_detector, fpn_data, fpn_info, card)
        profile_train_step(fpn_solver, card, FPN_TRAIN_STAGES, "profile_fpn_train.json")
        profile_train_step(gn_solver, card, FPN_GN_TRAIN_STAGES, "profile_fpn_gn_train.json")

    # the TPU kernels served by a kernel that stands for another one
    also = {"nms": ("frcnn_tpu/ops/pallas/nms_kernel.py:128", k1b),
            "roi_align_ml": ("frcnn_tpu/ops/pallas/roi_align_kernel.py:609", None)}
    # launches: the paths of 12, 14, 16, 18, 23, 25, 27, 29, 31, 33, 36, 43, 45-47
    # (rank 0), 48 and 49, each counted from zero; the driven runs of 20 (A), 21, 42 (C)
    # and 50 beside them by path
    paths = {"c4_serve": serve_counts, "fpn_serve": fpn_counts, "c4_train": train_counts,
             "fpn_train": fpn_train_counts, "fpn_gn_detect": gn_counts,
             "fpn_gn_train": gn_train_counts, **new_paths, "c4_throughput": throughput_counts}
    driven = {"c4_train_net": straight["counts"], "c4_test_net": c4_test_counts,
              "fpn_test_net": fpn_test_counts, "c4_train_net_cached": cached_counts,
              "coco_train_net": coco_train_counts, "coco_test_net": coco_test_counts}
    kernels = []
    for name, src, rep in KERNELS:
        by_path = {path: c.get(name, 0) for path, c in {**paths, **driven}.items()}
        launches = sum(by_path[path] for path in paths)
        if launches == 0:
            raise AssertionError(f"kernel {name} was not launched on a main path")
        missing = [key for key in RESULTS_KEYS if key not in results[name]]
        if missing:
            raise AssertionError(f"kernel {name}: no {missing} in its results")
        replayed = {path: c[name] for path, c in REPLAYED.items() if c.get(name)}
        entry = {"name": name, "route": "cuda", "source": src, "replaces": rep,
                 "launches": launches, "launches_by_path": by_path,
                 "replayed_launches": sum(replayed.values()),
                 "replayed_launches_by_path": replayed, **results[name]}
        if name in also:
            rep2, timing = also[name]
            entry["also_replaces"] = rep2
            if timing:
                entry["single_problem_ms"] = timing["ms"]
                entry["single_problem_mask_ms"] = timing["mask_ms"]
                entry["single_problem_plain_ms"] = timing["plain_ms"]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
