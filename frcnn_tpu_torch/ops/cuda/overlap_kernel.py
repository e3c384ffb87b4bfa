"""K4: anchor-overlap statistics of the anchor-target layer — CUDA kernel
wrapper and its plain twin.

Replaces the TPU kernel ``frcnn_tpu/ops/pallas/overlap_kernel.py``
(``anchor_overlap_stats`` / ``_overlap_kernel``), batched over images.  The
kernel (``frcnn_tpu_torch/csrc/overlap_kernel.cu``) runs one thread per
anchor with the image's gt boxes in shared memory: a first pass writes each
anchor's max/argmax and reduces the per-gt maxima with warp reductions and
atomics on order-preserving keys; a second pass recomputes each IoU with
the same intrinsics and marks the anchors that attain a gt's maximum.
Bound on the H100: launch latency; the (B, K, G) IoU matrix the twin
builds never reaches memory.

``anchor_overlap_stats_reference`` is the plain twin: the dense form of
``frcnn_tpu/models/targets.py::_anchor_pre_labels``.  Both compute IoU in
``ops/boxes.py::bbox_overlaps``'s operation order, so all three outputs are
bit-equal.
"""

from __future__ import annotations

import torch

from frcnn_tpu_torch.ops.boxes import bbox_overlaps
from frcnn_tpu_torch.ops.cuda import build

MAX_GT = 64  # gt boxes per image the kernel holds in shared memory


def anchor_overlap_stats_reference(anchors, gt_boxes, gt_valid, inside):
    """anchors (K, 4), gt_boxes (B, G, 4), gt_valid (B, G), inside (B, K) →
    (max_overlaps (B, K) f32, argmax (B, K) int32 — the lowest gt index on
    a tie, is_gt_argmax (B, K) bool).  Invalid gt and outside anchors count
    as IoU -1."""
    overlaps = bbox_overlaps(anchors.float(), gt_boxes.float())          # (B, K, G)
    overlaps = torch.where(gt_valid[:, None, :], overlaps, -1.0)
    overlaps = torch.where(inside[:, :, None], overlaps, -1.0)
    max_overlaps, argmax = overlaps.max(dim=2)
    gt_max = overlaps.max(dim=1, keepdim=True).values                   # (B, 1, G)
    is_gt_argmax = ((overlaps == gt_max) & (gt_max > 0) & gt_valid[:, None, :]).any(dim=2)
    return max_overlaps, argmax.to(torch.int32), is_gt_argmax


def anchor_overlap_stats(anchors, gt_boxes, gt_valid, inside):
    """The anchor-target IoU reductions without the (B, K, G) matrix.
    Arguments and results as ``anchor_overlap_stats_reference``; G <= 64 on
    CUDA.  CPU tensors run the plain twin; CUDA tensors launch the kernel
    (one launch for the batch)."""
    if not anchors.is_cuda:
        return anchor_overlap_stats_reference(anchors, gt_boxes, gt_valid, inside)
    b, g = gt_boxes.shape[:2]
    k = anchors.shape[0]
    if not 1 <= g <= MAX_GT:
        raise ValueError(f"anchor_overlap_stats: G={g} outside [1, {MAX_GT}]")
    anchors = anchors.float().contiguous()
    gt_boxes = gt_boxes.float().contiguous()
    gt_valid = gt_valid.to(torch.bool).contiguous()
    inside = inside.to(torch.bool).contiguous()
    build.check_cuda("overlap anchors", anchors, torch.float32, (k, 4))
    build.check_cuda("overlap gt_boxes", gt_boxes, torch.float32, (b, g, 4))
    build.check_cuda("overlap gt_valid", gt_valid, torch.bool, (b, g))
    build.check_cuda("overlap inside", inside, torch.bool, (b, k))
    dev = anchors.device
    gt_max_keys = torch.empty((b, g), dtype=torch.int32, device=dev)
    max_overlaps = torch.empty((b, k), dtype=torch.float32, device=dev)
    argmax = torch.empty((b, k), dtype=torch.int32, device=dev)
    is_gt_argmax = torch.empty((b, k), dtype=torch.bool, device=dev)
    build.launch("frcnn_anchor_overlap_stats", anchors.data_ptr(), k, gt_boxes.data_ptr(),
                 gt_valid.data_ptr(), b, g, inside.data_ptr(), gt_max_keys.data_ptr(),
                 max_overlaps.data_ptr(), argmax.data_ptr(), is_gt_argmax.data_ptr())
    build.LAUNCH_COUNTS["overlap"] += 1
    return max_overlaps, argmax, is_gt_argmax
