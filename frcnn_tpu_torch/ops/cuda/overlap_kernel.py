"""K4: anchor-overlap statistics of the anchor-target layer — CUDA kernel
wrapper and its plain twin.

Replaces the TPU kernel ``frcnn_tpu/ops/pallas/overlap_kernel.py``
(``anchor_overlap_stats`` / ``_overlap_kernel``), batched over images.  The
kernel (``frcnn_tpu_torch/csrc/overlap_kernel.cu``) is one launch with a
thread-block cluster per image: each block compacts the image's valid gt
boxes into shared memory and takes a contiguous segment of the anchors, 32
a warp at a time; a warp culls, exactly, the gts that cannot reach its
inside anchors (the IoU's own arithmetic against the anchors' bounding
box) and computes the IoU of the survivors only; the per-gt maxima are
combined over the cluster through distributed shared memory, and a tie pass
revisits only the chunks and gts that can attain a gt's maximum.  No
scratch, no memset, no global atomics.  Bound on the H100: bytes by the
count (the anchors and inside mask read once, the three outputs written
once); in fact a floor of the launch, two cluster barriers and each warp's
chunks in turn, then the survivors' IoUs of the busiest warp (C4) or of the
image with the most gts (FPN).  ``overlap_plan`` is the launch geometry.

``anchor_overlap_stats_reference`` is the plain twin: the dense form of
``frcnn_tpu/models/targets.py::_anchor_pre_labels``.  Both compute IoU in
``ops/boxes.py::bbox_overlaps``'s operation order, so all three outputs are
bit-equal.
"""

from __future__ import annotations

import torch

from frcnn_tpu_torch.ops.boxes import bbox_overlaps
from frcnn_tpu_torch.ops.cuda import build
from frcnn_tpu_torch.ops.cuda.card import MAX_CLUSTER, SMS

MAX_GT = 64            # gt boxes per image the kernel holds in shared memory
THREADS = 1024         # threads a block: 32 warps
MAX_MASK_BYTES = 224 * 1024   # the chunk masks' dynamic shared memory (+ ~2 KB static)


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


def overlap_plan(b: int, k: int, cluster: int | None = None, threads: int = THREADS) -> dict:
    """Launch geometry for B images of K anchors: a cluster of ``cluster``
    blocks an image (by default the largest power of two up to 16 that
    keeps B clusters within the card's SMs), block j owning the anchors
    ``[j * segment, (j + 1) * segment)`` (a multiple of 32, so that every
    chunk of 32 is one warp's), and 8 bytes of shared memory for each chunk
    of a segment (its survivor mask)."""
    if cluster is None:
        cluster = 1
        while cluster < MAX_CLUSTER and b * cluster * 2 <= SMS:
            cluster *= 2
    segment = -(-(-(-k // cluster)) // 32) * 32
    plan = {"cluster": cluster, "threads": threads, "segment": segment,
            "smem_bytes": segment // 32 * 8}
    if plan["smem_bytes"] > MAX_MASK_BYTES:
        raise ValueError(f"overlap_plan: {k} anchors over {cluster} blocks need "
                         f"{plan['smem_bytes']} bytes of chunk masks (> {MAX_MASK_BYTES})")
    return plan


def anchor_overlap_stats(anchors, gt_boxes, gt_valid, inside, plan=None):
    """The anchor-target IoU reductions without the (B, K, G) matrix.
    Arguments and results as ``anchor_overlap_stats_reference``; G <= 64 on
    CUDA.  CPU tensors run the plain twin; CUDA tensors launch the kernel
    (one launch for the batch, under ``plan`` or ``overlap_plan``'s)."""
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
    plan = plan or overlap_plan(b, k)
    dev = anchors.device
    max_overlaps = torch.empty((b, k), dtype=torch.float32, device=dev)
    argmax = torch.empty((b, k), dtype=torch.int32, device=dev)
    is_gt_argmax = torch.empty((b, k), dtype=torch.bool, device=dev)
    build.launch("frcnn_anchor_overlap_stats", anchors.data_ptr(), k, gt_boxes.data_ptr(),
                 gt_valid.data_ptr(), b, g, inside.data_ptr(), plan["cluster"], plan["threads"],
                 plan["segment"], plan["smem_bytes"], max_overlaps.data_ptr(),
                 argmax.data_ptr(), is_gt_argmax.data_ptr())
    build.LAUNCH_COUNTS["overlap"] += 1
    return max_overlaps, argmax, is_gt_argmax
