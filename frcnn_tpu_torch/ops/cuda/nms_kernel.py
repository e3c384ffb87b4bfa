"""K1: batched exact greedy NMS — CUDA kernel wrapper and its plain twin.

Replaces the TPU kernel ``frcnn_tpu/ops/pallas/nms_kernel.py``
(``nms_mask_pallas_batched`` / ``_nms_kernel_b``).  The kernel is
``frcnn_tpu_torch/csrc/nms_kernel.cu``: a (B, N, N/64) bitmask of
IoU > thresh pairs built 64x64 tiles at a time, then one warp per problem
walks the rows in score order.  Bound on the H100: the walk is serial and
latency-bound (one dependent mask-row load per kept box); the ``max_keep``
cap ends it after the boxes the caller keeps.  The mask pass is cheap.

``nms_mask_reference`` is the plain PyTorch twin: the blocked greedy
algorithm of ``frcnn_tpu/ops/nms.py::nms_mask``, batched.  Both use the
division form of ``bbox_overlaps`` in the same operation order, so keep
masks are bit-equal.
"""

from __future__ import annotations

import torch

from frcnn_tpu_torch.ops.boxes import bbox_overlaps
from frcnn_tpu_torch.ops.cuda import build


_TILE = 128  # boxes resolved sequentially per step of the twin


def nms_mask_reference(boxes, thresh, valid=None):
    """Exact greedy NMS keep mask.  boxes (B, N, 4) sorted by descending
    score, valid (B, N) → keep (B, N) bool.  Invalid boxes are never kept and
    never suppress.  Sequential only inside 128-box tiles: a tile resolves
    its own greedy order, then its kept boxes suppress every later box."""
    b, n = boxes.shape[:2]
    if valid is None:
        valid = torch.ones((b, n), dtype=torch.bool, device=boxes.device)
    thr = torch.tensor(thresh, dtype=torch.float32, device=boxes.device)
    boxes = boxes.float()
    suppressed = ~valid
    t_idx = torch.arange(_TILE, device=boxes.device)
    later = t_idx[None, :] > t_idx[:, None]
    for start in range(0, n, _TILE):
        stop = min(start + _TILE, n)
        tb = boxes[:, start:stop]
        t = stop - start
        iou_tt = (bbox_overlaps(tb, tb) > thr) & later[:t, :t]
        sup_t = suppressed[:, start:stop].clone()
        for i in range(t):
            sup_t |= (~sup_t[:, i])[:, None] & iou_tt[:, i]
        suppressed[:, start:stop] = sup_t
        if stop < n:
            hit = (bbox_overlaps(tb, boxes[:, stop:]) > thr) & (~sup_t)[:, :, None]
            suppressed[:, stop:] |= hit.any(dim=1)
    return ~suppressed & valid


def nms_mask_batched(boxes, thresh, valid=None, max_keep: int | None = None):
    """Keep mask of B greedy NMS problems: boxes (B, N, 4) score-sorted,
    valid (B, N) → keep (B, N) bool.  With ``max_keep`` the first max_keep
    kept boxes of each problem are exact and later keep bits may be zero.

    CPU tensors run the plain twin; CUDA tensors launch the kernel."""
    b, n = boxes.shape[:2]
    if valid is None:
        valid = torch.ones((b, n), dtype=torch.bool, device=boxes.device)
    if not boxes.is_cuda:
        return nms_mask_reference(boxes, thresh, valid)
    boxes = boxes.float().contiguous()
    valid = valid.to(torch.bool).contiguous()
    build.check_cuda("nms boxes", boxes, torch.float32, (b, n, 4))
    build.check_cuda("nms valid", valid, torch.bool, (b, n))
    col_blocks = (n + 63) // 64
    mask = torch.empty((b, n, col_blocks), dtype=torch.int64, device=boxes.device)
    keep = torch.empty((b, n), dtype=torch.bool, device=boxes.device)
    cap = n if max_keep is None else int(max_keep)
    build.launch("frcnn_nms_batched", boxes.data_ptr(), valid.data_ptr(), b, n,
                 float(thresh), cap, mask.data_ptr(), keep.data_ptr())
    build.LAUNCH_COUNTS["nms"] += 1
    return keep
