"""Box transforms and pairwise IoU (``frcnn_tpu/ops/boxes.py``).

Inclusive-corner boxes (w = x2 - x1 + 1), (dx, dy, dw, dh) deltas with exp
on the size deltas, the ``BBOX_XFORM_CLIP`` clamp on dw/dh.  Every float
operation keeps the JAX version's order, so results agree to the ulp.
"""

from __future__ import annotations

import math

import torch

BBOX_XFORM_CLIP = math.log(1000.0 / 16.0)


def bbox_transform(ex_rois, gt_rois, eps: float = 1e-14):
    """Encode gt boxes relative to example boxes: (..., 4), (..., 4) →
    (..., 4) deltas (dx, dy, dw, dh), widths clamped below at ``eps``."""
    ex_w = ex_rois[..., 2] - ex_rois[..., 0] + 1.0
    ex_h = ex_rois[..., 3] - ex_rois[..., 1] + 1.0
    ex_cx = ex_rois[..., 0] + 0.5 * ex_w
    ex_cy = ex_rois[..., 1] + 0.5 * ex_h

    gt_w = gt_rois[..., 2] - gt_rois[..., 0] + 1.0
    gt_h = gt_rois[..., 3] - gt_rois[..., 1] + 1.0
    gt_cx = gt_rois[..., 0] + 0.5 * gt_w
    gt_cy = gt_rois[..., 1] + 0.5 * gt_h

    dx = (gt_cx - ex_cx) / torch.clamp(ex_w, min=eps)
    dy = (gt_cy - ex_cy) / torch.clamp(ex_h, min=eps)
    dw = torch.log(torch.clamp(gt_w, min=eps) / torch.clamp(ex_w, min=eps))
    dh = torch.log(torch.clamp(gt_h, min=eps) / torch.clamp(ex_h, min=eps))
    return torch.stack([dx, dy, dw, dh], dim=-1)


def bbox_transform_inv(boxes, deltas, clip: bool = True):
    """Decode deltas (..., 4*K) on top of boxes (..., 4); same shape as deltas."""
    boxes = boxes.to(deltas.dtype)
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h

    d = deltas.reshape(deltas.shape[:-1] + (-1, 4))
    dx, dy, dw, dh = d.unbind(-1)
    if clip:
        dw = torch.clamp(dw, max=BBOX_XFORM_CLIP)
        dh = torch.clamp(dh, max=BBOX_XFORM_CLIP)

    pcx = dx * w[..., None] + cx[..., None]
    pcy = dy * h[..., None] + cy[..., None]
    pw = torch.exp(dw) * w[..., None]
    ph = torch.exp(dh) * h[..., None]
    out = torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph,
                       pcx + 0.5 * pw - 1.0, pcy + 0.5 * ph - 1.0], dim=-1)
    return out.reshape(deltas.shape)


def clip_boxes(boxes, im_shape):
    """Clip boxes (..., 4*K) to [0, W-1] x [0, H-1].  im_shape (..., 2)
    [height, width], broadcast over boxes' leading dims."""
    im_shape = torch.as_tensor(im_shape, dtype=boxes.dtype, device=boxes.device)
    b = boxes.reshape(boxes.shape[:-1] + (-1, 4))
    h, w = im_shape[..., 0], im_shape[..., 1]
    while h.dim() < b.dim() - 1:
        h, w = h[..., None], w[..., None]
    x1 = torch.minimum(torch.clamp(b[..., 0], min=0.0), w - 1.0)
    y1 = torch.minimum(torch.clamp(b[..., 1], min=0.0), h - 1.0)
    x2 = torch.minimum(torch.clamp(b[..., 2], min=0.0), w - 1.0)
    y2 = torch.minimum(torch.clamp(b[..., 3], min=0.0), h - 1.0)
    return torch.stack([x1, y1, x2, y2], dim=-1).reshape(boxes.shape)


def bbox_overlaps(boxes, query_boxes):
    """Pairwise IoU (..., N, 4) x (..., K, 4) -> (..., N, K), inclusive
    corners, ``inter / union`` with a zero where boxes do not intersect."""
    b = boxes[..., :, None, :]
    q = query_boxes[..., None, :, :]
    iw = torch.minimum(b[..., 2], q[..., 2]) - torch.maximum(b[..., 0], q[..., 0]) + 1.0
    ih = torch.minimum(b[..., 3], q[..., 3]) - torch.maximum(b[..., 1], q[..., 1]) + 1.0
    inter = torch.clamp(iw, min=0.0) * torch.clamp(ih, min=0.0)
    area_b = (boxes[..., 2] - boxes[..., 0] + 1.0) * (boxes[..., 3] - boxes[..., 1] + 1.0)
    area_q = (query_boxes[..., 2] - query_boxes[..., 0] + 1.0) * (
        query_boxes[..., 3] - query_boxes[..., 1] + 1.0)
    union = area_b[..., :, None] + area_q[..., None, :] - inter
    return torch.where(inter > 0, inter / union, torch.zeros_like(inter))
