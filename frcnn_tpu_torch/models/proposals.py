"""Proposal generation (``frcnn_tpu/models/proposals.py``): decode RPN
deltas, clip, drop anchors centred on padding, take the top pre-NMS boxes
by score, greedy NMS, pad to a fixed count with a validity mask; or, under
TEST.MODE "top", the top RPN_TOP_N anchors with no NMS
(``proposal_top_layer``)."""

from __future__ import annotations

import torch

from frcnn_tpu_torch.ops.boxes import bbox_transform_inv, clip_boxes
from frcnn_tpu_torch.ops.cuda.select_kernel import topk_descending
from frcnn_tpu_torch.ops.nms import NEG_INF, nms_fixed_batched


def _anchor_validity(anchors, im_info):
    """anchors (K, 4) shared by the batch or (B, K, 4) per image, im_info
    (B, 3) → (B, K): anchor centre inside the actual (unpadded) image."""
    cx = (anchors[..., 0] + anchors[..., 2]) * 0.5
    cy = (anchors[..., 1] + anchors[..., 3]) * 0.5
    return ((cx >= 0) & (cx < im_info[:, 1:2]) & (cy >= 0) & (cy < im_info[:, 0:1]))


def proposal_layer_batch(scores, deltas, anchors, im_info, *, pre_nms_top_n: int,
                         post_nms_top_n: int, nms_thresh: float,
                         use_kernels: bool = True, use_threshold: bool = False):
    """scores (B, K) foreground probabilities, deltas (B, K, 4), anchors
    (K, 4), im_info (B, 3) [h, w, scale] → (rois (B, P, 4), scores (B, P),
    valid (B, P)), P = post_nms_top_n; padding rois are zero boxes.

    With ``use_threshold``, a row that passes the K5 gate takes its pre-NMS
    set from K5 and re-ranks only the pre_n winners (``topk_descending``):
    the full stable sort's first pre_n, bit for bit, ties and the NEG_INF
    tail of anchors centred on padding included."""
    k = scores.shape[1]
    proposals = clip_boxes(bbox_transform_inv(anchors, deltas), im_info[:, :2])
    scores = torch.where(_anchor_validity(anchors, im_info), scores, NEG_INF)
    top_scores, top_idx = topk_descending(scores, min(pre_nms_top_n, k), use_threshold)
    top_boxes = torch.take_along_dim(proposals, top_idx[..., None], dim=1)
    top_valid = top_scores > NEG_INF / 2

    # sorted with invalid entries last: the NMS needs no second sort
    keep_idx, keep_valid = nms_fixed_batched(
        top_boxes, top_scores, nms_thresh, post_nms_top_n, valid=top_valid,
        use_kernels=use_kernels, presorted=True)
    keep_idx = keep_idx.long()
    rois = torch.take_along_dim(top_boxes, keep_idx[..., None], dim=1)
    roi_scores = torch.where(keep_valid, torch.take_along_dim(top_scores, keep_idx, dim=1),
                             0.0)
    rois = torch.where(keep_valid[..., None], rois, 0.0)
    return rois, roi_scores, keep_valid


def proposal_layer(scores, deltas, anchors, im_info, *, pre_nms_top_n: int,
                   post_nms_top_n: int, nms_thresh: float, use_kernels: bool = True):
    """One image (``frcnn_tpu/models/proposals.py::proposal_layer``): scores
    (K,), deltas (K, 4), anchors (K, 4), im_info (3,) → (rois (P, 4),
    scores (P,), valid (P,)).  The batched layer at B = 1: its NMS is K1 at
    B = 1, where the TPU package ran its single-problem kernel."""
    rois, roi_scores, valid = proposal_layer_batch(
        scores[None], deltas[None], anchors, im_info[None], pre_nms_top_n=pre_nms_top_n,
        post_nms_top_n=post_nms_top_n, nms_thresh=nms_thresh, use_kernels=use_kernels)
    return rois[0], roi_scores[0], valid[0]


def proposal_top_layer(scores, deltas, anchors, im_info, *, rpn_top_n: int):
    """The NMS-free TEST variant (TEST.MODE "top"), batched: scores (B, K),
    deltas (B, K, 4), anchors (K, 4), im_info (B, 3) → the top
    min(rpn_top_n, K) valid anchors by score (ties lowest index first, as
    ``lax.top_k``), decoded and clipped: (rois (B, n, 4), scores (B, n),
    valid (B, n)).  Where fewer anchors are valid than n, the rest are zero
    boxes with valid False (the lineage pads at random)."""
    scores = torch.where(_anchor_validity(anchors, im_info), scores, NEG_INF)
    top_scores, top_idx = topk_descending(scores, min(rpn_top_n, scores.shape[1]))
    valid = top_scores > NEG_INF / 2
    boxes = bbox_transform_inv(anchors[top_idx], torch.take_along_dim(deltas, top_idx[..., None],
                                                                        dim=1))
    boxes = clip_boxes(boxes, im_info[:, :2])
    boxes = torch.where(valid[..., None], boxes, 0.0)
    return boxes, torch.where(valid, top_scores, 0.0), valid
