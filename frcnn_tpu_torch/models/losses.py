"""Detection losses (``frcnn_tpu/models/losses.py``): RPN cross-entropy and
smooth-L1 (sigma 3) over the sampled anchor rows, RoI cross-entropy and
smooth-L1 (sigma 1) over the sampled rois.

Every function takes a leading batch dimension and returns one value per
image (the JAX functions are single-image and vmapped); the caller takes
the batch mean.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _huber(diff, sigma2: float):
    abs_diff = diff.abs()
    return torch.where(abs_diff < 1.0 / sigma2, 0.5 * sigma2 * diff * diff,
                       abs_diff - 0.5 / sigma2)


def smooth_l1_loss(pred, targets, inside_w, outside_w, sigma: float = 1.0):
    """Per image: sum of outside_w * huber(inside_w * (pred - targets)),
    transition at 1/sigma^2; (B, ...) → (B,)."""
    per_elem = _huber(inside_w * (pred - targets), sigma * sigma)
    return (outside_w * per_elem).flatten(1).sum(dim=1)


def softmax_ce(logits, labels, weight=None):
    """Per image: mean cross-entropy over rows (B, N, C) / (B, N), or the
    weighted mean when ``weight`` (B, N) is given (ignored rows weight 0)."""
    ce = F.cross_entropy(logits.transpose(1, 2), labels.long().clamp(min=0), reduction="none")
    if weight is None:
        return ce.mean(dim=1)
    w = weight.to(ce.dtype)
    return (ce * w).sum(dim=1) / torch.clamp(w.sum(dim=1), min=1.0)


def _roi_losses(cls_logits, bbox_pred, pt):
    """RoI-head pair: (cross_entropy (B,), loss_box (B,)); the box loss sums
    over the 4C columns and averages over rois."""
    cross_entropy = softmax_ce(cls_logits, pt.labels)
    per = _huber(pt.bbox_inside_weights * (bbox_pred - pt.bbox_targets), 1.0)
    loss_box = (pt.bbox_outside_weights * per).sum(dim=-1).mean(dim=1)
    return cross_entropy, loss_box


def detection_losses_compact(rpn_cls_rows, rpn_box_rows, compact_targets,
                             cls_logits, bbox_pred, proposal_targets):
    """The four losses with the RPN terms over the sampled rows only.
    rpn_cls_rows (B, S, 2) [bg, fg] and rpn_box_rows (B, S, 4): the head
    outputs at ``compact_targets.sel``; cls_logits (B, N, C), bbox_pred
    (B, N, 4C).  Returns a dict of (B,) tensors, ``total_loss`` included."""
    cat = compact_targets
    rpn_select = (cat.labels >= 0).float()
    rpn_cross_entropy = softmax_ce(rpn_cls_rows, cat.labels, rpn_select)
    rpn_loss_box = smooth_l1_loss(rpn_box_rows, cat.bbox_targets, cat.bbox_inside_weights,
                                  cat.bbox_outside_weights, sigma=3.0)
    cross_entropy, loss_box = _roi_losses(cls_logits, bbox_pred, proposal_targets)
    return {"rpn_cross_entropy": rpn_cross_entropy, "rpn_loss_box": rpn_loss_box,
            "cross_entropy": cross_entropy, "loss_box": loss_box,
            "total_loss": rpn_cross_entropy + rpn_loss_box + cross_entropy + loss_box}
