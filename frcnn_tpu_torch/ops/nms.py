"""Non-maximum suppression with fixed output shapes (``frcnn_tpu/ops/nms.py``).

Greedy semantics of the lineage: boxes in descending score order; box j is
suppressed iff an earlier *kept* box i has IoU(i, j) > thresh.  The keep
mask comes from K1 (``ops/cuda/nms_kernel.py``) on CUDA tensors and from
its plain twin ``nms_mask`` on CPU tensors.  One problem (``nms_fixed``) is
K1 at B = 1: the TPU package's single-problem kernel (``nms_mask_pallas``)
computes the same keep mask.  Sorts are stable, so ties keep the lowest
index first, as ``jnp.argsort`` and ``lax.top_k`` do.
"""

from __future__ import annotations

import torch

from frcnn_tpu_torch.ops.cuda.nms_kernel import nms_mask_batched
from frcnn_tpu_torch.ops.cuda.nms_kernel import nms_mask_reference as nms_mask  # noqa: F401

NEG_INF = -1e10


def nms_fixed_batched(boxes, scores, thresh, max_out: int, valid=None,
                      presorted: bool = False):
    """Batched sort + greedy NMS + pad: boxes (B, N, 4), scores (B, N),
    valid (B, N) → (indices (B, max_out) int32, keep_valid (B, max_out)).

    ``presorted=True``: boxes are already in descending score order with
    every invalid entry after every valid one; padding indices are then 0,
    otherwise they point at each row's best box."""
    b, n = scores.shape
    if valid is None:
        valid = torch.ones((b, n), dtype=torch.bool, device=scores.device)
    if presorted:
        sboxes, svalid, order = boxes, valid, None
    else:
        s = torch.where(valid, scores, NEG_INF)
        order = torch.argsort(-s, dim=1, stable=True)
        sboxes = torch.take_along_dim(boxes, order[..., None], dim=1)
        svalid = torch.take_along_dim(valid, order, dim=1)

    # rows past the first max_out kept are dropped below, so the kernel may
    # stop once every problem has max_out kept
    keep = nms_mask_batched(sboxes, thresh, svalid, max_keep=max_out)

    arange = torch.arange(n, device=scores.device)
    rank = torch.where(keep, arange[None, :], n)
    take = torch.argsort(rank, dim=1, stable=True)[:, :max_out]
    out_valid = torch.take_along_dim(keep, take, dim=1)
    if presorted:
        gathered, fallback = take, torch.zeros_like(take[:, :1])
    else:
        gathered, fallback = torch.take_along_dim(order, take, dim=1), order[:, :1]
    out_idx = torch.where(out_valid, gathered, fallback).to(torch.int32)
    return out_idx, out_valid


def nms_fixed(boxes, scores, thresh, max_out: int, valid=None):
    """One problem: boxes (N, 4), scores (N,), valid (N,) → (indices
    (max_out,) int32, keep_valid (max_out,)); padding indices point at the
    best box."""
    idx, keep = nms_fixed_batched(boxes[None], scores[None], thresh, max_out,
                                  valid=None if valid is None else valid[None])
    return idx[0], keep[0]


def batched_class_nms(boxes, scores, thresh, max_out: int, valid=None):
    """Per-class test-time NMS: boxes (P, N, 4), scores (P, N), valid (P, N)
    for P = images x classes problems → (indices (P, max_out), keep)."""
    return nms_fixed_batched(boxes, scores, thresh, max_out, valid=valid)
