"""Training-target layers (``frcnn_tpu/models/targets.py``): RPN anchor
targets in the compact sampled-rows form, and RoI proposal targets —
batched over images, fixed shapes, no Python loop over images.

The sampling is uniform without replacement by random priorities, as in
the JAX package, but the uniform draws are INPUTS here (``draws``): in
training they come from ``torch.rand`` with an explicit generator on the
device (``uniform_draws``); the tests compute them with ``jax.random`` along
the JAX package's key splits, so the sampled slots are identical.  Every
sort is stable, so ties keep the lowest index first, as ``lax.top_k`` and
``jnp.argsort`` do.

Kernels: the anchor IoU reductions run K4 (``ops/cuda/overlap_kernel.py``)
at every K and the fg/bg subsampling K5 (``ops/cuda/select_kernel.py``)
behind the JAX package's gate, on CUDA tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from frcnn_tpu_torch.ops.boxes import bbox_overlaps, bbox_transform
from frcnn_tpu_torch.ops.cuda.overlap_kernel import (MAX_GT, anchor_overlap_stats,
                                                     anchor_overlap_stats_reference)
from frcnn_tpu_torch.ops.cuda.select_kernel import threshold_route, topk_descending


def _f32(value, device):
    # thresholds as f32 tensors: the comparison then happens at f32 exactly
    return torch.tensor(value, dtype=torch.float32, device=device)


class ShardedDraws(NamedTuple):
    """The draws of rank ``rank`` of ``world`` equal shards of a batch:
    ``uniform_draws`` draws the whole batch's from ``generator`` and keeps
    the rank's rows, so every rank's generator advances as the unsharded
    run's does."""

    generator: torch.Generator
    rank: int
    world: int


def shard_draws(draws: dict, rank: int, world: int) -> dict:
    """Rank ``rank``'s rows of a batch's draws: rows of the (B, ...)
    priorities, and of the dropout uniforms (layers, B * rows an image,
    width), which are image-major, the blocks of its images."""
    b = draws["anchor_fg"].shape[0]
    if b % world:
        raise ValueError(f"batch size {b} is not a multiple of the mesh size {world}")
    n = b // world
    out = {k: v[rank * n:(rank + 1) * n] for k, v in draws.items() if k != "dropout"}
    if "dropout" in draws:
        per_image = draws["dropout"].shape[1] // b
        out["dropout"] = draws["dropout"][:, rank * n * per_image:(rank + 1) * n * per_image]
    return out


def uniform_draws(generator, b: int, k: int, n: int, dropout: tuple | None = None) -> dict:
    """The uniform draws of a train step on the generator's device: anchor
    fg/bg priorities (B, K), RoI fg/bg priorities (B, N) and, for a tail
    with dropout, its uniforms of shape ``dropout`` (layers, rows, width),
    drawn last.  ``generator``: a ``torch.Generator``, or a
    ``ShardedDraws`` for a rank's B images of a sharded batch."""
    if isinstance(generator, ShardedDraws):
        g, rank, world = generator
        if dropout is not None:
            dropout = (dropout[0], dropout[1] * world, dropout[2])
        return shard_draws(uniform_draws(g, b * world, k, n, dropout), rank, world)

    def rand(*size):
        return torch.rand(size, generator=generator, device=generator.device)

    draws = {"anchor_fg": rand(b, k), "anchor_bg": rand(b, k), "roi_fg": rand(b, n),
             "roi_bg": rand(b, n)}
    if dropout is not None:
        draws["dropout"] = rand(*dropout)
    return draws


def _rank_by_random_priority(mask, uniform):
    """Rank of each True entry of ``mask`` (B, n) in a random permutation of
    the True entries (False → n): keeping rank < quota samples the quota
    uniformly without replacement."""
    n = mask.shape[-1]
    pri = torch.where(mask, uniform, -1.0)
    order = torch.argsort(-pri, dim=-1, stable=True)  # True entries first
    arange = torch.arange(n, device=mask.device).expand_as(order)
    rank = torch.empty_like(order).scatter_(-1, order, arange)
    return torch.where(mask, rank, n)


def _subsample_idx(mask, max_quota: int, quota, uniform, use_threshold: bool = False):
    """Indices (B, max_quota) of min(quota, sum(mask)) True entries of
    ``mask`` (B, n), sampled uniformly without replacement, and ``take``
    (B, max_quota) marking the live slots (the rest are filler that
    consumers weight 0).  ``quota`` is an int or a (B,) tensor.

    With ``use_threshold`` and a row long enough for the gate, the top-k set
    comes from K5 and a small stable re-rank of the k winners restores the
    full sort's slot order (lowest position first on a tie)."""
    n = mask.shape[-1]
    ramp = torch.arange(n, dtype=torch.float32, device=mask.device) * 2.0 ** -17
    pri = torch.where(mask, 1.0 + uniform, -1.0 - ramp)
    vals, idx = topk_descending(pri, max_quota, use_threshold)
    quota = torch.as_tensor(quota, device=mask.device).reshape(-1, 1)
    take = (torch.arange(max_quota, device=mask.device) < quota) & (vals > 0.0)
    return idx, take


def _anchor_pre_labels(anchors, gt_boxes, gt_valid, im_info, cfg):
    """Inside-image filtering, IoU stats and threshold/argmax-per-gt labels
    before subsampling: (labels (B, K) in {1, 0, -1}, argmax (B, K))."""
    t = cfg.TRAIN
    inside = ((anchors[:, 0] >= 0) & (anchors[:, 1] >= 0)
              & (anchors[:, 2] < im_info[:, 1:2]) & (anchors[:, 3] < im_info[:, 0:1]))
    # K4 beats the twin on the H100 at every K from 864 anchors up (PERF.md):
    # no gate on K, unlike the TPU's (frcnn_tpu/models/targets.py:130-131)
    use_kernel = cfg.DEVICE.USE_KERNELS and gt_boxes.shape[1] <= MAX_GT
    stats = anchor_overlap_stats if use_kernel else anchor_overlap_stats_reference
    max_overlaps, argmax, is_gt_argmax = stats(anchors, gt_boxes, gt_valid, inside)

    dev = anchors.device
    neg = max_overlaps < _f32(t.RPN_NEGATIVE_OVERLAP, dev)
    pos = is_gt_argmax | (max_overlaps >= _f32(t.RPN_POSITIVE_OVERLAP, dev))
    labels = torch.full(inside.shape, -1, dtype=torch.int32, device=dev)
    first, second = ((inside & neg, 0), (inside & pos, 1))
    if t.RPN_CLOBBER_POSITIVES:
        first, second = second, first
    for cond, value in (first, second):
        labels = torch.where(cond, value, labels)
    return labels, argmax.long()


class CompactAnchorTargets(NamedTuple):
    """Anchor targets restricted to the S = fg quota + RPN_BATCHSIZE sampled
    slots (fg slots first); dead slots carry label -1 and zero weights."""

    sel: torch.Tensor                   # (B, S) anchor ids (filler on dead slots)
    labels: torch.Tensor                # (B, S) int32: 1 fg, 0 bg, -1 dead slot
    bbox_targets: torch.Tensor          # (B, S, 4)
    bbox_inside_weights: torch.Tensor   # (B, S, 4)
    bbox_outside_weights: torch.Tensor  # (B, S, 1), broadcast over the 4 deltas


def anchor_target_compact(anchors, gt_boxes, gt_valid, im_info, u_fg, u_bg,
                          cfg) -> CompactAnchorTargets:
    """RPN training targets in sampled-rows form.  anchors (K, 4); gt_boxes
    (B, G, 4) padded; gt_valid (B, G); im_info (B, 3); u_fg, u_bg (B, K)
    uniform draws for the fg and bg subsampling."""
    t = cfg.TRAIN
    dev = anchors.device
    labels0, argmax = _anchor_pre_labels(anchors, gt_boxes, gt_valid, im_info, cfg)
    num_fg = int(t.RPN_FG_FRACTION * t.RPN_BATCHSIZE)
    fg_mask, bg_mask = labels0 == 1, labels0 == 0
    use_th = threshold_route(cfg, cfg.DEVICE.USE_KERNELS, anchors)
    fg_idx, fg_take = _subsample_idx(fg_mask, num_fg, num_fg, u_fg, use_th)
    n_fg = torch.clamp(fg_mask.sum(-1), max=num_fg)
    bg_idx, bg_take = _subsample_idx(bg_mask, t.RPN_BATCHSIZE, t.RPN_BATCHSIZE - n_fg, u_bg,
                                     use_th)

    sel = torch.cat([fg_idx, bg_idx], dim=-1)                        # (B, S)
    valid = torch.cat([fg_take, bg_take], dim=-1)
    is_fg_slot = torch.arange(sel.shape[1], device=dev) < num_fg
    labels = torch.where(valid, is_fg_slot.to(torch.int32), -1).to(torch.int32)

    matched_gt = torch.take_along_dim(gt_boxes, torch.take_along_dim(argmax, sel, dim=1)[..., None],
                                      dim=1)
    fg_rows = (labels == 1)[..., None]
    targets = torch.where(fg_rows, bbox_transform(anchors[sel], matched_gt), 0.0)
    inside_w = torch.where(fg_rows, torch.tensor(t.BBOX_INSIDE_WEIGHTS, device=dev), 0.0)
    if t.RPN_POSITIVE_WEIGHT < 0:
        num_examples = torch.clamp(valid.sum(-1), min=1).float()[:, None, None]
        outside_w = torch.where((labels >= 0)[..., None], torch.ones_like(num_examples) / num_examples,
                                0.0)
    else:
        pw = _f32(t.RPN_POSITIVE_WEIGHT, dev) / torch.clamp((labels == 1).sum(-1), min=1)
        nw = _f32(1.0 - t.RPN_POSITIVE_WEIGHT, dev) / torch.clamp((labels == 0).sum(-1), min=1)
        outside_w = torch.where((labels == 1)[..., None], pw[:, None, None], 0.0)
        outside_w = torch.where((labels == 0)[..., None], nw[:, None, None], outside_w)
    outside_w = outside_w.to(targets.dtype)
    return CompactAnchorTargets(sel, labels, targets, inside_w, outside_w)


class ProposalTargets(NamedTuple):
    rois: torch.Tensor                  # (B, BATCH_SIZE, 4) sampled rois (fg first)
    labels: torch.Tensor                # (B, BATCH_SIZE) int32 class labels (0 = bg)
    bbox_targets: torch.Tensor          # (B, BATCH_SIZE, 4 * num_classes)
    bbox_inside_weights: torch.Tensor   # (B, BATCH_SIZE, 4 * num_classes)
    bbox_outside_weights: torch.Tensor  # (B, BATCH_SIZE, 4 * num_classes)


def proposal_target_layer(rois, roi_valid, gt_boxes, gt_labels, gt_valid, u_fg, u_bg,
                          cfg, num_classes: int) -> ProposalTargets:
    """RoI-head training targets.  rois (B, R, 4), roi_valid (B, R), gt
    (B, G, ...); u_fg, u_bg (B, R + G) uniform draws.  If an image has
    neither fg nor bg rois, every valid roi counts as bg (the JAX package's
    fixed-shape replacement of the reference's assertion); when fewer than
    BATCH_SIZE rois are selected, the slots repeat them cyclically."""
    t = cfg.TRAIN
    batch = t.BATCH_SIZE
    dev = rois.device
    all_rois = torch.cat([rois, gt_boxes], dim=1)
    all_valid = torch.cat([roi_valid, gt_valid], dim=1)
    n = all_rois.shape[1]

    overlaps = bbox_overlaps(all_rois, gt_boxes)                      # (B, n, G)
    overlaps = torch.where(gt_valid[:, None, :], overlaps, -1.0)
    overlaps = torch.where(all_valid[:, :, None], overlaps, -1.0)
    max_ov, argmax = overlaps.max(dim=2)
    roi_label = torch.take_along_dim(gt_labels, argmax, dim=1).to(torch.int32)

    fg = all_valid & (max_ov >= _f32(t.FG_THRESH, dev))
    bg = all_valid & (max_ov < _f32(t.BG_THRESH_HI, dev)) & (max_ov >= _f32(t.BG_THRESH_LO, dev))
    none_found = ~(fg | bg).any(dim=1, keepdim=True)
    bg = bg | (none_found & all_valid)

    fg_quota = int(round(t.FG_FRACTION * batch))
    fg_rank = _rank_by_random_priority(fg, u_fg)
    fg_sel = fg & (fg_rank < fg_quota)
    n_fg = fg_sel.sum(dim=1, keepdim=True)
    bg_rank = _rank_by_random_priority(bg, u_bg)
    bg_sel = bg & (bg_rank < batch - n_fg)

    # fg first, then bg, each in random order; unselected entries last
    arange = torch.arange(n, device=dev)
    sort_key = torch.where(fg_sel, fg_rank, n + bg_rank)
    sort_key = torch.where(fg_sel | bg_sel, sort_key, 2 * n + arange)
    order = torch.argsort(sort_key, dim=1, stable=True)
    n_sel = torch.clamp(n_fg + bg_sel.sum(dim=1, keepdim=True), min=1)
    slots = torch.arange(batch, device=dev)[None, :] % n_sel
    sel = torch.take_along_dim(order, slots, dim=1)                   # (B, batch)

    out_rois = torch.take_along_dim(all_rois, sel[..., None], dim=1)
    is_fg = torch.take_along_dim(fg_sel, sel, dim=1)
    labels = torch.where(is_fg, torch.take_along_dim(roi_label, sel, dim=1), 0).to(torch.int32)

    matched = torch.take_along_dim(gt_boxes, torch.take_along_dim(argmax, sel, dim=1)[..., None],
                                   dim=1)
    targets = bbox_transform(out_rois, matched)
    if t.BBOX_NORMALIZE_TARGETS_PRECOMPUTED:
        means = torch.tensor(t.BBOX_NORMALIZE_MEANS, dtype=targets.dtype, device=dev)
        stds = torch.tensor(t.BBOX_NORMALIZE_STDS, dtype=targets.dtype, device=dev)
        targets = (targets - means) / stds
    targets = torch.where(is_fg[..., None], targets, 0.0)

    b = rois.shape[0]
    onehot = F.one_hot(labels.long(), num_classes).to(targets.dtype)   # (B, batch, C)
    expanded = (onehot[..., None] * targets[:, :, None, :]).reshape(b, batch, 4 * num_classes)
    inside = torch.tensor(t.BBOX_INSIDE_WEIGHTS, dtype=targets.dtype, device=dev)
    in_w = (onehot[..., None] * (is_fg[..., None, None] * inside)).reshape(b, batch,
                                                                           4 * num_classes)
    out_w = (in_w > 0).to(targets.dtype)
    return ProposalTargets(out_rois, labels, expanded, in_w, out_w)
