"""Detector assembly (``frcnn_tpu/models/network.py``): the two-stage
Faster R-CNN with fixed output shapes.

  * ``predict``: preprocess → backbone trunk → RPN → proposal layer
    (K1, and K5 for the pre-NMS top-k on the card where its row-length
    gate lets it; under TEST.MODE "top" the top RPN_TOP_N anchors, no
    NMS) → RoI pool (POOLING_MODE "align": K2; "pool", "crop": plain
    PyTorch, as the JAX package) → tail + heads; raw outputs.
  * ``detect``: predict + delta decode, clip, rescale to original image
    coordinates, per-class threshold + NMS (K1), global top-k → (B, D, 6).
  * ``train_forward``: the trunk and RPN, the train proposal layer (K1,
    K5 as in ``predict``), anchor targets (K4, K5) and proposal targets,
    RoIAlign (K2 forward, K2b backward), the tail (VGG-16: dropout on drawn
    uniforms) and heads, and the four losses.

Backbones: ``vgg16``, ``res{50,101,152}``, ``mobile`` (``build_backbone``).

Dtypes follow the JAX module: trunk, RPN convs and tail in the compute
dtype, RPN outputs cast to f32; ``cls_score``/``bbox_pred`` run in f32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from frcnn_tpu_torch.config import Config
from frcnn_tpu_torch.models.backbones import build_backbone, cast_conv, preprocess_images
from frcnn_tpu_torch.models.losses import detection_losses_compact
from frcnn_tpu_torch.models.proposals import proposal_layer_batch, proposal_top_layer
from frcnn_tpu_torch.ops.constants import device_constant
from frcnn_tpu_torch.models.targets import (anchor_target_compact, proposal_target_layer,
                                            uniform_draws)
from frcnn_tpu_torch.ops.anchors import generate_anchors_pre
from frcnn_tpu_torch.ops.boxes import bbox_transform_inv, clip_boxes
from frcnn_tpu_torch.ops.cuda import select_kernel
from frcnn_tpu_torch.ops.nms import batched_class_nms
from frcnn_tpu_torch.ops.roi_align import extract_roi_features


def decode_boxes(out, im_info, cfg, num_classes: int):
    """Un-normalize deltas by BBOX_NORMALIZE_STDS/MEANS, decode per class,
    clip, rescale to original image coords.  Returns (B, N, 4C)."""
    rois, bbox_pred = out["rois"], out["bbox_pred"]
    c = num_classes
    if cfg.TEST.BBOX_REG:
        stds = device_constant(cfg.TRAIN.BBOX_NORMALIZE_STDS, torch.float32,
                               rois.device).repeat(c)
        means = device_constant(cfg.TRAIN.BBOX_NORMALIZE_MEANS, torch.float32,
                                rois.device).repeat(c)
        boxes = bbox_transform_inv(rois, bbox_pred * stds + means)
        boxes = clip_boxes(boxes, im_info[:, :2])
    else:
        boxes = rois.repeat(1, 1, c)
    return boxes / im_info[:, 2][:, None, None]


def postprocess_detections(out, im_info, cfg, num_classes: int, max_per_image: int):
    """Per-class score threshold + NMS over all B*C problems in one call,
    then a global top-k.  Returns (detections (B, D, 6)
    [x1, y1, x2, y2, score, class], valid (B, D))."""
    d = max_per_image
    boxes = decode_boxes(out, im_info, cfg, num_classes)
    scores = out["cls_prob"]
    b, n, c = scores.shape
    cls_boxes = boxes.reshape(b, n, c, 4).permute(0, 2, 1, 3).reshape(b * c, n, 4)
    cls_scores = scores.permute(0, 2, 1).reshape(b * c, n)
    thresh = device_constant(float(cfg.TEST.SCORE_THRESH), torch.float32, scores.device)
    valid = (out["roi_valid"][:, None, :] & (scores.permute(0, 2, 1) > thresh)).reshape(b * c, n)
    per_cls = min(d, n)

    idx, keep = batched_class_nms(cls_boxes, cls_scores, cfg.TEST.NMS, per_cls, valid=valid)
    idx = idx.long()
    g_boxes = torch.take_along_dim(cls_boxes, idx[..., None], dim=1)
    g_scores = torch.where(keep, torch.take_along_dim(cls_scores, idx, dim=1), -1.0)
    g_scores = g_scores.reshape(b, c, per_cls)
    cls_ids = torch.arange(c, dtype=torch.float32, device=scores.device)[None, :, None]
    cls_ids = cls_ids.expand(b, c, per_cls)
    g_scores = torch.where(cls_ids > 0, g_scores, -1.0)  # drop background
    # stable descending sort: ties take the lowest index first, as lax.top_k
    top_scores, top_idx = torch.sort(g_scores.reshape(b, c * per_cls), dim=1,
                                     descending=True, stable=True)
    top_scores, top_idx = top_scores[:, :d], top_idx[:, :d]
    det_valid = top_scores > 0
    det = torch.cat([
        torch.take_along_dim(g_boxes.reshape(b, c * per_cls, 4), top_idx[..., None], dim=1),
        top_scores[..., None],
        torch.take_along_dim(cls_ids.reshape(b, -1), top_idx, dim=1)[..., None]], dim=2)
    det = torch.where(det_valid[..., None], det, 0.0)
    return det, det_valid


def anchor_rows(cells, cell, a, a_n: int):
    """Per-anchor head rows straight from the conv-cell layout: cells
    (B, HW, d*A), the last axis split (A, d) a-major; cell, a (B, S) cell
    index and anchor-in-cell → (B, S, d) f32.  A row gather on the cell axis
    plus an A-way select, cast after the select: the (B, K, d) per-anchor
    rows of all K anchors are never made."""
    b, s = cell.shape
    rows = torch.take_along_dim(cells, cell[..., None], dim=1).reshape(b, s, a_n, -1)
    return torch.take_along_dim(rows, a[..., None, None], dim=2)[:, :, 0].float()


def gather_anchor_rows(cells, sel, a_n: int):
    """``anchor_rows`` for global A-minor anchor ids ``sel`` (B, S) over the
    level-concatenated cells (B, sum HW, d*A): id = cell * A + a holds across
    level boundaries because every level's anchor offset is a multiple of A."""
    cell = torch.div(sel, a_n, rounding_mode="floor")
    return anchor_rows(cells, cell, sel - cell * a_n, a_n)


class FasterRCNN(nn.Module):
    """The detector.  The backbone's children (ResNet: ``conv1``, ``bn1``,
    ``layer1``..``layer4``; VGG-16: ``features``, ``classifier``; MobileNet:
    ``conv0``, ``bn0``, ``sep1``..``sep13``) are registered on the detector
    itself, so the state_dict carries the lineage's flat names beside
    ``rpn_net``, ``rpn_cls_score``, ``rpn_bbox_pred``, ``cls_score`` and
    ``bbox_pred``.  ``rpn_cls_score`` keeps the lineage channel order: a
    background block of A channels, then a foreground block."""

    def __init__(self, backbone: nn.Module, num_classes: int, config: Config,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        object.__setattr__(self, "backbone", backbone)  # not a child: no prefix
        for name, child in backbone.named_children():
            self.add_module(name, child)
        self.num_classes = num_classes
        self.config = config
        self.dtype = dtype
        a = config.num_anchors
        self.rpn_net = nn.Conv2d(backbone.feat_channels, 512, 3, padding=1)
        self.rpn_cls_score = nn.Conv2d(512, a * 2, 1)
        self.rpn_bbox_pred = nn.Conv2d(512, a * 4, 1)
        self.cls_score = nn.Linear(backbone.tail_dim, num_classes)
        self.bbox_pred = nn.Linear(backbone.tail_dim, num_classes * 4)
        self._anchor_cache: dict = {}

    def _init_heads_(self, normal_):
        """``init_random_``'s RPN and head weights: N(0, 0.01) / N(0, 0.001)
        as the lineage, except the RPN's class weights at 0.05 so the RPN
        scores spread over (0, 1); biases zero."""
        for head, std in ((self.rpn_net, 0.01), (self.rpn_cls_score, 0.05),
                          (self.rpn_bbox_pred, 0.01), (self.cls_score, 0.01),
                          (self.bbox_pred, 0.001)):
            normal_(head.weight, std)
            head.bias.zero_()

    def _rpn(self, feat, sel=None):
        """feat (B, C, H, W) → (fg_prob (B, K), deltas (B, K, 4)) in anchor
        order (row-major cells, A contiguous per cell), f32.  fg_prob is
        sigmoid(fg − bg), as the JAX module computes it.  With ``sel``
        (B, S) anchor ids, also the (bg, fg) logits of those anchors
        (B, S, 2), read from the bg-block/fg-block channel layout."""
        b, _, h, w = feat.shape
        a = self.config.num_anchors
        x = F.relu(cast_conv(feat, self.rpn_net, padding=1))
        cls = cast_conv(x, self.rpn_cls_score).float()
        box = cast_conv(x, self.rpn_bbox_pred).float()
        prob = torch.sigmoid(cls[:, a:] - cls[:, :a]).permute(0, 2, 3, 1).reshape(b, h * w * a)
        deltas = box.permute(0, 2, 3, 1).reshape(b, h * w * a, 4)
        if sel is None:
            return prob, deltas
        # channel j*A + a of cell c is logit j of anchor c*A + a
        logits = cls.reshape(b, 2, a, h * w).permute(0, 3, 2, 1).reshape(b, h * w * a, 2)
        return prob, deltas, torch.take_along_dim(logits, sel[..., None], dim=1)

    def _anchors(self, h: int, w: int, device):
        key = (h, w, str(device))
        if key not in self._anchor_cache:
            anchors, _ = generate_anchors_pre(
                h, w, self.config.FEAT_STRIDE[0], ratios=self.config.ANCHOR_RATIOS,
                scales=self.config.ANCHOR_SCALES)
            self._anchor_cache[key] = torch.from_numpy(anchors).to(device)
        return self._anchor_cache[key]

    def _pool(self, feat, rois):
        """feat (B, C, h, w), rois (B, N, 4) image coords → (B, N, p, p, C)."""
        cfg = self.config
        return extract_roi_features(
            feat.permute(0, 2, 3, 1), rois, mode=cfg.POOLING_MODE,
            output_size=cfg.POOLING_SIZE, spatial_scale=1.0 / cfg.FEAT_STRIDE[0],
            sampling_ratio=cfg.DEVICE.ROI_SAMPLING_RATIO)

    def _classify(self, pooled, drop=None):
        """(B, N, p, p, C) → (cls_logits (B, N, classes), cls_prob (B, N,
        classes), bbox_pred (B, N, 4*classes)); ``drop``: the tail's dropout
        uniforms in training, else None."""
        b, n = pooled.shape[:2]
        flat = pooled.reshape((b * n,) + pooled.shape[2:]).to(self.dtype).permute(0, 3, 1, 2)
        # the last two layers in their parameters' dtype (f32, or f64 in an
        # f64 model), as the JAX Dense layers' promotion
        fc = self.backbone.head_to_tail(flat, drop).to(self.cls_score.weight.dtype)
        cls_logits = F.linear(fc, self.cls_score.weight, self.cls_score.bias)
        bbox = F.linear(fc, self.bbox_pred.weight, self.bbox_pred.bias)
        return (cls_logits.reshape(b, n, -1), torch.softmax(cls_logits, dim=-1).reshape(b, n, -1),
                bbox.reshape(b, n, -1))

    def predict(self, images, im_info):
        """images (B, H, W, 3) BGR; im_info (B, 3) [h, w, scale] → dict of
        rois, roi_scores, roi_valid, cls_prob, bbox_pred."""
        cfg = self.config
        x = preprocess_images(images, cfg, self.dtype).permute(0, 3, 1, 2)
        feat = self.backbone.extract_features(x)
        fg_prob, deltas = self._rpn(feat)
        anchors = self._anchors(feat.shape[2], feat.shape[3], feat.device)
        if cfg.TEST.MODE == "top":
            rois, roi_scores, roi_valid = proposal_top_layer(
                fg_prob, deltas, anchors, im_info, rpn_top_n=cfg.TEST.RPN_TOP_N)
        else:
            rois, roi_scores, roi_valid = proposal_layer_batch(
                fg_prob, deltas, anchors, im_info,
                pre_nms_top_n=cfg.TEST.RPN_PRE_NMS_TOP_N,
                post_nms_top_n=cfg.TEST.RPN_POST_NMS_TOP_N,
                nms_thresh=cfg.TEST.RPN_NMS_THRESH,
                use_threshold=select_kernel.threshold_route(fg_prob))
        _, cls_prob, bbox_pred = self._classify(self._pool(feat, rois))
        return {"rois": rois, "roi_scores": roi_scores, "roi_valid": roi_valid,
                "cls_prob": cls_prob, "bbox_pred": bbox_pred}

    def decode_detections(self, out, im_info):
        """``im_detect``'s decode of ``predict``'s outputs: (B, N, 4C) boxes
        per class in original image coordinates (``decode_boxes``)."""
        return decode_boxes(out, im_info, self.config, self.num_classes)

    def detect(self, images, im_info, max_per_image: int | None = None):
        """Serving path: (detections (B, D, 6) [x1, y1, x2, y2, score, class]
        in original image coordinates, valid (B, D))."""
        out = self.predict(images, im_info)
        return postprocess_detections(out, im_info, self.config, self.num_classes,
                                      max_per_image or self.config.TEST.MAX_PER_IMAGE)

    def train_forward(self, images, im_info, gt_boxes, gt_labels, gt_valid, draws):
        """TRAIN forward: images (B, H, W, 3) BGR, im_info (B, 3), gt_boxes
        (B, G, 4) padded, gt_labels (B, G), gt_valid (B, G); ``draws`` is a
        ``torch.Generator`` on the model's device (or a ``ShardedDraws`` over
        one), or a dict of the uniform draws ``uniform_draws`` makes
        (anchor_fg, anchor_bg (B, K); roi_fg, roi_bg (B, P + G) for P =
        min(RPN_POST_NMS_TOP_N, RPN_PRE_NMS_TOP_N, K) proposals; for a tail
        with dropout (VGG-16) also dropout (2, B * BATCH_SIZE, tail_dim)).
        Returns (losses dict of batch-mean scalars, aux dict)."""
        cfg = self.config
        t = cfg.TRAIN
        b = images.shape[0]
        x = preprocess_images(images, cfg, self.dtype).permute(0, 3, 1, 2)
        feat = self.backbone.extract_features(x)
        anchors = self._anchors(feat.shape[2], feat.shape[3], feat.device)
        layers = self.backbone.tail_dropout
        if not isinstance(draws, dict):
            n_rois = min(t.RPN_POST_NMS_TOP_N, t.RPN_PRE_NMS_TOP_N, anchors.shape[0])
            drop = (layers, b * t.BATCH_SIZE, self.backbone.tail_dim) if layers else None
            draws = uniform_draws(draws, b, anchors.shape[0], n_rois + gt_boxes.shape[1], drop)

        at = anchor_target_compact(anchors, gt_boxes, gt_valid, im_info, draws["anchor_fg"],
                                   draws["anchor_bg"], cfg)
        fg_prob, deltas, cls_rows = self._rpn(feat, at.sel)
        rois, roi_scores, roi_valid = proposal_layer_batch(
            fg_prob.detach(), deltas.detach(), anchors, im_info,
            pre_nms_top_n=t.RPN_PRE_NMS_TOP_N, post_nms_top_n=t.RPN_POST_NMS_TOP_N,
            nms_thresh=t.RPN_NMS_THRESH, use_threshold=select_kernel.threshold_route(fg_prob))
        pt = proposal_target_layer(rois, roi_valid, gt_boxes, gt_labels, gt_valid,
                                   draws["roi_fg"], draws["roi_bg"], cfg, self.num_classes)

        cls_logits, cls_prob, bbox_pred = self._classify(self._pool(feat, pt.rois),
                                                         draws["dropout"] if layers else None)
        box_rows = torch.take_along_dim(deltas, at.sel[..., None], dim=1)
        per_image = detection_losses_compact(cls_rows, box_rows, at, cls_logits, bbox_pred, pt)
        losses = {name: v.mean() for name, v in per_image.items()}
        aux = {"rois": pt.rois, "roi_labels": pt.labels, "cls_prob": cls_prob,
               "n_fg": (pt.labels > 0).sum(), "n_proposals": roi_valid.sum(),
               "proposals": rois, "proposal_scores": roi_scores, "proposal_valid": roi_valid}
        return losses, aux


def build_model(net: str, num_classes: int, cfg: Config, dtype=torch.float32):
    """Model factory: net in vgg16 | res50 | res101 | res152 | mobile (C4)
    or res{50,101,152}_fpn[_gn] (FPN)."""
    if "_fpn" in net:
        from frcnn_tpu_torch.models.fpn import build_fpn_model

        return build_fpn_model(net, num_classes, cfg, dtype=dtype)
    return FasterRCNN(build_backbone(net, cfg), num_classes, cfg, dtype=dtype)


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator):
    """Seeded random weights that keep activations O(1) through the trunk
    (a frozen-BN ResNet's output std 1-3, where the JAX init grows ~1000x):
    convs N(0, 2/fan_in) with zero biases, then the backbone's own
    ``init_random_`` (the raw O(100) pixels scaled down at the first layer,
    a ResNet's residual branches damped, VGG-16's fc6/fc7 drawn), then the
    model's ``_init_heads_`` for the layers past the trunk.  All draws come
    from ``generator`` on the CPU."""

    def normal_(t, std):
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    for module in model.modules():
        if isinstance(module, nn.Conv2d):
            normal_(module.weight, math.sqrt(2.0 / module.weight[0].numel()))
            if module.bias is not None:
                module.bias.zero_()
    model.backbone.init_random_(normal_)
    model._init_heads_(normal_)
