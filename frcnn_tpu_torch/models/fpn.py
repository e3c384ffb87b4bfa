"""Feature Pyramid Network Faster R-CNN (``frcnn_tpu/models/fpn.py``):
``predict`` and ``detect`` (serving) and ``train_forward`` (training).

ResNet C2-C5 (``ResNetV1.stages``) → top-down neck (P2-P5, P6 = a stride-2
subsample of P5) → one RPN head shared over P2-P6 with one anchor size per
level → per-level pre-NMS top-k (K5 on the long levels) → one cross-level
NMS (K1) → level assignment → multilevel RoIAlign over P2-P5 (K6, one
launch, rois in their own order) → 2-fc-1024 box head → ``cls_score`` /
``bbox_pred`` in f32 → the C4 model's ``postprocess_detections`` (K1 per
class).  Training: the same pyramid and RPN, the train proposal settings,
anchor targets over every level's anchors (K4, K5), proposal targets,
multilevel RoIAlign with its gradient (K6 forward, K6b backward), the box
head, the RPN loss rows gathered from the level cells at the sampled anchors
only, and the four losses.  P6 feeds the RPN only.

The RPN's 1x1 heads keep the JAX module's explicit (C, 2A) / (C, 4A)
parameters ``rpn_cls_w`` / ``rpn_box_w``, channel ``a * 2 + j`` (logit j of
anchor a) and ``a * 4 + coord``.  The FPN model has no lineage ``.pth``, so
the C4 model's bg-block/fg-block channel order does not apply here.  The fg
probability sigmoid(fg - bg) comes from one matmul against the weight
difference, laid out A-MAJOR within each level (index ``a * H*W + cell``),
as the JAX module lays it out: the per-level top-k ranks in that order, and
ties (exact, over padding) go to the lowest A-major index.  The anchor table
and the selected ids stay A-minor (``cell * A + a``).

Two trunks: ``res{50,101,152}_fpn`` with frozen BN (buffers; ``conv1`` and
``layer1..layer{FIXED_BLOCKS}`` do not train), and ``res{50,101,152}_fpn_gn``
with GroupNorm, the net the JAX package trains from scratch: its norms train,
and its stem freezes only at FIXED_BLOCKS >= 1 (``ResNetV1.freeze_fixed_blocks``).
K3 folds a frozen BN, so a GroupNorm trunk never launches it.
``init_reference_`` draws the weights the JAX ``model.init`` draws for a run
from scratch.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from frcnn_tpu_torch.config import Config
from frcnn_tpu_torch.models.backbones import GroupNorm, _conv, build_backbone, preprocess_images
from frcnn_tpu_torch.models.losses import detection_losses_compact
from frcnn_tpu_torch.models.network import (anchor_rows, decode_boxes, gather_anchor_rows,
                                            postprocess_detections)
from frcnn_tpu_torch.models.proposals import _anchor_validity
from frcnn_tpu_torch.models.targets import (anchor_target_compact, proposal_target_layer,
                                            uniform_draws)
from frcnn_tpu_torch.ops.anchors import generate_anchors_pre
from frcnn_tpu_torch.ops.boxes import bbox_transform_inv, clip_boxes
from frcnn_tpu_torch.ops.cuda.select_kernel import threshold_route, topk_descending
from frcnn_tpu_torch.ops.nms import NEG_INF, nms_fixed_batched
from frcnn_tpu_torch.ops.roi_align import extract_multilevel_features


def select_pre_nms(fg_prob, box_cells, sizes, per: int, a_n: int, use_threshold: bool = False):
    """Per-level pre-NMS top-k over A-major ``fg_prob`` (B, K), with each
    selected anchor's deltas read from its cell row plus an A-way select.

    box_cells: per-level (B, H*W, 4A) RPN box outputs; sizes: per-level K_l;
    per: top-k per level.  Returns (sel (B, n) global A-minor anchor ids,
    scores (B, n) in each level's descending order, deltas (B, n, 4) f32).

    A level no longer than ``per`` is taken whole, in A-major order, with no
    sort.  With ``use_threshold``, a level that passes the K5 gate takes its
    top-k set from ``topk_threshold`` (index-ascending) and a stable
    descending sort of the k winners, which is ``lax.top_k``'s order (lowest
    index first on a tie); every other level takes a stable sort."""
    b = fg_prob.shape[0]
    sel, sel_scores, sel_deltas = [], [], []
    off = 0
    for s, cells in zip(sizes, box_cells):
        k = min(per, s)
        hw = s // a_n
        lvl = fg_prob[:, off:off + s]
        if k >= s:
            sc = lvl
            idx = torch.arange(s, device=lvl.device).expand(b, s)
        else:
            sc, idx = topk_descending(lvl, k, use_threshold)
        a = torch.div(idx, hw, rounding_mode="floor")
        cell = idx - a * hw
        sel.append(cell * a_n + a + off)
        sel_deltas.append(anchor_rows(cells, cell, a, a_n))
        sel_scores.append(sc)
        off += s
    return torch.cat(sel, dim=1), torch.cat(sel_scores, dim=1), torch.cat(sel_deltas, dim=1)


def fg_logit_diff(tokens, dw, db):
    """tokens (B, HW, C) in the compute dtype, dw (C, A) and db (A,) in f32
    → the fg-minus-bg logits (B, HW, A) in f32, as the JAX einsum's f32
    output.  On the card a bf16 product takes an f32 result (no f32 copy of
    the tokens); elsewhere the operands are widened to f32."""
    b, hw, c = tokens.shape
    flat, w = tokens.reshape(b * hw, c), dw.to(tokens.dtype)
    if tokens.is_cuda and tokens.dtype != torch.float32:
        d = torch.mm(flat, w, out_dtype=torch.float32)
    else:
        d = flat.float() @ w.float()
    return d.reshape(b, hw, -1) + db


class FPNNeck(nn.Module):
    """Lateral 1x1 convs, the top-down nearest 2x upsample (cropped to the
    lateral's size where a level is odd), 3x3 output convs; P6 is P5 at
    stride 2 (the 1x1/s2 max-pool of the JAX module)."""

    def __init__(self, in_channels=(256, 512, 1024, 2048), out_channels: int = 256):
        super().__init__()
        for i, cin in enumerate(in_channels, start=2):
            setattr(self, f"lateral{i}", nn.Conv2d(cin, out_channels, 1))
            setattr(self, f"output{i}", nn.Conv2d(out_channels, out_channels, 3, padding=1))

    def forward(self, feats):
        """[C2..C5] NCHW → [P2..P6]."""
        laterals = [_conv(f, getattr(self, f"lateral{i}")) for i, f in enumerate(feats, start=2)]
        outs = [laterals[-1]]
        for lat in laterals[-2::-1]:
            up = F.interpolate(outs[0], scale_factor=2, mode="nearest")
            outs.insert(0, lat + up[:, :, :lat.shape[2], :lat.shape[3]])
        ps = [_conv(o, getattr(self, f"output{i}"), padding=1) for i, o in enumerate(outs, start=2)]
        return ps + [ps[-1][:, :, ::2, ::2]]


class FPNBoxHead(nn.Module):
    """2-fc-1024 box head.  ``fc1`` contracts a pooled (p, p, C) block
    flattened in (py, px, c) order, the JAX DenseGeneral kernel reshaped to
    (p*p*C, 1024) and transposed."""

    def __init__(self, in_dim: int, dim: int = 1024):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, dim)
        self.fc2 = nn.Linear(dim, dim)

    def forward(self, x):
        x = F.relu(F.linear(x, self.fc1.weight.to(x.dtype), self.fc1.bias.to(x.dtype)))
        return F.relu(F.linear(x, self.fc2.weight.to(x.dtype), self.fc2.bias.to(x.dtype)))


class FasterRCNNFPN(nn.Module):
    """The FPN detector.  The ResNet's children (``conv1``, ``bn1``,
    ``layer1``..``layer4``) are registered on the detector with
    torchvision's names, beside ``neck``, ``rpn_net``, ``rpn_{cls,box}_{w,b}``,
    ``box_head``, ``cls_score`` and ``bbox_pred``."""

    def __init__(self, backbone: nn.Module, num_classes: int, config: Config,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        object.__setattr__(self, "backbone", backbone)  # not a child: no prefix
        for name, child in backbone.named_children():
            self.add_module(name, child)
        self.num_classes = num_classes
        self.config = config
        self.dtype = dtype
        c = config.FPN.OUT_CHANNELS
        a = self._A
        self.neck = FPNNeck(tuple(256 * 2 ** i for i in range(4)), c)
        self.rpn_net = nn.Conv2d(c, 256, 3, padding=1)
        # in the compute dtype, as the reference's: under bf16 these weights,
        # their momentum and their updates are bf16
        self.rpn_cls_w = nn.Parameter(torch.zeros(256, 2 * a, dtype=dtype))
        self.rpn_cls_b = nn.Parameter(torch.zeros(2 * a, dtype=dtype))
        self.rpn_box_w = nn.Parameter(torch.zeros(256, 4 * a, dtype=dtype))
        self.rpn_box_b = nn.Parameter(torch.zeros(4 * a, dtype=dtype))
        p = config.POOLING_SIZE
        self.box_head = FPNBoxHead(p * p * c)
        self.cls_score = nn.Linear(1024, num_classes)
        self.bbox_pred = nn.Linear(1024, num_classes * 4)
        self._anchor_cache: dict = {}

    @property
    def _A(self) -> int:
        return len(self.config.ANCHOR_RATIOS)  # one scale per level

    @property
    def _levels(self):
        f = self.config.FPN
        return tuple(range(f.MIN_LEVEL, f.MAX_LEVEL + 2))  # P2..P6 (RPN)

    @property
    def use_kernels(self) -> bool:
        return self.config.DEVICE.USE_KERNELS

    def _init_heads_(self, normal_):
        """``init_random_``'s weights past the trunk: the neck convs (no relu
        after them) N(0, 1/fan_in) and the box head's fcs N(0, 2/fan_in), so
        every pyramid level stays O(1); the RPN and the last layers as the C4
        model's (class weights at 0.05); biases zero."""
        for module in self.neck.modules():
            if isinstance(module, nn.Conv2d):
                fan_in = module.in_channels * module.kernel_size[0] * module.kernel_size[1]
                normal_(module.weight, math.sqrt(1.0 / fan_in))
                module.bias.zero_()
        for fc in (self.box_head.fc1, self.box_head.fc2):
            normal_(fc.weight, math.sqrt(2.0 / fc.in_features))
            fc.bias.zero_()
        for w, b, std in ((self.rpn_cls_w, self.rpn_cls_b, 0.05),
                          (self.rpn_box_w, self.rpn_box_b, 0.01)):
            normal_(w, std)
            b.zero_()
        for head, std in ((self.rpn_net, 0.01), (self.cls_score, 0.01), (self.bbox_pred, 0.001)):
            normal_(head.weight, std)
            head.bias.zero_()

    def _pyramid(self, images):
        """images (B, H, W, 3) BGR → [P2..P6], NCHW in channels-last memory."""
        x = preprocess_images(images, self.config, self.dtype).permute(0, 3, 1, 2)
        return self.neck(self.backbone.stages(x))

    def _rpn_all_levels(self, pyramid, train: bool = False):
        """Shared RPN over the pyramid → (fg_prob (B, K) f32, A-major within
        each level, levels concatenated; box_cells, per level (B, H*W, 4A)
        in the compute dtype; cls_cells, per level (B, H*W, 2A) class logits
        in the compute dtype when ``train``, else None: serving never reads
        them)."""
        a_n = self._A
        dw = (self.rpn_cls_w[:, 1::2] - self.rpn_cls_w[:, 0::2]).float()   # (C, A)
        db = (self.rpn_cls_b[1::2] - self.rpn_cls_b[0::2]).float()         # (A,)
        probs, cells, cls_cells = [], [], []
        for feat in pyramid:
            b, _, h, w = feat.shape
            x = F.relu(_conv(feat, self.rpn_net, padding=1))
            tokens = x.permute(0, 2, 3, 1).reshape(b, h * w, x.shape[1])
            d = fg_logit_diff(tokens, dw, db)                              # (B, HW, A)
            probs.append(torch.sigmoid(d).transpose(1, 2).reshape(b, a_n * h * w))
            cells.append(tokens @ self.rpn_box_w.to(x.dtype) + self.rpn_box_b.to(x.dtype))
            if train:
                cls_cells.append(tokens @ self.rpn_cls_w.to(x.dtype)
                                 + self.rpn_cls_b.to(x.dtype))
        return torch.cat(probs, dim=1), cells, cls_cells if train else None

    def _anchors(self, pyramid):
        """Per-level anchors in the RPN's level order: one size per level
        (FPN.ANCHOR_SCALE x stride), the cfg ratios; A-minor rows."""
        device = pyramid[0].device
        key = tuple(tuple(p.shape[2:]) for p in pyramid) + (str(device),)
        if key not in self._anchor_cache:
            cfg = self.config
            per_level = [generate_anchors_pre(p.shape[2], p.shape[3], 2 ** level,
                                              ratios=cfg.ANCHOR_RATIOS,
                                              scales=(cfg.FPN.ANCHOR_SCALE,))[0]
                         for level, p in zip(self._levels, pyramid)]
            self._anchor_cache[key] = torch.from_numpy(np.concatenate(per_level)).to(device)
        return self._anchor_cache[key]

    def _propose(self, pyramid, fg_prob, box_cells, anchors, im_info, train: bool = False):
        """Per-level top-k, decode, clip, drop anchors centred on padding,
        one stable descending sort of the candidates, then one cross-level
        NMS (K1, presorted) → (rois (B, P, 4), scores (B, P), valid (B, P)).
        ``train`` takes the per-level and post-NMS counts and the threshold
        from the TRAIN settings."""
        cfg = self.config
        if train:
            per, post, thresh = (cfg.FPN.PRE_NMS_PER_LEVEL_TRAIN, cfg.TRAIN.RPN_POST_NMS_TOP_N,
                                 cfg.TRAIN.RPN_NMS_THRESH)
        else:
            per, post, thresh = (cfg.FPN.PRE_NMS_PER_LEVEL_TEST, cfg.TEST.RPN_POST_NMS_TOP_N,
                                 cfg.TEST.RPN_NMS_THRESH)
        sizes = [p.shape[2] * p.shape[3] * self._A for p in pyramid]
        sel, sel_scores, sel_deltas = select_pre_nms(
            fg_prob, box_cells, sizes, per, self._A,
            use_threshold=threshold_route(cfg, self.use_kernels, fg_prob))
        sel_anchors = anchors[sel]                                      # (B, n, 4)
        proposals = clip_boxes(bbox_transform_inv(sel_anchors, sel_deltas), im_info[:, :2])
        scores = torch.where(_anchor_validity(sel_anchors, im_info), sel_scores, NEG_INF)
        top_scores, top_idx = torch.sort(scores, dim=1, descending=True, stable=True)
        top_boxes = torch.take_along_dim(proposals, top_idx[..., None], dim=1)
        keep_idx, keep_valid = nms_fixed_batched(
            top_boxes, top_scores, thresh, post,
            valid=top_scores > NEG_INF / 2, use_kernels=self.use_kernels, presorted=True)
        keep_idx = keep_idx.long()
        rois = torch.take_along_dim(top_boxes, keep_idx[..., None], dim=1)
        roi_scores = torch.where(keep_valid, torch.take_along_dim(top_scores, keep_idx, dim=1),
                                 0.0)
        rois = torch.where(keep_valid[..., None], rois, 0.0)
        return rois, roi_scores, keep_valid

    def _assign_levels(self, rois):
        """k = floor(k0 + log2(sqrt(w*h) / canonical + 1e-8)), clamped to
        [MIN_LEVEL, MAX_LEVEL]; f32 in the JAX module's order.  Constants are
        f32 tensors (filled on the device, no host copy): a division by a
        Python scalar may be a multiplication by its reciprocal."""
        f = self.config.FPN

        def const(v):
            return torch.full((), v, dtype=torch.float32, device=rois.device)

        w = torch.maximum(rois[..., 2] - rois[..., 0] + 1.0, const(1.0))
        h = torch.maximum(rois[..., 3] - rois[..., 1] + 1.0, const(1.0))
        k = torch.floor(const(f.ROI_CANONICAL_LEVEL)
                        + torch.log2(torch.sqrt(w * h) / const(f.ROI_CANONICAL_SCALE)
                                     + const(1e-8)))
        return torch.clamp(k, f.MIN_LEVEL, f.MAX_LEVEL).to(torch.int32)

    def _pool(self, pyramid, rois):
        """RoIAlign of each roi on its assigned level of P2..P5 (K6, one
        launch; its gradient K6b, one launch) → (B, N, p, p, C) in roi
        order.  P6 is not passed: no roi gradient reaches it."""
        cfg = self.config
        f = cfg.FPN
        levels = self._assign_levels(rois) - f.MIN_LEVEL
        roi_levels = range(f.MIN_LEVEL, f.MAX_LEVEL + 1)
        maps = [p.permute(0, 2, 3, 1) for p in pyramid[:len(roi_levels)]]
        return extract_multilevel_features(
            maps, rois, levels, [2 ** lv for lv in roi_levels], output_size=cfg.POOLING_SIZE,
            sampling_ratio=cfg.DEVICE.ROI_SAMPLING_RATIO, use_kernels=self.use_kernels)

    def _classify(self, pooled):
        """(B, N, p, p, C) → (cls_logits, cls_prob (B, N, classes),
        bbox_pred (B, N, 4*classes)); the box head in the compute dtype, the
        two last layers in their parameters' dtype (f32, or f64 in an f64
        model), as the JAX Dense layers' promotion."""
        b, n = pooled.shape[:2]
        fc = self.box_head(pooled.reshape(b * n, -1).to(self.dtype))
        fc = fc.to(self.cls_score.weight.dtype)
        cls_logits = F.linear(fc, self.cls_score.weight, self.cls_score.bias)
        bbox = F.linear(fc, self.bbox_pred.weight, self.bbox_pred.bias)
        return (cls_logits.reshape(b, n, -1), torch.softmax(cls_logits, dim=-1).reshape(b, n, -1),
                bbox.reshape(b, n, -1))

    def predict(self, images, im_info):
        """images (B, H, W, 3) BGR; im_info (B, 3) [h, w, scale] → dict of
        rois, roi_scores, roi_valid, cls_prob, bbox_pred.  TEST.MODE is not
        read: the proposals are the NMS ones under "top" too, as in the JAX
        ``FasterRCNNFPN``."""
        pyramid = self._pyramid(images)
        fg_prob, box_cells, _ = self._rpn_all_levels(pyramid)
        anchors = self._anchors(pyramid)
        rois, roi_scores, roi_valid = self._propose(pyramid, fg_prob, box_cells, anchors, im_info)
        _, cls_prob, bbox_pred = self._classify(self._pool(pyramid, rois))
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
                                      max_per_image or self.config.TEST.MAX_PER_IMAGE,
                                      use_kernels=self.use_kernels)

    def train_forward(self, images, im_info, gt_boxes, gt_labels, gt_valid, draws):
        """TRAIN forward, the C4 model's signature: images (B, H, W, 3) BGR,
        im_info (B, 3), gt_boxes (B, G, 4) padded, gt_labels (B, G), gt_valid
        (B, G); ``draws`` is a ``torch.Generator`` on the model's device (or a
        ``ShardedDraws`` over one), or a dict of the uniform draws
        ``uniform_draws`` makes (anchor_fg, anchor_bg (B, K) over all K level
        anchors; roi_fg, roi_bg (B, P + G) for the P proposals ``_propose``
        returns).  Returns (losses dict of batch-mean scalars, aux dict)."""
        cfg = self.config
        a_n = self._A
        pyramid = self._pyramid(images)
        fg_prob, box_cells, cls_cells = self._rpn_all_levels(pyramid, train=True)
        anchors = self._anchors(pyramid)
        rois, roi_scores, roi_valid = self._propose(
            pyramid, fg_prob.detach(), [c.detach() for c in box_cells], anchors, im_info,
            train=True)
        if not isinstance(draws, dict):
            draws = uniform_draws(draws, images.shape[0], anchors.shape[0],
                                  rois.shape[1] + gt_boxes.shape[1])

        at = anchor_target_compact(anchors, gt_boxes, gt_valid, im_info, draws["anchor_fg"],
                                   draws["anchor_bg"], cfg)
        pt = proposal_target_layer(rois, roi_valid, gt_boxes, gt_labels, gt_valid,
                                   draws["roi_fg"], draws["roi_bg"], cfg, self.num_classes)

        cls_logits, cls_prob, bbox_pred = self._classify(self._pool(pyramid, pt.rois))
        # the RPN loss rows at the sampled anchors only, read from the cells in
        # the compute dtype and cast after the select
        cls_rows = gather_anchor_rows(torch.cat(cls_cells, dim=1), at.sel, a_n)
        box_rows = gather_anchor_rows(torch.cat(box_cells, dim=1), at.sel, a_n)
        per_image = detection_losses_compact(cls_rows, box_rows, at, cls_logits, bbox_pred, pt)
        losses = {name: v.mean() for name, v in per_image.items()}
        aux = {"rois": pt.rois, "roi_labels": pt.labels, "cls_prob": cls_prob,
               "n_fg": (pt.labels > 0).sum(), "n_proposals": roi_valid.sum(),
               "proposals": rois, "proposal_scores": roi_scores, "proposal_valid": roi_valid}
        return losses, aux


@torch.no_grad()
def init_reference_(model: FasterRCNNFPN, generator: torch.Generator):
    """The weights the JAX ``FasterRCNNFPN``'s ``model.init`` draws, for
    training from scratch: trunk and neck convs N(0, 2/fan_out) (the JAX
    ``conv_init``, fan_out = out channels x kernel area), conv biases 0;
    ``rpn_net``, ``rpn_cls_w`` and ``rpn_box_w`` N(0, 0.01); the box head's
    fcs flax's ``lecun_normal`` (a normal truncated at +-2 sigma, scaled to
    std sqrt(1/fan_in)); ``cls_score`` N(0, 0.01), ``bbox_pred`` N(0, 0.001);
    every other bias 0, GroupNorm scales 1.  Frozen-BN buffers keep their
    identity values.  All draws come from ``generator`` on the CPU."""

    def normal_(t, std):
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    for module in model.modules():
        if isinstance(module, nn.Conv2d):
            fan_out = module.out_channels * module.kernel_size[0] * module.kernel_size[1]
            normal_(module.weight, 0.01 if module is model.rpn_net else math.sqrt(2.0 / fan_out))
        elif isinstance(module, GroupNorm):
            module.weight.fill_(1.0)
    for fc in (model.box_head.fc1, model.box_head.fc2):
        # jax's truncated normal: a unit normal cut at +-2, whose std is 0.8796
        std = math.sqrt(1.0 / fc.in_features) / 0.87962566103423978
        fc.weight.copy_(nn.init.trunc_normal_(torch.empty(fc.weight.shape), 0.0, 1.0, -2.0, 2.0,
                                              generator=generator) * std)
    for w, std in ((model.rpn_cls_w, 0.01), (model.rpn_box_w, 0.01),
                   (model.cls_score.weight, 0.01), (model.bbox_pred.weight, 0.001)):
        normal_(w, std)
    for name, param in model.named_parameters():
        if name.endswith(("bias", "_b")):
            param.zero_()


def build_fpn_model(net: str, num_classes: int, cfg: Config, dtype=torch.float32):
    """net: res{50,101,152}_fpn (frozen BN: the pretrained path) or
    res{50,101,152}_fpn_gn (GroupNorm: trainable from scratch)."""
    trunk, _, norm = net.partition("_fpn")
    if trunk not in ("res50", "res101", "res152") or norm not in ("", "_gn"):
        raise ValueError(f"FPN backbone {net!r} is not ported "
                         "(expected res{50,101,152}_fpn or res{50,101,152}_fpn_gn)")
    if norm and cfg.RESNET.FIXED_BLOCKS > 0:
        print(f"WARNING: {net} is the from-scratch GroupNorm variant but "
              f"RESNET.FIXED_BLOCKS={cfg.RESNET.FIXED_BLOCKS} will freeze randomly initialized "
              f"early stages (conv1..layer{cfg.RESNET.FIXED_BLOCKS}) — set RESNET.FIXED_BLOCKS 0 "
              "unless you are loading pretrained weights")
    backbone = build_backbone(trunk, cfg, norm="group" if norm else "frozen_bn")
    return FasterRCNNFPN(backbone, num_classes, cfg, dtype=dtype)
