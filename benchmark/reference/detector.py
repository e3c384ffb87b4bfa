"""The plain float32 Faster R-CNN detectors the benchmark holds the system
to: ResNet C4 (the lineage's res50/101/152: trunk conv1..layer3 at stride
16, RPN, RoIAlign 7x7, layer4 as the per-roi tail) and ResNet FPN (C2-C5,
the top-down neck P2-P6, a shared RPN with one anchor size a level,
level-assigned RoIAlign over P2-P5, a 2-fc box head).

Functional: the weights are a dict of float32 tensors under torchvision's
names (``param_specs`` lists them), the settings a flat dict of dotted
config keys (the configuration file's ``cfg``).  Frozen batch norm is
y = x * w / sqrt(var + eps) + (b - mean * w / sqrt(var + eps)).

``quant``: None computes in float32 (with TF32 off, which the caller
sets); ``fp8`` rounds the input and the weights of every convolution and
fully connected layer to float8 e4m3 with a per-tensor scale, and their
gradients to float8 e5m2: the reference computed a precision below the
configuration's bfloat16, which the correctness check must refuse.

This file imports nothing of the system under test.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import ops

DEPTHS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
BN_EPS = 1e-5


def _round(t, dtype, largest: float):
    scale = torch.clamp(t.abs().amax(), min=1e-30) / largest
    return (t / scale).to(dtype).to(torch.float32) * scale


class _FP8(torch.autograd.Function):
    """Float8 training's rounding: e4m3 values forward, e5m2 gradients
    backward, each under a per-tensor scale (the Transformer Engine recipe)."""

    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2, 57344.0)


def fp8(t):
    """``t`` rounded to float8 e4m3 under a per-tensor scale, back in float32;
    its gradient rounded to float8 e5m2 the same way."""
    return _FP8.apply(t)


class Net:
    """One detector: ``W`` weights, ``c`` settings, ``net`` ("res101",
    "res50_fpn", ...), ``num_classes``; ``quant`` None or "fp8"."""

    def __init__(self, W: dict, c: dict, net: str, num_classes: int, quant=None):
        self.W, self.c, self.net, self.num_classes = W, c, net, num_classes
        self.fpn = net.endswith("_fpn")
        self.depth = int(net[3:].split("_")[0])
        self.q = fp8 if quant == "fp8" else (lambda t: t)

    # -- layers ---------------------------------------------------------------
    def conv(self, x, name, stride=1, padding=0, bias=True):
        b = self.W.get(name + ".bias") if bias else None
        return F.conv2d(self.q(x), self.q(self.W[name + ".weight"]), b, stride, padding)

    def linear(self, x, name):
        return F.linear(self.q(x), self.q(self.W[name + ".weight"]), self.W[name + ".bias"])

    def bn(self, x, name):
        W = self.W
        inv = torch.sqrt(W[name + ".running_var"] + BN_EPS)
        mul = W[name + ".weight"] / inv
        add = W[name + ".bias"] - W[name + ".running_mean"] * W[name + ".weight"] / inv
        return x * mul[:, None, None] + add[:, None, None]

    def block(self, x, name, stride):
        y = F.relu(self.bn(self.conv(x, name + ".conv1", bias=False), name + ".bn1"))
        y = F.relu(self.bn(self.conv(y, name + ".conv2", stride, 1, bias=False), name + ".bn2"))
        y = self.bn(self.conv(y, name + ".conv3", bias=False), name + ".bn3")
        if name + ".downsample.0.weight" in self.W:
            x = self.bn(self.conv(x, name + ".downsample.0", stride, bias=False),
                        name + ".downsample.1")
        return F.relu(y + x)

    def layer(self, x, li):
        for i in range(DEPTHS[self.depth][li - 1]):
            x = self.block(x, f"layer{li}.{i}", 2 if (i == 0 and li > 1) else 1)
        return x

    def stem(self, images):
        c = self.c
        x = (images.float() - torch.tensor(c["PIXEL_MEANS"], device=images.device))
        x = (x * c["DEVICE.PIXEL_SCALE"]).permute(0, 3, 1, 2)
        x = F.relu(self.bn(self.conv(x, "conv1", 2, 3, bias=False), "bn1"))
        return F.max_pool2d(x, 3, 2, 1)

    # -- C4 -------------------------------------------------------------------
    def c4_rpn(self, feat):
        a = len(self.c["ANCHOR_SCALES"]) * len(self.c["ANCHOR_RATIOS"])
        b, _, h, w = feat.shape
        x = F.relu(self.conv(feat, "rpn_net", padding=1))
        cls = self.conv(x, "rpn_cls_score")
        box = self.conv(x, "rpn_bbox_pred")
        prob = torch.sigmoid(cls[:, a:] - cls[:, :a]).permute(0, 2, 3, 1).reshape(b, h * w * a)
        deltas = box.permute(0, 2, 3, 1).reshape(b, h * w * a, 4)
        logits = cls.reshape(b, 2, a, h * w).permute(0, 3, 2, 1).reshape(b, h * w * a, 2)
        return prob, deltas, logits

    def c4_anchors(self, feat):
        c = self.c
        anchors = ops.grid_anchors(feat.shape[2], feat.shape[3], c["FEAT_STRIDE"][0],
                                   c["ANCHOR_RATIOS"], c["ANCHOR_SCALES"])
        return torch.from_numpy(anchors).to(feat.device)

    def c4_classify(self, feat, rois):
        c = self.c
        pooled = ops.roi_align(feat.permute(0, 2, 3, 1), rois, c["POOLING_SIZE"],
                               1.0 / c["FEAT_STRIDE"][0], c["DEVICE.ROI_SAMPLING_RATIO"])
        b, n = pooled.shape[:2]
        x = pooled.reshape((b * n,) + pooled.shape[2:]).permute(0, 3, 1, 2)
        fc = self.layer(x, 4).mean(dim=(2, 3))
        return self.heads(fc, b, n)

    def heads(self, fc, b, n):
        logits = self.linear(fc, "cls_score")
        bbox = self.linear(fc, "bbox_pred")
        return (logits.reshape(b, n, -1), torch.softmax(logits, -1).reshape(b, n, -1),
                bbox.reshape(b, n, -1))

    # -- FPN ------------------------------------------------------------------
    def pyramid(self, images):
        x = self.stem(images)
        feats = [self.layer(x, 1)]
        for li in (2, 3, 4):
            feats.append(self.layer(feats[-1], li))
        lat = [self.conv(f, f"neck.lateral{i}") for i, f in enumerate(feats, start=2)]
        outs = [lat[-1]]
        for lt in lat[-2::-1]:
            up = F.interpolate(outs[0], scale_factor=2, mode="nearest")
            outs.insert(0, lt + up[:, :, :lt.shape[2], :lt.shape[3]])
        ps = [self.conv(o, f"neck.output{i}", padding=1) for i, o in enumerate(outs, start=2)]
        return ps + [ps[-1][:, :, ::2, ::2]]

    def fpn_rpn(self, pyramid):
        """→ (fg prob (B, K) A-major within each level, box cells per level
        (B, HW, 4A), class cells per level (B, HW, 2A))."""
        W = self.W
        a = len(self.c["ANCHOR_RATIOS"])
        probs, boxes, clss = [], [], []
        for feat in pyramid:
            b, _, h, w = feat.shape
            x = F.relu(self.conv(feat, "rpn_net", padding=1))
            tok = x.permute(0, 2, 3, 1).reshape(b, h * w, -1)
            cls = self.q(tok) @ self.q(W["rpn_cls_w"]) + W["rpn_cls_b"]            # (B, HW, 2A)
            d = cls[..., 1::2] - cls[..., 0::2]
            probs.append(torch.sigmoid(d).transpose(1, 2).reshape(b, a * h * w))
            boxes.append(self.q(tok) @ self.q(W["rpn_box_w"]) + W["rpn_box_b"])
            clss.append(cls)
        return torch.cat(probs, 1), boxes, clss

    def fpn_anchors(self, pyramid):
        c = self.c
        levels = range(c["FPN.MIN_LEVEL"], c["FPN.MAX_LEVEL"] + 2)
        per = [ops.grid_anchors(p.shape[2], p.shape[3], 2 ** lv, c["ANCHOR_RATIOS"],
                                (c["FPN.ANCHOR_SCALE"],)) for lv, p in zip(levels, pyramid)]
        return torch.cat([torch.from_numpy(x) for x in per]).to(pyramid[0].device)

    def fpn_propose(self, pyramid, prob, boxes, anchors, im_info, train):
        c = self.c
        a = len(c["ANCHOR_RATIOS"])
        if train:
            per, post, thr = (c["FPN.PRE_NMS_PER_LEVEL_TRAIN"], c["TRAIN.RPN_POST_NMS_TOP_N"],
                              c["TRAIN.RPN_NMS_THRESH"])
        else:
            per, post, thr = (c["FPN.PRE_NMS_PER_LEVEL_TEST"], c["TEST.RPN_POST_NMS_TOP_N"],
                              c["TEST.RPN_NMS_THRESH"])
        sizes = [p.shape[2] * p.shape[3] * a for p in pyramid]
        return ops.propose_levels(prob, boxes, sizes, a, anchors, im_info, per, post, thr)

    def fpn_classify(self, pyramid, rois):
        c = self.c
        lo, hi = c["FPN.MIN_LEVEL"], c["FPN.MAX_LEVEL"]
        w = torch.clamp(rois[..., 2] - rois[..., 0] + 1.0, min=1.0)
        h = torch.clamp(rois[..., 3] - rois[..., 1] + 1.0, min=1.0)
        k = torch.floor(ops.const(c["FPN.ROI_CANONICAL_LEVEL"], rois)
                        + torch.log2(torch.sqrt(w * h) / ops.const(c["FPN.ROI_CANONICAL_SCALE"], rois)
                                     + ops.const(1e-8, rois)))
        levels = torch.clamp(k, lo, hi).long() - lo
        maps = [p.permute(0, 2, 3, 1) for p in pyramid[:hi - lo + 1]]
        pooled = ops.roi_align_levels(maps, rois, levels, [2 ** lv for lv in range(lo, hi + 1)],
                                      c["POOLING_SIZE"], c["DEVICE.ROI_SAMPLING_RATIO"])
        b, n = pooled.shape[:2]
        x = F.relu(self.linear(pooled.reshape(b * n, -1), "box_head.fc1"))
        x = F.relu(self.linear(x, "box_head.fc2"))
        return self.heads(x, b, n)

    # -- entry points -----------------------------------------------------------
    def detect(self, images, im_info, max_per_image=None):
        """images (B, H, W, 3) BGR pixels, im_info (B, 3) [h, w, scale] →
        (dets (B, D, 6), valid (B, D)) in original image coordinates."""
        c = self.c
        if self.fpn:
            pyr = self.pyramid(images)
            prob, boxes, _ = self.fpn_rpn(pyr)
            rois, _, valid = self.fpn_propose(pyr, prob, boxes, self.fpn_anchors(pyr), im_info,
                                              False)
            _, cls_prob, bbox = self.fpn_classify(pyr, rois)
        else:
            feat = self.layer(self.layer(self.layer(self.stem(images), 1), 2), 3)
            prob, deltas, _ = self.c4_rpn(feat)
            rois, _, valid = ops.propose(prob, deltas, self.c4_anchors(feat), im_info,
                                         c["TEST.RPN_PRE_NMS_TOP_N"],
                                         c["TEST.RPN_POST_NMS_TOP_N"], c["TEST.RPN_NMS_THRESH"])
            _, cls_prob, bbox = self.c4_classify(feat, rois)
        return ops.postprocess(rois, valid, cls_prob, bbox, im_info, c, self.num_classes,
                               max_per_image or c["TEST.MAX_PER_IMAGE"])

    def train_losses(self, images, im_info, gt_boxes, gt_labels, gt_valid, rand):
        """The four training losses (batch means); the sampling uniforms come
        from ``rand(*size)``: anchor fg, anchor bg (B, K), roi fg, roi bg
        (B, P + G), in that order, once a step."""
        c = self.c
        b, g = images.shape[0], gt_boxes.shape[1]
        a = (len(c["ANCHOR_RATIOS"]) if self.fpn
             else len(c["ANCHOR_SCALES"]) * len(c["ANCHOR_RATIOS"]))

        if self.fpn:
            pyr = self.pyramid(images)
            prob, boxes, clss = self.fpn_rpn(pyr)
            anchors = self.fpn_anchors(pyr)
            rois, _, roi_valid = self.fpn_propose(pyr, prob.detach(), [x.detach() for x in boxes],
                                                  anchors, im_info, True)
        else:
            feat = self.layer(self.layer(self.layer(self.stem(images), 1), 2), 3)
            prob, deltas, logits = self.c4_rpn(feat)
            anchors = self.c4_anchors(feat)
        k = anchors.shape[0]
        n = (rois.shape[1] if self.fpn
             else min(c["TRAIN.RPN_POST_NMS_TOP_N"], c["TRAIN.RPN_PRE_NMS_TOP_N"], k))
        u = {"afg": rand(b, k), "abg": rand(b, k), "rfg": rand(b, n + g), "rbg": rand(b, n + g)}
        at = ops.anchor_targets(anchors, gt_boxes, gt_valid, im_info, u["afg"], u["abg"], c)
        sel = at[0]
        if not self.fpn:
            rois, _, roi_valid = ops.propose(prob.detach(), deltas.detach(), anchors, im_info,
                                             c["TRAIN.RPN_PRE_NMS_TOP_N"],
                                             c["TRAIN.RPN_POST_NMS_TOP_N"],
                                             c["TRAIN.RPN_NMS_THRESH"])
            cls_rows = torch.take_along_dim(logits, sel[..., None], 1)
            box_rows = torch.take_along_dim(deltas, sel[..., None], 1)
        else:
            cls_rows = _anchor_rows(torch.cat(clss, 1), sel, a)
            box_rows = _anchor_rows(torch.cat(boxes, 1), sel, a)
        pt = ops.proposal_targets(rois, roi_valid, gt_boxes, gt_labels, gt_valid, u["rfg"],
                                  u["rbg"], c, self.num_classes)
        if self.fpn:
            cls_logits, _, bbox = self.fpn_classify(pyr, pt[0])
        else:
            cls_logits, _, bbox = self.c4_classify(feat, pt[0])
        return ops.detection_losses(cls_rows, box_rows, at, cls_logits, bbox, pt)


def _anchor_rows(cells, sel, a_n):
    """Rows of A-minor anchor ids ``sel`` (B, S) from level-concatenated
    cells (B, sum HW, d*A) → (B, S, d)."""
    b, s = sel.shape
    cell = torch.div(sel, a_n, rounding_mode="floor")
    rows = torch.take_along_dim(cells, cell[..., None], 1).reshape(b, s, a_n, -1)
    return torch.take_along_dim(rows, (sel - cell * a_n)[..., None, None], 2)[:, :, 0]


# -- parameters ---------------------------------------------------------------

def param_specs(net: str, num_classes: int, c: dict, scheme: dict | None = None):
    """[(name, shape, init)] of every weight and buffer of the detector, in
    a fixed order.  ``init`` is ("normal", std), ("fill", value) or
    ("zeros",): seeded random weights that keep a frozen-BN ResNet's
    activations O(1) at full depth (He-normal convolutions, each residual
    branch's last norm at ``scheme["residual_gain"]``, default 0.5, the
    stem's at 1/64 against raw pixels), the heads as the lineage's (RPN
    class weights at 0.05, the classifier at ``scheme["cls_score_std"]``,
    default 0.01).  Deeper trunks need a smaller gain: at 0.5 ResNet-101's
    layer3 grows to a mean of ~15 and saturates the RPN's sigmoid, whose
    order then no precision can hold."""
    scheme = scheme or {}
    gain = scheme.get("residual_gain", 0.5)
    fpn = net.endswith("_fpn")
    depth = int(net[3:].split("_")[0])
    specs = []

    def conv(name, cout, cin, k, bias, std=None):
        specs.append((name + ".weight", (cout, cin, k, k),
                      ("normal", std if std is not None else math.sqrt(2.0 / (cin * k * k)))))
        if bias:
            specs.append((name + ".bias", (cout,), ("zeros",)))

    def bn(name, ch, weight=1.0):
        specs.extend([(name + ".weight", (ch,), ("fill", weight)), (name + ".bias", (ch,), ("zeros",)),
                      (name + ".running_mean", (ch,), ("zeros",)),
                      (name + ".running_var", (ch,), ("fill", 1.0))])

    def linear(name, cout, cin, std):
        specs.extend([(name + ".weight", (cout, cin), ("normal", std)),
                      (name + ".bias", (cout,), ("zeros",))])

    conv("conv1", 64, 3, 7, False)
    bn("bn1", 64, 1.0 / 64.0)
    cin = 64
    for li, (n, ch) in enumerate(zip(DEPTHS[depth], (64, 128, 256, 512)), start=1):
        for i in range(n):
            name = f"layer{li}.{i}"
            conv(name + ".conv1", ch, cin, 1, False)
            bn(name + ".bn1", ch)
            conv(name + ".conv2", ch, ch, 3, False)
            bn(name + ".bn2", ch)
            conv(name + ".conv3", ch * 4, ch, 1, False)
            bn(name + ".bn3", ch * 4, gain)
            if i == 0:
                conv(name + ".downsample.0", ch * 4, cin, 1, False)
                bn(name + ".downsample.1", ch * 4, gain)
            cin = ch * 4
    if fpn:
        oc = c["FPN.OUT_CHANNELS"]
        a = len(c["ANCHOR_RATIOS"])
        for i, ch in enumerate((256, 512, 1024, 2048), start=2):
            conv(f"neck.lateral{i}", oc, ch, 1, True, math.sqrt(1.0 / ch))
            conv(f"neck.output{i}", oc, oc, 3, True, math.sqrt(1.0 / (oc * 9)))
        conv("rpn_net", 256, oc, 3, True, 0.01)
        specs.extend([("rpn_cls_w", (256, 2 * a), ("normal", 0.05)), ("rpn_cls_b", (2 * a,), ("zeros",)),
                      ("rpn_box_w", (256, 4 * a), ("normal", 0.01)), ("rpn_box_b", (4 * a,), ("zeros",))])
        p = c["POOLING_SIZE"]
        linear("box_head.fc1", 1024, p * p * oc, math.sqrt(2.0 / (p * p * oc)))
        linear("box_head.fc2", 1024, 1024, math.sqrt(2.0 / 1024))
        tail = 1024
    else:
        a = len(c["ANCHOR_SCALES"]) * len(c["ANCHOR_RATIOS"])
        conv("rpn_net", 512, 1024, 3, True, 0.01)
        conv("rpn_cls_score", 2 * a, 512, 1, True, 0.05)
        conv("rpn_bbox_pred", 4 * a, 512, 1, True, 0.01)
        tail = 2048
    linear("cls_score", num_classes, tail, scheme.get("cls_score_std", 0.01))
    linear("bbox_pred", 4 * num_classes, tail, 0.001)
    return specs


def is_buffer(name: str) -> bool:
    """Frozen batch norm's four tensors: never trained."""
    return ".bn" in name or name.startswith("bn1.") or ".downsample.1." in name


def trainable(name: str, c: dict) -> bool:
    """Whether the lineage's recipe trains this weight: not frozen BN, not
    the stem, not layer1..RESNET.FIXED_BLOCKS."""
    if is_buffer(name) or name.startswith("conv1."):
        return False
    return not any(name.startswith(f"layer{i}.") for i in range(1, c["RESNET.FIXED_BLOCKS"] + 1))
