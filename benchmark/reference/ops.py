"""Plain float32 PyTorch operations of the Faster R-CNN detector, frozen
for the benchmark's reference: box transforms, anchors, greedy NMS, RoIAlign
(one level and a pyramid), the proposal layers, the training targets and
the losses.  No kernel, no graph, no cache: every result is written out in
tensor operations, with stable sorts (ties keep the lowest index first) and
exact greedy suppression.

This file imports nothing of the system under test.  Its semantics are
those of the lineage (tf-faster-rcnn) as the measured package states them:
inclusive-corner boxes (w = x2 - x1 + 1), deltas (dx, dy, dw, dh) with the
size deltas clamped at log(1000 / 16), RoIAlign with torchvision's
``aligned=False`` sampling at a fixed ratio, sampling without replacement by
random priorities drawn as uniforms.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

BBOX_XFORM_CLIP = math.log(1000.0 / 16.0)
NEG_INF = -1e10
NMS_TILE = 128      # boxes resolved in order within a tile; a tile's kept boxes then suppress the rest
ROI_CHUNK = 64      # rois gathered at once by ``roi_align``


def const(value, like):
    """A float32 scalar tensor on ``like``'s device: dividing by a tensor
    rounds the quotient once, where CUDA's division by a Python scalar
    multiplies by its reciprocal."""
    return torch.full((), float(value), dtype=torch.float32, device=like.device)


# -- boxes --------------------------------------------------------------------

def bbox_transform(ex, gt, eps: float = 1e-14):
    """Deltas of ``gt`` boxes relative to ``ex`` boxes, (..., 4) each."""
    ew, eh = ex[..., 2] - ex[..., 0] + 1.0, ex[..., 3] - ex[..., 1] + 1.0
    gw, gh = gt[..., 2] - gt[..., 0] + 1.0, gt[..., 3] - gt[..., 1] + 1.0
    ecx, ecy = ex[..., 0] + 0.5 * ew, ex[..., 1] + 0.5 * eh
    gcx, gcy = gt[..., 0] + 0.5 * gw, gt[..., 1] + 0.5 * gh
    ew, eh = torch.clamp(ew, min=eps), torch.clamp(eh, min=eps)
    return torch.stack([(gcx - ecx) / ew, (gcy - ecy) / eh,
                        torch.log(torch.clamp(gw, min=eps) / ew),
                        torch.log(torch.clamp(gh, min=eps) / eh)], dim=-1)


def bbox_transform_inv(boxes, deltas):
    """Decode deltas (..., 4K) on boxes (..., 4) → (..., 4K)."""
    boxes = boxes.to(deltas.dtype)
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    cx, cy = boxes[..., 0] + 0.5 * w, boxes[..., 1] + 0.5 * h
    dx, dy, dw, dh = deltas.reshape(deltas.shape[:-1] + (-1, 4)).unbind(-1)
    dw, dh = torch.clamp(dw, max=BBOX_XFORM_CLIP), torch.clamp(dh, max=BBOX_XFORM_CLIP)
    pcx, pcy = dx * w[..., None] + cx[..., None], dy * h[..., None] + cy[..., None]
    pw, ph = torch.exp(dw) * w[..., None], torch.exp(dh) * h[..., None]
    out = torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw - 1.0,
                       pcy + 0.5 * ph - 1.0], dim=-1)
    return out.reshape(deltas.shape)


def clip_boxes(boxes, hw):
    """Clip (B, N, 4K) boxes to each image's [0, w - 1] x [0, h - 1]; hw (B, 2)."""
    b = boxes.reshape(boxes.shape[:-1] + (-1, 4))
    h = hw[:, 0].reshape(-1, *([1] * (b.dim() - 2)))
    w = hw[:, 1].reshape(-1, *([1] * (b.dim() - 2)))
    x1 = torch.minimum(torch.clamp(b[..., 0], min=0.0), w - 1.0)
    y1 = torch.minimum(torch.clamp(b[..., 1], min=0.0), h - 1.0)
    x2 = torch.minimum(torch.clamp(b[..., 2], min=0.0), w - 1.0)
    y2 = torch.minimum(torch.clamp(b[..., 3], min=0.0), h - 1.0)
    return torch.stack([x1, y1, x2, y2], dim=-1).reshape(boxes.shape)


def box_iou(a, b):
    """Pairwise IoU (..., N, 4) x (..., M, 4) → (..., N, M); 0 where disjoint."""
    x, y = a[..., :, None, :], b[..., None, :, :]
    iw = torch.minimum(x[..., 2], y[..., 2]) - torch.maximum(x[..., 0], y[..., 0]) + 1.0
    ih = torch.minimum(x[..., 3], y[..., 3]) - torch.maximum(x[..., 1], y[..., 1]) + 1.0
    inter = torch.clamp(iw, min=0.0) * torch.clamp(ih, min=0.0)
    area_a = (a[..., 2] - a[..., 0] + 1.0) * (a[..., 3] - a[..., 1] + 1.0)
    area_b = (b[..., 2] - b[..., 0] + 1.0) * (b[..., 3] - b[..., 1] + 1.0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(inter > 0, inter / union, torch.zeros_like(inter))


# -- anchors ------------------------------------------------------------------

def base_anchors(base_size, ratios, scales):
    """The len(ratios) x len(scales) Caffe-rounded anchors, ratio-major (A, 4)."""
    ratios, scales = np.asarray(ratios, np.float64), np.asarray(scales, np.float64)
    center = (base_size - 1.0) / 2.0
    rw = np.round(np.sqrt(base_size * base_size / ratios))
    rh = np.round(rw * ratios)
    w, h = (rw[:, None] * scales[None]).reshape(-1), (rh[:, None] * scales[None]).reshape(-1)
    return np.stack([center - 0.5 * (w - 1), center - 0.5 * (h - 1),
                     center + 0.5 * (w - 1), center + 0.5 * (h - 1)], 1).astype(np.float32)


def grid_anchors(h: int, w: int, stride: int, ratios, scales):
    """Anchors over an (h, w) grid, row (y * w + x) * A + a, float32 numpy."""
    base = base_anchors(stride, ratios, scales)
    sx, sy = np.meshgrid(np.arange(w, dtype=np.float32) * stride,
                         np.arange(h, dtype=np.float32) * stride)
    shifts = np.stack([sx, sy, sx, sy], -1).reshape(-1, 1, 4)
    return (base[None] + shifts).reshape(-1, 4)


def anchor_centre_inside(anchors, im_info):
    """(K, 4) or (B, K, 4) anchors → (B, K): the centre lies in the unpadded image."""
    cx = (anchors[..., 0] + anchors[..., 2]) * 0.5
    cy = (anchors[..., 1] + anchors[..., 3]) * 0.5
    return (cx >= 0) & (cx < im_info[:, 1:2]) & (cy >= 0) & (cy < im_info[:, 0:1])


# -- NMS ----------------------------------------------------------------------

def nms_keep(boxes, thresh, valid):
    """Exact greedy NMS of (B, N, 4) boxes in descending score order; valid
    (B, N).  A box is suppressed by an earlier kept box of IoU > thresh;
    invalid boxes neither survive nor suppress.  Returns keep (B, N)."""
    n = boxes.shape[1]
    thr = const(thresh, boxes)
    suppressed = ~valid
    idx = torch.arange(NMS_TILE, device=boxes.device)
    later = idx[None, :] > idx[:, None]
    for start in range(0, n, NMS_TILE):
        stop = min(start + NMS_TILE, n)
        tile = boxes[:, start:stop]
        t = stop - start
        hits = (box_iou(tile, tile) > thr) & later[:t, :t]
        sup = suppressed[:, start:stop].clone()
        for i in range(t):
            sup |= (~sup[:, i])[:, None] & hits[:, i]
        suppressed[:, start:stop] = sup
        if stop < n:
            cross = (box_iou(tile, boxes[:, stop:]) > thr) & (~sup)[:, :, None]
            suppressed[:, stop:] |= cross.any(dim=1)
    return ~suppressed & valid


def nms_select(boxes, scores, thresh, max_out: int, valid, presorted: bool = False):
    """Greedy NMS, the first ``max_out`` kept boxes by score → (indices
    (B, max_out) into the input, keep_valid (B, max_out)); padding indices
    point at each row's first box in score order."""
    n = scores.shape[1]
    if presorted:
        order = torch.arange(n, device=scores.device).expand_as(scores)
    else:
        order = torch.argsort(-torch.where(valid, scores, NEG_INF), dim=1, stable=True)
    sboxes = torch.take_along_dim(boxes, order[..., None], dim=1)
    keep = nms_keep(sboxes, thresh, torch.take_along_dim(valid, order, dim=1))
    rank = torch.where(keep, torch.arange(n, device=scores.device)[None], n)
    take = torch.argsort(rank, dim=1, stable=True)[:, :max_out]
    out_valid = torch.take_along_dim(keep, take, dim=1)
    out_idx = torch.where(out_valid, torch.take_along_dim(order, take, dim=1), order[:, :1])
    return out_idx, out_valid


def topk_desc(scores, k: int):
    """Top-k of each row, descending, the lowest index first on a tie."""
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


# -- RoIAlign -----------------------------------------------------------------

def _axis(lo, hi, p: int, sr: int, size: int):
    bin_sz = torch.clamp(hi - lo, min=1.0) / const(p, lo)
    s = (torch.arange(p * sr, dtype=torch.float32, device=lo.device) + 0.5) / const(sr, lo)
    coords = lo[..., None] + s * bin_sz[..., None]
    empty = (coords < -1.0) | (coords > size)
    c = torch.clamp(coords, 0.0, size - 1.0)
    low = torch.floor(c)
    frac = c - low
    low_i = low.long()
    high_i = torch.clamp(low_i + 1, max=size - 1)
    return low_i, high_i, torch.where(empty, 0.0, 1.0 - frac), torch.where(empty, 0.0, frac)


def roi_align(feat, rois, p: int, scale: float, sr: int):
    """RoIAlign: feat (B, H, W, C), rois (B, R, 4) in image coordinates →
    (B, R, p, p, C); each bin the mean of sr x sr bilinear samples."""
    b, h, w, c = feat.shape
    r = rois.shape[1]
    scaled = rois.float() * scale
    yl, yh, wyl, wyh = _axis(scaled[..., 1], scaled[..., 3], p, sr, h)
    xl, xh, wxl, wxh = _axis(scaled[..., 0], scaled[..., 2], p, sr, w)
    flat = feat.reshape(b, h * w, c)
    outs = []
    for r0 in range(0, r, ROI_CHUNK):
        sl = slice(r0, r0 + ROI_CHUNK)
        acc = 0.0
        for yi, wy in ((yl[:, sl], wyl[:, sl]), (yh[:, sl], wyh[:, sl])):
            for xi, wx in ((xl[:, sl], wxl[:, sl]), (xh[:, sl], wxh[:, sl])):
                idx = (yi[..., :, None] * w + xi[..., None, :]).flatten(1)
                vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
                acc = acc + vals * (wy[..., :, None] * wx[..., None, :]).flatten(1)[..., None]
        rc = acc.shape[1] // (p * sr * p * sr)
        outs.append(acc.reshape(b, rc, p, sr, p, sr, c).mean(dim=(3, 5)))
    return torch.cat(outs, dim=1)


def roi_align_levels(feats, rois, levels, strides, p: int, sr: int):
    """Each roi pooled from its level of the pyramid: feats L maps (B, H, W, C),
    levels (B, R) in [0, L) → (B, R, p, p, C)."""
    out = None
    for li, (feat, stride) in enumerate(zip(feats, strides)):
        pooled = roi_align(feat, rois, p, 1.0 / stride, sr)
        on = (levels == li)[..., None, None, None]
        out = torch.where(on, pooled, 0.0 if out is None else out)
    return out


# -- proposals ----------------------------------------------------------------

def propose(scores, deltas, anchors, im_info, pre_n: int, post_n: int, thresh: float):
    """The C4 proposal layer: decode and clip every anchor, drop those centred
    on padding, take the top ``pre_n`` by score, greedy NMS, keep ``post_n``
    → (rois (B, post_n, 4), scores, valid); padding rois are zero boxes."""
    boxes = clip_boxes(bbox_transform_inv(anchors, deltas), im_info[:, :2])
    scores = torch.where(anchor_centre_inside(anchors, im_info), scores, NEG_INF)
    top_s, top_i = topk_desc(scores, min(pre_n, scores.shape[1]))
    top_b = torch.take_along_dim(boxes, top_i[..., None], dim=1)
    return _nms_rois(top_b, top_s, thresh, post_n)


def _nms_rois(top_b, top_s, thresh, post_n):
    keep_i, keep_v = nms_select(top_b, top_s, thresh, post_n, top_s > NEG_INF / 2,
                                presorted=True)
    rois = torch.take_along_dim(top_b, keep_i[..., None], dim=1)
    roi_s = torch.where(keep_v, torch.take_along_dim(top_s, keep_i, dim=1), 0.0)
    return torch.where(keep_v[..., None], rois, 0.0), roi_s, keep_v


def propose_levels(fg_amajor, box_cells, sizes, a_n, anchors, im_info, per: int, post_n: int,
                   thresh: float):
    """The FPN proposal layer: per level the top ``per`` anchors by score
    (A-major order within the level), decode, clip, drop anchors centred on
    padding, one descending sort over all levels, one greedy NMS."""
    b = fg_amajor.shape[0]
    sel, sel_s, sel_d, off = [], [], [], 0
    for s, cells in zip(sizes, box_cells):
        hw = s // a_n
        lvl = fg_amajor[:, off:off + s]
        if per >= s:
            sc, idx = lvl, torch.arange(s, device=lvl.device).expand(b, s)
        else:
            sc, idx = topk_desc(lvl, per)
        a = torch.div(idx, hw, rounding_mode="floor")
        cell = idx - a * hw
        sel.append(cell * a_n + a + off)
        rows = torch.take_along_dim(cells, cell[..., None], dim=1).reshape(b, -1, a_n, 4)
        sel_d.append(torch.take_along_dim(rows, a[..., None, None], dim=2)[:, :, 0])
        sel_s.append(sc)
        off += s
    sel, sel_s, sel_d = torch.cat(sel, 1), torch.cat(sel_s, 1), torch.cat(sel_d, 1)
    sel_a = anchors[sel]
    boxes = clip_boxes(bbox_transform_inv(sel_a, sel_d), im_info[:, :2])
    scores = torch.where(anchor_centre_inside(sel_a, im_info), sel_s, NEG_INF)
    top_s, top_i = torch.sort(scores, dim=1, descending=True, stable=True)
    top_b = torch.take_along_dim(boxes, top_i[..., None], dim=1)
    return _nms_rois(top_b, top_s, thresh, post_n)


# -- detections ---------------------------------------------------------------

def postprocess(rois, roi_valid, cls_prob, bbox_pred, im_info, c: dict, num_classes: int,
                max_per_image: int):
    """Decode per class, clip, rescale to original image coordinates,
    per-class score threshold and NMS, then the top ``max_per_image`` over
    the foreground classes → (dets (B, D, 6) [x1, y1, x2, y2, score, class],
    valid (B, D))."""
    stds = torch.tensor(c["TRAIN.BBOX_NORMALIZE_STDS"], device=rois.device).repeat(num_classes)
    means = torch.tensor(c["TRAIN.BBOX_NORMALIZE_MEANS"], device=rois.device).repeat(num_classes)
    boxes = clip_boxes(bbox_transform_inv(rois, bbox_pred * stds + means), im_info[:, :2])
    boxes = boxes / im_info[:, 2][:, None, None]
    b, n, nc = cls_prob.shape
    d = max_per_image
    cls_boxes = boxes.reshape(b, n, nc, 4).permute(0, 2, 1, 3).reshape(b * nc, n, 4)
    cls_scores = cls_prob.permute(0, 2, 1).reshape(b * nc, n)
    valid = (roi_valid[:, None, :] & (cls_prob.permute(0, 2, 1) > const(c["TEST.SCORE_THRESH"],
                                                                        cls_prob)))
    per_cls = min(d, n)
    idx, keep = nms_select(cls_boxes, cls_scores, c["TEST.NMS"], per_cls, valid.reshape(b * nc, n))
    g_boxes = torch.take_along_dim(cls_boxes, idx[..., None], dim=1)
    g_scores = torch.where(keep, torch.take_along_dim(cls_scores, idx, dim=1), -1.0)
    cls_ids = torch.arange(nc, dtype=torch.float32, device=rois.device)[None, :, None]
    cls_ids = cls_ids.expand(b, nc, per_cls)
    g_scores = torch.where(cls_ids > 0, g_scores.reshape(b, nc, per_cls), -1.0)
    top_s, top_i = torch.sort(g_scores.reshape(b, -1), dim=1, descending=True, stable=True)
    top_s, top_i = top_s[:, :d], top_i[:, :d]
    det_valid = top_s > 0
    det = torch.cat([torch.take_along_dim(g_boxes.reshape(b, -1, 4), top_i[..., None], dim=1),
                     top_s[..., None],
                     torch.take_along_dim(cls_ids.reshape(b, -1), top_i, dim=1)[..., None]], 2)
    return torch.where(det_valid[..., None], det, 0.0), det_valid


# -- training targets ---------------------------------------------------------

def _f32(v, like):
    return const(v, like)


def _subsample(mask, max_quota: int, quota, uniform):
    """min(quota, sum(mask)) True entries of each row sampled without
    replacement by priority 1 + uniform → (indices (B, max_quota), live)."""
    n = mask.shape[-1]
    ramp = torch.arange(n, dtype=torch.float32, device=mask.device) * 2.0 ** -17
    vals, idx = topk_desc(torch.where(mask, 1.0 + uniform, -1.0 - ramp), max_quota)
    quota = torch.as_tensor(quota, device=mask.device).reshape(-1, 1)
    return idx, (torch.arange(max_quota, device=mask.device) < quota) & (vals > 0.0)


def anchor_targets(anchors, gt_boxes, gt_valid, im_info, u_fg, u_bg, c: dict):
    """RPN targets in the sampled-rows form: (sel (B, S), labels (B, S) in
    {1, 0, -1}, bbox targets (B, S, 4), inside weights (B, S, 4), outside
    weights (B, S, 1)); fg slots first."""
    dev = anchors.device
    inside = ((anchors[:, 0] >= 0) & (anchors[:, 1] >= 0)
              & (anchors[:, 2] < im_info[:, 1:2]) & (anchors[:, 3] < im_info[:, 0:1]))
    ov = box_iou(anchors.float(), gt_boxes.float())                       # (B, K, G)
    ov = torch.where(gt_valid[:, None, :], ov, -1.0)
    ov = torch.where(inside[:, :, None], ov, -1.0)
    max_ov, argmax = ov.max(dim=2)
    gt_max = ov.max(dim=1, keepdim=True).values
    is_gt_argmax = ((ov == gt_max) & (gt_max > 0) & gt_valid[:, None, :]).any(dim=2)
    neg = max_ov < _f32(c["TRAIN.RPN_NEGATIVE_OVERLAP"], anchors)
    pos = is_gt_argmax | (max_ov >= _f32(c["TRAIN.RPN_POSITIVE_OVERLAP"], anchors))
    labels0 = torch.full(inside.shape, -1, dtype=torch.int32, device=dev)
    order = [(inside & neg, 0), (inside & pos, 1)]
    if c["TRAIN.RPN_CLOBBER_POSITIVES"]:
        order.reverse()
    for cond, value in order:
        labels0 = torch.where(cond, value, labels0)

    batch = c["TRAIN.RPN_BATCHSIZE"]
    num_fg = int(c["TRAIN.RPN_FG_FRACTION"] * batch)
    fg_mask, bg_mask = labels0 == 1, labels0 == 0
    fg_idx, fg_take = _subsample(fg_mask, num_fg, num_fg, u_fg)
    n_fg = torch.clamp(fg_mask.sum(-1), max=num_fg)
    bg_idx, bg_take = _subsample(bg_mask, batch, batch - n_fg, u_bg)
    sel = torch.cat([fg_idx, bg_idx], -1)
    live = torch.cat([fg_take, bg_take], -1)
    is_fg_slot = torch.arange(sel.shape[1], device=dev) < num_fg
    labels = torch.where(live, is_fg_slot.to(torch.int32), -1).to(torch.int32)
    matched = torch.take_along_dim(gt_boxes, torch.take_along_dim(argmax, sel, 1)[..., None], 1)
    fg_rows = (labels == 1)[..., None]
    targets = torch.where(fg_rows, bbox_transform(anchors[sel], matched), 0.0)
    in_w = torch.where(fg_rows, torch.tensor(c["TRAIN.BBOX_INSIDE_WEIGHTS"], device=dev), 0.0)
    pw = c["TRAIN.RPN_POSITIVE_WEIGHT"]
    if pw < 0:
        n_ex = torch.clamp(live.sum(-1), min=1).float()[:, None, None]
        out_w = torch.where((labels >= 0)[..., None], torch.ones_like(n_ex) / n_ex, 0.0)
    else:
        pos_w = _f32(pw, anchors) / torch.clamp((labels == 1).sum(-1), min=1)
        neg_w = _f32(1.0 - pw, anchors) / torch.clamp((labels == 0).sum(-1), min=1)
        out_w = torch.where((labels == 1)[..., None], pos_w[:, None, None], 0.0)
        out_w = torch.where((labels == 0)[..., None], neg_w[:, None, None], out_w)
    return sel, labels, targets, in_w, out_w.to(targets.dtype)


def _rank_by_priority(mask, uniform):
    n = mask.shape[-1]
    order = torch.argsort(-torch.where(mask, uniform, -1.0), dim=-1, stable=True)
    arange = torch.arange(n, device=mask.device).expand_as(order)
    rank = torch.empty_like(order).scatter_(-1, order, arange)
    return torch.where(mask, rank, n)


def proposal_targets(rois, roi_valid, gt_boxes, gt_labels, gt_valid, u_fg, u_bg, c: dict,
                     num_classes: int):
    """RoI-head targets: (rois (B, BATCH, 4), labels (B, BATCH), bbox
    targets, inside and outside weights (B, BATCH, 4C)); fg first, the
    slots repeating the selection cyclically where it is short."""
    batch = c["TRAIN.BATCH_SIZE"]
    dev = rois.device
    all_rois = torch.cat([rois, gt_boxes], 1)
    all_valid = torch.cat([roi_valid, gt_valid], 1)
    n = all_rois.shape[1]
    ov = box_iou(all_rois, gt_boxes)
    ov = torch.where(gt_valid[:, None, :], ov, -1.0)
    ov = torch.where(all_valid[:, :, None], ov, -1.0)
    max_ov, argmax = ov.max(dim=2)
    roi_label = torch.take_along_dim(gt_labels, argmax, 1).to(torch.int32)
    fg = all_valid & (max_ov >= _f32(c["TRAIN.FG_THRESH"], rois))
    bg = (all_valid & (max_ov < _f32(c["TRAIN.BG_THRESH_HI"], rois))
          & (max_ov >= _f32(c["TRAIN.BG_THRESH_LO"], rois)))
    bg = bg | (~(fg | bg).any(dim=1, keepdim=True) & all_valid)
    fg_rank = _rank_by_priority(fg, u_fg)
    fg_sel = fg & (fg_rank < int(round(c["TRAIN.FG_FRACTION"] * batch)))
    n_fg = fg_sel.sum(1, keepdim=True)
    bg_rank = _rank_by_priority(bg, u_bg)
    bg_sel = bg & (bg_rank < batch - n_fg)
    arange = torch.arange(n, device=dev)
    key = torch.where(fg_sel, fg_rank, n + bg_rank)
    key = torch.where(fg_sel | bg_sel, key, 2 * n + arange)
    order = torch.argsort(key, dim=1, stable=True)
    n_sel = torch.clamp(n_fg + bg_sel.sum(1, keepdim=True), min=1)
    sel = torch.take_along_dim(order, torch.arange(batch, device=dev)[None] % n_sel, 1)
    out_rois = torch.take_along_dim(all_rois, sel[..., None], 1)
    is_fg = torch.take_along_dim(fg_sel, sel, 1)
    labels = torch.where(is_fg, torch.take_along_dim(roi_label, sel, 1), 0).to(torch.int32)
    matched = torch.take_along_dim(gt_boxes, torch.take_along_dim(argmax, sel, 1)[..., None], 1)
    targets = bbox_transform(out_rois, matched)
    if c["TRAIN.BBOX_NORMALIZE_TARGETS_PRECOMPUTED"]:
        targets = ((targets - torch.tensor(c["TRAIN.BBOX_NORMALIZE_MEANS"], device=dev))
                   / torch.tensor(c["TRAIN.BBOX_NORMALIZE_STDS"], device=dev))
    targets = torch.where(is_fg[..., None], targets, 0.0)
    b = rois.shape[0]
    onehot = F.one_hot(labels.long(), num_classes).to(targets.dtype)
    expanded = (onehot[..., None] * targets[:, :, None, :]).reshape(b, batch, 4 * num_classes)
    inside = torch.tensor(c["TRAIN.BBOX_INSIDE_WEIGHTS"], device=dev)
    in_w = (onehot[..., None] * (is_fg[..., None, None] * inside)).reshape(b, batch,
                                                                           4 * num_classes)
    return out_rois, labels, expanded, in_w, (in_w > 0).to(targets.dtype)


# -- losses -------------------------------------------------------------------

def _huber(diff, sigma2: float):
    a = diff.abs()
    return torch.where(a < 1.0 / sigma2, 0.5 * sigma2 * diff * diff, a - 0.5 / sigma2)


def _ce(logits, labels, weight=None):
    ce = F.cross_entropy(logits.transpose(1, 2), labels.long().clamp(min=0), reduction="none")
    if weight is None:
        return ce.mean(dim=1)
    return (ce * weight).sum(1) / torch.clamp(weight.sum(1), min=1.0)


def detection_losses(rpn_cls_rows, rpn_box_rows, at, cls_logits, bbox_pred, pt):
    """The four losses, batch means: RPN cross-entropy and smooth-L1 (sigma
    3) over the sampled anchor rows, RoI cross-entropy and smooth-L1 (sigma
    1) over the sampled rois; ``total_loss`` their sum."""
    _, labels, targets, in_w, out_w = at
    rpn_ce = _ce(rpn_cls_rows, labels, (labels >= 0).float())
    rpn_box = (out_w * _huber(in_w * (rpn_box_rows - targets), 9.0)).flatten(1).sum(1)
    _, r_labels, r_targets, r_in, r_out = pt
    ce = _ce(cls_logits, r_labels)
    box = (r_out * _huber(r_in * (bbox_pred - r_targets), 1.0)).sum(-1).mean(1)
    per = {"rpn_cross_entropy": rpn_ce, "rpn_loss_box": rpn_box, "cross_entropy": ce,
           "loss_box": box, "total_loss": rpn_ce + rpn_box + ce + box}
    return {k: v.mean() for k, v in per.items()}
