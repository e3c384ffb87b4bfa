"""The lineage's image preparation and minibatch order, in plain numpy, for
the benchmark's reference: the scale and bucket of an image, the bilinear
resize with ``cv2.resize``'s sampling (INTER_LINEAR, no antialiasing),
zero padding into a bucket, the shuffled order of the training data layer
(orientation-pure batches), and a training batch built from the roidb and
the decoded images (a cache of resized images rounds them to uint8 and
flips the resized view; the decoding route flips, then resizes in float32).

This file imports nothing of the system under test.
"""

from __future__ import annotations

import numpy as np


def scale_and_bucket(h: int, w: int, target: int, max_size: int, buckets):
    """The resize factor (short side to ``target``, long side at most
    ``max_size``) and the smallest bucket holding the scaled image; else
    the bucket that loses the least, with the scale reduced to fit."""
    scale = float(target) / float(min(h, w))
    if np.round(scale * max(h, w)) > max_size:
        scale = float(max_size) / float(max(h, w))
    sh, sw = int(np.round(h * scale)), int(np.round(w * scale))
    for bh, bw in sorted(buckets, key=lambda b: b[0] * b[1]):
        if sh <= bh and sw <= bw:
            return scale, (bh, bw)
    bh, bw = max(buckets, key=lambda b: min(b[0] / sh, b[1] / sw))
    return scale * min(bh / sh, bw / sw), (bh, bw)


def _taps(n_out: int, n_in: int, scale: float):
    src = ((np.arange(n_out) + 0.5) * (1.0 / scale) - 0.5).astype(np.float32)
    lo = np.floor(src).astype(np.int64)
    frac = (src - lo).astype(np.float32)
    frac[lo < 0], lo[lo < 0] = 0.0, 0
    edge = lo >= n_in - 1
    frac[edge], lo[edge] = 0.0, n_in - 1
    return lo, np.minimum(lo + 1, n_in - 1), frac


def resize(im, scale: float):
    """(H, W, C) → (round(H * scale), round(W * scale), C) float32."""
    h, w = im.shape[:2]
    oh, ow = int(round(h * scale)), int(round(w * scale))
    src = im.astype(np.float32)
    if (oh, ow) == (h, w) and scale == 1.0:
        return src
    y0, y1, fy = _taps(oh, h, scale)
    x0, x1, fx = _taps(ow, w, scale)
    rows = src[y0] * (1.0 - fy)[:, None, None] + src[y1] * fy[:, None, None]
    return rows[:, x0] * (1.0 - fx)[None, :, None] + rows[:, x1] * fx[None, :, None]


def to_uint8(x):
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


def prep(im, target: int, max_size: int, buckets, keep_uint8: bool = False):
    """One BGR image resized into its bucket and zero-padded → (blob
    (bh, bw, 3), im_info [round(h s), round(w s), s] float32)."""
    h, w = im.shape[:2]
    scale, (bh, bw) = scale_and_bucket(h, w, target, max_size, buckets)
    r = resize(im, scale)
    if keep_uint8:
        r = to_uint8(r)
    out = np.zeros((bh, bw, 3), r.dtype)
    rh, rw = min(r.shape[0], bh), min(r.shape[1], bw)
    out[:rh, :rw] = r[:rh, :rw]
    info = np.array([np.round(h * scale), np.round(w * scale), scale], np.float32)
    return out, info


def snap(hws, buckets):
    """The smallest bucket covering every (h, w); the componentwise max of
    the buckets where none does."""
    nh, nw = max(h for h, _ in hws), max(w for _, w in hws)
    fit = [b for b in buckets if b[0] >= nh and b[1] >= nw]
    if fit:
        return min(fit, key=lambda b: (b[0] * b[1], b))
    return max(b[0] for b in buckets), max(b[1] for b in buckets)


def batch_order(roidb, batch: int, seed: int, buckets):
    """The data layer's first permutation of the roidb, seeded with the
    configuration's RNG_SEED: with batches of several images and two bucket
    orientations, landscape and portrait entries are each shuffled and cut
    into full batches, the full batches shuffled, the partial tails last."""
    rng = np.random.RandomState(seed)
    if batch > 1 and len(buckets) > 1:
        horz = np.array([r["width"] for r in roidb]) >= np.array([r["height"] for r in roidb])
        groups, partial = [], []
        for inds in (np.where(horz)[0], np.where(~horz)[0]):
            inds = rng.permutation(inds)
            for i in range(0, len(inds), batch):
                g = inds[i:i + batch]
                (groups if len(g) == batch else partial).append(g)
        order = rng.permutation(len(groups))
        return np.concatenate([groups[i] for i in order] + partial)
    return rng.permutation(len(roidb))


def train_batch(entries, images, c: dict, cached: bool):
    """A training batch of roidb ``entries`` over the decoded ``images``
    (path → BGR uint8): (data (B, bh, bw, 3), im_info (B, 3), gt_boxes
    (B, MAX_GT, 4), gt_labels (B, MAX_GT), gt_valid (B, MAX_GT)).  The
    target scale is TRAIN.SCALES[0] (one scale)."""
    target, max_size, buckets = c["TRAIN.SCALES"][0], c["TRAIN.MAX_SIZE"], c["DEVICE.BUCKETS"]
    views, scales = [], []
    for e in entries:
        im = images[e["image"]]
        h, w = im.shape[:2]
        scale, _ = scale_and_bucket(h, w, target, max_size, buckets)
        if cached:
            v = to_uint8(resize(im, scale))
            v = v[:, ::-1] if e.get("flipped", False) else v
        else:
            v = resize(im[:, ::-1] if e.get("flipped", False) else im, scale)
        views.append(v)
        scales.append(scale)
    if cached:
        bh, bw = snap([v.shape[:2] for v in views], buckets)
    else:
        bh, bw = snap([scale_and_bucket(e["height"], e["width"], target, max_size, buckets)[1]
                       for e in entries], buckets)
    data = np.zeros((len(entries), bh, bw, 3), np.uint8 if cached else np.float32)
    for blob, v in zip(data, views):
        blob[:min(v.shape[0], bh), :min(v.shape[1], bw)] = v[:bh, :bw]
    infos = np.array([[np.round(e["height"] * s), np.round(e["width"] * s), s]
                      for e, s in zip(entries, scales)], np.float32)
    g = c["DEVICE.MAX_GT"]
    gtb = np.zeros((len(entries), g, 4), np.float32)
    gtl = np.zeros((len(entries), g), np.int32)
    gtv = np.zeros((len(entries), g), bool)
    for i, (e, s) in enumerate(zip(entries, scales)):
        keep = np.where(e["gt_classes"] > 0)[0][:g]
        gtb[i, :len(keep)] = e["boxes"][keep].astype(np.float32) * s
        gtl[i, :len(keep)] = e["gt_classes"][keep]
        gtv[i, :len(keep)] = True
    return data, infos, gtb, gtl, gtv
