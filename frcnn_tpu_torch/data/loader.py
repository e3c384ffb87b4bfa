"""Image preparation for the test path (``frcnn_tpu/data/loader.py``:
``pick_scale_and_bucket`` and ``prep_im_for_blob``), without cv2.

The resize is bilinear in numpy with the sampling of
``cv2.resize(im, None, fx=scale, fy=scale, interpolation=INTER_LINEAR)``:
output size round(size * scale), source coordinate
(dst + 0.5) / scale - 0.5, clamped at the borders, no antialiasing.  The
tests bound the difference from cv2.
"""

from __future__ import annotations

import numpy as np


def pick_scale_and_bucket(h: int, w: int, target_size: int, max_size: int, buckets):
    """Resize factor (reference prep_im_for_blob math) + smallest bucket that
    holds the scaled image; else the bucket that loses the least
    resolution, with the scale reduced to fit."""
    im_size_min = min(h, w)
    im_size_max = max(h, w)
    scale = float(target_size) / float(im_size_min)
    if np.round(scale * im_size_max) > max_size:
        scale = float(max_size) / float(im_size_max)
    sh, sw = int(np.round(h * scale)), int(np.round(w * scale))
    for bh, bw in sorted(buckets, key=lambda b: b[0] * b[1]):
        if sh <= bh and sw <= bw:
            return scale, (bh, bw)
    bh, bw = max(buckets, key=lambda b: min(b[0] / sh, b[1] / sw))
    shrink = min(bh / sh, bw / sw)
    return scale * shrink, (bh, bw)


def _taps(n_out: int, n_in: int, scale: float):
    """Source indices (lo, hi) and the weight of hi for each output index."""
    src = ((np.arange(n_out) + 0.5) * (1.0 / scale) - 0.5).astype(np.float32)
    lo = np.floor(src).astype(np.int64)
    frac = (src - lo).astype(np.float32)
    frac[lo < 0] = 0.0
    lo[lo < 0] = 0
    edge = lo >= n_in - 1
    frac[edge] = 0.0
    lo[edge] = n_in - 1
    return lo, np.minimum(lo + 1, n_in - 1), frac


def resize_bilinear(im, scale: float):
    """(H, W, C) image → (round(H*scale), round(W*scale), C) float32."""
    h, w = im.shape[:2]
    oh, ow = int(round(h * scale)), int(round(w * scale))
    src = im.astype(np.float32)
    if (oh, ow) == (h, w) and scale == 1.0:
        return src
    y0, y1, fy = _taps(oh, h, scale)
    x0, x1, fx = _taps(ow, w, scale)
    rows = src[y0] * (1.0 - fy)[:, None, None] + src[y1] * fy[:, None, None]
    return rows[:, x0] * (1.0 - fx)[None, :, None] + rows[:, x1] * fx[None, :, None]


def prep_im_for_blob(im, target_size: int, max_size: int, buckets,
                     keep_uint8: bool = False):
    """Resize into a bucket and zero-pad.  Returns (padded (bh, bw, 3) BGR
    raw pixels, scale); mean subtraction happens in the model.  With
    ``keep_uint8`` the padded image is uint8 (rounded), else float32."""
    h, w = im.shape[:2]
    scale, (bh, bw) = pick_scale_and_bucket(h, w, target_size, max_size, buckets)
    resized = resize_bilinear(im, scale)
    dtype = np.uint8 if keep_uint8 and im.dtype == np.uint8 else np.float32
    if dtype == np.uint8:
        resized = np.clip(np.rint(resized), 0, 255)
    out = np.zeros((bh, bw, 3), dtype=dtype)
    rh, rw = min(resized.shape[0], bh), min(resized.shape[1], bw)
    out[:rh, :rw, :] = resized[:rh, :rw]
    return out, scale
