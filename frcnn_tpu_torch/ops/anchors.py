"""Anchor generation (``frcnn_tpu/ops/anchors.py``): the Caffe-rounded base
anchors, shifted over the feature grid.  Host numpy, exact."""

from __future__ import annotations

import numpy as np


def generate_anchors(base_size=16, ratios=(0.5, 1.0, 2.0), scales=(8.0, 16.0, 32.0)):
    """The len(ratios)*len(scales) base anchors, ratio-major rows, float32 (A, 4)."""
    ratios = np.asarray(ratios, dtype=np.float64)
    scales = np.asarray(scales, dtype=np.float64)
    center = (base_size - 1.0) / 2.0
    ratio_w = np.round(np.sqrt(base_size * base_size / ratios))
    ratio_h = np.round(ratio_w * ratios)
    w = (ratio_w[:, None] * scales[None, :]).reshape(-1)
    h = (ratio_h[:, None] * scales[None, :]).reshape(-1)
    anchors = np.stack([center - 0.5 * (w - 1.0), center - 0.5 * (h - 1.0),
                        center + 0.5 * (w - 1.0), center + 0.5 * (h - 1.0)],
                       axis=1)
    return anchors.astype(np.float32)


def generate_anchors_pre(height: int, width: int, feat_stride: int,
                         ratios=(0.5, 1.0, 2.0), scales=(8.0, 16.0, 32.0)):
    """Anchors over a (height, width) grid: row ``(y * width + x) * A + a``.
    Returns ``(anchors (height*width*A, 4) float32, count)``."""
    base = generate_anchors(feat_stride, ratios, scales)
    shift_x = np.arange(width, dtype=np.float32) * feat_stride
    shift_y = np.arange(height, dtype=np.float32) * feat_stride
    sx, sy = np.meshgrid(shift_x, shift_y)
    shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
    anchors = (base[None, :, :] + shifts).reshape(-1, 4)
    return anchors, anchors.shape[0]
