"""Dataset box utilities (``frcnn_tpu/data/ds_utils.py``)."""

from __future__ import annotations

import numpy as np


def unique_boxes(boxes, scale: float = 1.0):
    """Indices of unique boxes (a hash of the scaled, rounded coordinates)."""
    v = np.array([1, 1e3, 1e6, 1e9])
    hashes = np.round(boxes * scale).dot(v)
    _, index = np.unique(hashes, return_index=True)
    return np.sort(index)


def xywh_to_xyxy(boxes):
    """(x, y, w, h) → (x1, y1, x2, y2) inclusive corners."""
    return np.hstack((boxes[:, 0:2], boxes[:, 0:2] + boxes[:, 2:4] - 1))


def xyxy_to_xywh(boxes):
    return np.hstack((boxes[:, 0:2], boxes[:, 2:4] - boxes[:, 0:2] + 1))


def validate_boxes(boxes, width: int = 0, height: int = 0):
    """Raise ValueError on a box outside [0, width) x [0, height) or with
    x2 < x1 or y2 < y1."""
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    for ok, what in (((x1 >= 0).all(), "negative x1"), ((y1 >= 0).all(), "negative y1"),
                     ((x2 >= x1).all(), "x2 < x1"), ((y2 >= y1).all(), "y2 < y1"),
                     ((x2 < width).all(), "x2 >= width"), ((y2 < height).all(), "y2 >= height")):
        if not ok:
            raise ValueError(what)


def filter_small_boxes(boxes, min_size: float):
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    return np.where((w >= min_size) & (h >= min_size))[0]
