"""ctypes bindings of the C++ host ops (``native/host_ops.cc``), with numpy
fallbacks (``frcnn_tpu/native/host_ops.py``): ``nms_cpu`` and
``bbox_overlaps_cpu`` for host-side consumers (``engine.test.apply_nms``,
``tools/reval.py``, ``tools/demo.py``).  The card's path never comes here.

The library is built with ``g++`` at first use (``native/build.py``).  Where
that or loading it fails, the numpy fallback runs, announced once by a loud
line on stderr: it is correct but slower, and a silent switch would hide a
broken build.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import threading

import numpy as np

from frcnn_tpu_torch.native.build import build_library

_FP, _LP = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64)
# restype and argtypes of the extern "C" functions of host_ops.cc
_SIGNATURES = {
    "frcnn_nms": (ctypes.c_int, (_FP, ctypes.c_int64, ctypes.c_float, ctypes.c_int, _LP)),
    "frcnn_bbox_overlaps": (None, (_FP, ctypes.c_int64, _FP, ctypes.c_int64, _FP)),
}

_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    with _lock:             # the prefetch and prep threads may ask first
        return _load_once()


def _load_once():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(build_library("host_ops"))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, list(argtypes)
        _lib = lib
    except (OSError, subprocess.SubprocessError) as e:
        print(f"frcnn_tpu_torch.native.host_ops: C++ library unavailable (g++ build or dlopen "
              f"failed: {e}) — using the numpy fallback", file=sys.stderr)
    return _lib


def have_native() -> bool:
    return _load() is not None


def nms_cpu(dets, thresh: float):
    """Greedy NMS on (N, 5) [x1, y1, x2, y2, score] → kept indices (int64,
    score order; ties keep index order)."""
    dets = np.ascontiguousarray(dets, dtype=np.float32)
    if dets.ndim != 2 or dets.shape[1] != 5:
        raise ValueError(f"nms_cpu takes (N, 5) detections, got {dets.shape}")
    n = dets.shape[0]
    if n == 0:
        return np.zeros(0, np.int64)
    lib = _load()
    if lib is not None:
        keep = np.zeros(n, np.int64)
        cnt = lib.frcnn_nms(dets.ctypes.data_as(_FP), n, ctypes.c_float(thresh), 0,
                            keep.ctypes.data_as(_LP))
        return keep[:cnt]
    return nms_numpy(dets, thresh)


def nms_numpy(dets, thresh: float):
    """The numpy fallback of ``nms_cpu`` (the classic greedy loop)."""
    x1, y1, x2, y2, scores = np.asarray(dets, np.float32).T
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    # descending and stable: equal scores keep their index order, as the library's stable_sort
    order = np.argsort(-scores, kind="stable")
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(np.float32(0.0), xx2 - xx1 + 1)
        h = np.maximum(np.float32(0.0), yy2 - yy1 + 1)
        inter = w * h
        ovr = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[np.where(ovr <= thresh)[0] + 1]
    return np.asarray(keep, np.int64)


def bbox_overlaps_cpu(boxes, query):
    """Pairwise IoU with inclusive corners, (N, 4) x (K, 4) → (N, K) float32."""
    boxes = np.ascontiguousarray(boxes, dtype=np.float32)
    query = np.ascontiguousarray(query, dtype=np.float32)
    if boxes.ndim != 2 or boxes.shape[1] != 4 or query.ndim != 2 or query.shape[1] != 4:
        raise ValueError(f"bbox_overlaps_cpu takes (N, 4) and (K, 4), got {boxes.shape}, "
                         f"{query.shape}")
    n, k = boxes.shape[0], query.shape[0]
    lib = _load()
    if lib is not None:
        out = np.zeros((n, k), np.float32)
        lib.frcnn_bbox_overlaps(boxes.ctypes.data_as(_FP), n, query.ctypes.data_as(_FP), k,
                                out.ctypes.data_as(_FP))
        return out
    return bbox_overlaps_numpy(boxes, query)


def bbox_overlaps_numpy(boxes, query):
    """The numpy fallback of ``bbox_overlaps_cpu``."""
    boxes = np.asarray(boxes, np.float32)
    query = np.asarray(query, np.float32)
    bx, qx = boxes[:, None, :], query[None, :, :]
    iw = np.minimum(bx[..., 2], qx[..., 2]) - np.maximum(bx[..., 0], qx[..., 0]) + 1
    ih = np.minimum(bx[..., 3], qx[..., 3]) - np.maximum(bx[..., 1], qx[..., 1]) + 1
    iw, ih = np.maximum(iw, 0), np.maximum(ih, 0)
    inter = iw * ih
    ab = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
    aq = (query[:, 2] - query[:, 0] + 1) * (query[:, 3] - query[:, 1] + 1)
    union = ab[:, None] + aq[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(inter > 0, inter / union, 0.0).astype(np.float32)
