"""ctypes binding of the native minibatch image prep (``native/data_prep.cc``,
``frcnn_tpu/native/data_prep.py``): decode, flip, f32 resize and zero-pad a
batch on a C++ thread pool, off the GIL.

The library is built with ``g++`` against the system OpenCV (the three
modules of ``pkg-config opencv4`` it uses: core, imgcodecs, imgproc) at first
use (``native/build.py``).  Where the dev files or the compiler are missing,
``prep_batch`` returns None, announced once by a loud line on stderr, and the
callers (``data.loader.get_minibatch``, ``engine.test.test_net``) keep their
Python route.  The two routes agree within rtol 1e-4, atol 0.05; a run takes
one route throughout, so an exact resume holds.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import threading

import numpy as np

from frcnn_tpu_torch.native.build import build_library

_IP, _FP = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float)
# restype and argtypes of the extern "C" function of data_prep.cc
_SIGNATURES = {
    "frcnn_prep_batch": (ctypes.c_int, (ctypes.POINTER(ctypes.c_char_p), _IP, _FP, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int, _FP, _IP, ctypes.c_int)),
}
OPENCV_LIBS = ("-lopencv_core", "-lopencv_imgcodecs", "-lopencv_imgproc")

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
        flags = subprocess.run(["pkg-config", "--cflags", "--libs", "opencv4"], check=True,
                               capture_output=True, text=True, timeout=30).stdout.split()
        # the three modules used: opencv4's whole link line drags in dozens more
        flags = [f for f in flags if not f.startswith("-l")]
        lib = ctypes.CDLL(build_library("data_prep", flags, OPENCV_LIBS))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, list(argtypes)
        _lib = lib
    except (OSError, subprocess.SubprocessError) as e:
        print(f"frcnn_tpu_torch.native.data_prep: C++ prep unavailable (system OpenCV dev files "
              f"or g++ missing, or dlopen failed: {e}) — using the Python route", file=sys.stderr)
    return _lib


def have_native() -> bool:
    return _load() is not None


def prep_batch(paths, flips, scales, bucket_hw, n_threads: int = 0):
    """Decode, flip, f32-resize and zero-pad ``len(paths)`` images into one
    (N, bh, bw, 3) float32 BGR blob on the C++ thread pool (``n_threads`` 0:
    one a core).  Returns (blob, dims (N, 2) resized (h, w)), or None when
    the library is unavailable; raises ``IOError`` naming an image that
    does not decode or does not fit the bucket."""
    n = len(paths)
    if len(flips) != n or len(scales) != n:
        raise ValueError(f"prep_batch: {n} paths, {len(flips)} flips, {len(scales)} scales")
    lib = _load()
    if lib is None:
        return None
    bh, bw = bucket_hw
    out = np.empty((n, bh, bw, 3), np.float32)
    dims = np.zeros((n, 2), np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    c_flips = np.ascontiguousarray(flips, np.int32)
    c_scales = np.ascontiguousarray(scales, np.float32)
    rc = lib.frcnn_prep_batch(c_paths, c_flips.ctypes.data_as(_IP), c_scales.ctypes.data_as(_FP),
                              n, bh, bw, out.ctypes.data_as(_FP), dims.ctypes.data_as(_IP),
                              n_threads)
    if rc != 0:
        raise IOError(f"native prep failed to read {paths[-1 - rc]}")
    return out, dims
