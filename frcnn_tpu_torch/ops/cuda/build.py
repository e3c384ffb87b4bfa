"""Build and load the hand-written CUDA kernels.

Every ``frcnn_tpu_torch/csrc/*.cu`` file is compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` per source, all started together, and the
objects are linked into ONE shared library with a plain C interface, at
first use, into ``frcnn_tpu_torch/_build/`` (git-ignored), and loaded with
``ctypes``.  The library name carries a hash of the sources and flags, so an
edited kernel is rebuilt and a stale library is never loaded.  No PyTorch
header is compiled: a build takes seconds, not minutes.

Each wrapper counts its launches in ``LAUNCH_COUNTS``: a run can then show
that the main path really went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCH_COUNTS: collections.Counter = collections.Counter()

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signatures of the extern "C" launchers, the stream last (each returns a
# cudaError_t).
_SIGNATURES = {
    "frcnn_nms_batched": (_P, _P, _I, _I, _F, _I, _I, _I, _I, _P, _P),
    "frcnn_roi_align_fwd": (_P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P, _P),
    "frcnn_roi_align_bwd": (_P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _I,
                            _I, _P, _P),
    "frcnn_roi_align_ml_fwd": (_P, _P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P),
    "frcnn_roi_align_ml_bwd": (_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                               _I, _I, _I, _P, _P),
    "frcnn_fused_bottleneck": (_P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                               _P, _P, _P, _P, _P),
    "frcnn_anchor_overlap_stats": (_P, _I, _P, _P, _I, _I, _P, _I, _I, _I, _I, _P, _P, _P, _P),
    "frcnn_topk_threshold": (_P, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    "frcnn_bn_epilogue": (_P, _L, _I, _P, _P, _P, _P, _F, _P, _I, _P, _P, _P, _P, _F, _I, _I, _I,
                          _P, _P),
    "frcnn_fpn_epilogue": (_P, _I, _I, _I, _I, _P, _P, _I, _I, _I, _I, _I, _P, _P),
}

_lock = threading.Lock()
_lib = None
BUILD_LOG = ""     # nvcc's output (ptxas register/spill report) of the last build
BUILD_SECONDS = 0.0


def reset_launch_counts() -> None:
    LAUNCH_COUNTS.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library():
    """The loaded kernel library, built on first call."""
    global _lib, BUILD_LOG, BUILD_SECONDS
    with _lock:
        if _lib is not None:
            return _lib
        import time

        sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
        digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
        for src in sources:
            with open(src, "rb") as f:
                digest.update(f.read())
        os.makedirs(BUILD_DIR, exist_ok=True)
        path = os.path.join(BUILD_DIR, f"libfrcnn_kernels_{digest.hexdigest()[:16]}.so")
        if not os.path.exists(path):
            t0 = time.perf_counter()
            tmp = f"{path}.{os.getpid()}.tmp"
            nvcc = _nvcc()
            objs = [f"{tmp}.{os.path.basename(src)}.o" for src in sources]
            procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
                     for src, obj in zip(sources, objs)]
            logs = [proc.communicate()[0] for proc in procs]
            BUILD_LOG = "".join(logs)
            failed = [src for src, proc in zip(sources, procs) if proc.returncode != 0]
            if not failed:
                link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                                      capture_output=True, text=True)
                BUILD_LOG += link.stdout + link.stderr
                if link.returncode != 0:
                    failed = ["link"]
            for obj in objs:
                if os.path.exists(obj):
                    os.remove(obj)
            if failed:
                raise RuntimeError(f"nvcc failed for {failed}:\n{BUILD_LOG}")
            os.replace(tmp, path)
            BUILD_SECONDS = time.perf_counter() - t0
        lib = ctypes.CDLL(path)
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
        lib.frcnn_error_string.argtypes = [ctypes.c_int]
        lib.frcnn_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def launch(name: str, *args) -> None:
    """Call launcher ``name`` on the current stream; raise on a CUDA error.

    The launch is asynchronous.  Tensors whose pointers were passed may be
    freed when the caller returns: PyTorch's caching allocator hands their
    memory out again only in the order of this stream."""
    import torch

    lib = library()
    stream = torch.cuda.current_stream().cuda_stream
    fn = getattr(lib, name)
    if len(args) + 1 != len(fn.argtypes):
        raise TypeError(f"{name}: {len(args)} arguments + stream, C signature has "
                        f"{len(fn.argtypes)}")
    err = fn(*args, stream)
    if err != 0:
        msg = lib.frcnn_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def check_cuda(name: str, t, dtype=None, shape=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor on the current card, of
    the given dtype/shape, whose data pointer is 32-byte aligned (vector
    loads, wmma tiles).  ``launch`` runs on the current card's stream: a
    tensor of another card would be read through pointers of another
    context."""
    import torch

    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    current = torch.cuda.current_device()
    if t.device.index != current:
        raise ValueError(f"{name}: the tensor lies on {t.device} but the current card is "
                         f"cuda:{current}: the kernel would launch there "
                         "(torch.cuda.set_device, or torch.cuda.device(...))")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 32:
        raise ValueError(f"{name}: data pointer is not 32-byte aligned")
