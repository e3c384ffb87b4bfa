"""ctypes binding of the staging fill (``native/stage_fill.cc``): a host
batch copied into a page-locked block by the calling thread and a pool of
helper threads that claim small pieces in order, so a helper that is slow
to wake holds up nothing (``engine/graphs.stage`` enqueues each chunk's copy
to the card as soon as ``filling``'s wait says its bytes are in).

The pool has ``torch.get_num_threads() - 1`` helpers, started at the first
fill of a process.  The library is built with ``g++`` at that fill
(``native/build.py``); a machine that builds the kernels has it, since
``nvcc`` compiles their host code with it.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import threading

import torch

from frcnn_tpu_torch.native.build import build_library

_P, _N = ctypes.c_void_p, ctypes.c_int64
# restype and argtypes of the extern "C" functions of stage_fill.cc
_SIGNATURES = {
    "frcnn_stage_pool": (_P, (ctypes.c_int,)),
    "frcnn_stage_begin": (None, (_P, _P, _P, _N)),
    "frcnn_stage_wait": (ctypes.c_int, (_P, _N)),
}

_lock = threading.Lock()
_lib = None
_pools: dict = {}             # pid -> (pool handle, its lock): a forked child makes its own


def _pool():
    """This process's (pool handle, lock), the library built and loaded at
    the first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library("stage_fill"))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, list(argtypes)
            _lib = lib
        if os.getpid() not in _pools:
            _pools[os.getpid()] = (_lib.frcnn_stage_pool(max(torch.get_num_threads() - 1, 0)),
                                   threading.Lock())
        return _pools[os.getpid()]


@contextlib.contextmanager
def filling(block, src):
    """Copy the bytes of ``src`` into the start of ``block`` (contiguous
    uint8 CPU tensors; on a card the block is page-locked) → ``fill(upto)``, which returns
    once bytes [0, upto) are in, helping with the copy until then.  The copy
    is whole when the block exits."""
    n = src.numel()
    if not all(t.dtype == torch.uint8 and t.device.type == "cpu" and t.is_contiguous()
               for t in (src, block)) or block.numel() < n:
        raise ValueError(f"filling takes contiguous uint8 CPU tensors, a block of at least "
                         f"the source's bytes: {n} into {block.numel()}")
    handle, lock = _pool()
    with lock:
        _lib.frcnn_stage_begin(handle, block.data_ptr(), src.data_ptr(), n)
        try:
            yield lambda upto: _lib.frcnn_stage_wait(handle, min(upto, n))
        finally:
            _lib.frcnn_stage_wait(handle, n)
