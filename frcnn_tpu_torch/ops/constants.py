"""Tensors of host values on a device, made once.

``torch.tensor(values, device=cuda)`` copies from pageable host memory and
waits for the copy: under CUDA graph capture the wait is illegal (the
capture fails), and eagerly it is a host round trip on every call.
``device_constant`` makes each (values, dtype, device) once, outside
inference mode (so autograd may save it for backward), and hands the same
tensor out afterwards.  A graph captured after the first, eager, call reads
it at a fixed address (``engine/graphs.py`` warms up before it captures).
Callers never write into it.
"""

from __future__ import annotations

import torch

_CACHE: dict = {}


def device_constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, made at the
    first call for these values and reused; raises if that first call comes
    under CUDA graph capture."""
    device = torch.device(device)
    key = (repr(values), dtype, device)
    t = _CACHE.get(key)
    if t is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"device constant {values!r} ({dtype}) first made under CUDA "
                               "graph capture: its host-to-device copy would wait on the "
                               "stream; run the function once eagerly before capturing it")
        with torch.inference_mode(False):
            t = torch.tensor(values, dtype=dtype, device=device)
        _CACHE[key] = t
    return t
