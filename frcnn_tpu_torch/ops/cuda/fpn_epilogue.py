"""The FPN epilogue: the bias of every biased convolution of the FPN neck
and of its RPN conv, with the neck's nearest 2x upsample and top-down add,
or the RPN conv's relu, as one pass — CUDA kernel wrapper and its plain twin.

Replaces no TPU kernel: XLA fuses these elementwise ops into the JAX
package's convolutions.  On the card cuDNN's convolution leaves its bias to
a separate broadcast add, the top-down path wrote an upsampled copy of the
coarser level and added it in another pass, and the RPN's relu was one more.
The kernel (``frcnn_tpu_torch/csrc/fpn_epilogue.cu``) finishes a convolution
run without its bias, in one read and one write of a bf16 channels-last
tensor, in one of three modes:

    bias         out = x + bias
    bias + relu  out = relu(x + bias)
    merge        out = (x + bias) + up2(top)

``up2(top)`` is the nearest 2x upsample of the coarser level, cropped to x's
size where a level is odd, read in place (``top[..., y // 2, x // 2]``).
The roundings are the module path's (``cast_conv``, then ``+``, ``relu``): the
bias cast to bf16, a rounding after the bias add and another after the
top-down add, so the result is bit-equal to the passes it replaces.
Nothing is cached: a bias copied into the parameter in place reaches the
next launch or graph replay.  Bound on the H100: bytes (x, the output, and
the coarser level, each once).  The launch geometry is ``epilogue_grid``'s
rule, shared with the BN epilogue.

``fpn_epilogue_reference`` is the plain twin: the same arithmetic in
PyTorch, in f32 with a rounding to x's dtype after each add, the upsample
as an index gather.
"""

from __future__ import annotations

import torch

from frcnn_tpu_torch.ops.cuda import build
from frcnn_tpu_torch.ops.cuda.epilogue_grid import epilogue_plan


def up2(top, h: int, w: int):
    """Nearest 2x upsample of ``top`` (B, C, TH, TW) cropped to (h, w):
    ``top[..., y // 2, x // 2]``, as ``F.interpolate(top, scale_factor=2,
    mode="nearest")[..., :h, :w]``."""
    rows = torch.div(torch.arange(h, device=top.device), 2, rounding_mode="floor")
    cols = torch.div(torch.arange(w, device=top.device), 2, rounding_mode="floor")
    return top.index_select(2, rows).index_select(3, cols)


def fpn_epilogue_reference(x, bias, top=None, relu: bool = False):
    """``x + bias`` [``+ up2(top)``] [relu] in PyTorch: ``bias`` cast to x's
    dtype, each add in f32 (f64 for f64 inputs) and rounded to x's dtype.
    x (B, C, H, W), bias (C,), top (B, C, TH, TW) with 2 TH >= H, 2 TW >= W."""
    dt = x.dtype
    acc = torch.promote_types(dt, torch.float32)
    y = (x.to(acc) + bias.to(dt).to(acc)[:, None, None]).to(dt)
    if top is not None:
        y = (y.to(acc) + up2(top, *y.shape[2:]).to(acc)).to(dt)
    if relu:
        y = torch.relu(y)
    return y.contiguous(memory_format=torch.channels_last)


def fpn_epilogue(x, bias, top=None, relu: bool = False):
    """``fpn_epilogue_reference``'s function as one kernel launch.  x (and
    top) (B, C, H, W) in channels-last memory; returns the same.  ``top``
    and ``relu`` are not taken together (the kernel has no such mode).
    CPU tensors run the plain twin; CUDA tensors launch the kernel, which
    takes bf16, an f32 bias (the parameter, rounded to bf16 inside it) and
    C a multiple of 8, and raises otherwise."""
    if top is not None and relu:
        raise ValueError("fpn_epilogue: the top-down add or the relu, not both")
    if not x.is_cuda:
        return fpn_epilogue_reference(x, bias, top, relu)
    b, c, h, w = x.shape
    bf = torch.bfloat16
    xl = x.permute(0, 2, 3, 1).contiguous()
    build.check_cuda("fpn_epilogue x", xl, bf, (b, h, w, c))
    build.check_cuda("fpn_epilogue bias", bias, torch.float32, (c,))
    th = tw = 0
    tl = None
    if top is not None:
        th, tw = top.shape[2:]
        tl = top.permute(0, 2, 3, 1).contiguous()
        build.check_cuda("fpn_epilogue top", tl, bf, (b, th, tw, c))
        if 2 * th < h or 2 * tw < w:
            raise ValueError(f"fpn_epilogue: top {tuple(top.shape)} is not a level coarser "
                             f"by 2 than x {tuple(x.shape)}")
    plan = epilogue_plan(xl.numel(), c)
    out = torch.empty_like(xl)
    build.launch("frcnn_fpn_epilogue", xl.data_ptr(), b, h, w, c, bias.data_ptr(),
                 None if tl is None else tl.data_ptr(), th, tw, int(relu), plan["threads"],
                 plan["blocks"], out.data_ptr())
    build.LAUNCH_COUNTS["fpn_epilogue"] += 1
    return out.permute(0, 3, 1, 2)
