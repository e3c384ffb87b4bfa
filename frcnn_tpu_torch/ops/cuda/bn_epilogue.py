"""The BN epilogue: frozen BN's affine, the residual add and the ReLU after
an unfused bottleneck's convolutions (and the stem's), as one pass — CUDA
kernel wrapper and its plain twin.

Replaces no TPU kernel: XLA fuses these elementwise ops into the JAX
package's convolutions.  On the card they were separate passes over every
layer3 and layer4 activation (x * mul, + add, relu; + residual, relu), and
the fold of (mul, add) from the statistics ran as ~8 small launches a norm
on every call.  The kernel (``frcnn_tpu_torch/csrc/bn_epilogue.cu``)
computes, in one read and one write of a bf16 channels-last tensor,

    out = act(x * mul + add  [+ residual  |  + shortcut * mul_s + add_s])

folding each frozen BN from its four f32 buffers inside the kernel as
``FrozenBatchNorm.folded`` does (f32, then rounded to bf16), the rest in
f32 rounded once at the store.  Nothing is cached:
statistics copied into the buffers in place reach the next launch or
graph replay.  Bound on the H100: bytes (x, the residual or shortcut, the
output, each once).  ``epilogue_plan`` is the launch geometry, a fixed rule
of the shape: no tuning, no state.

``bn_epilogue_reference`` is the plain twin: the same arithmetic in
PyTorch (bf16 mul/add, f32 body, one rounding).  It differs from the
module-by-module path (``FrozenBatchNorm.forward``, then ``+``, ``relu``,
each rounded to bf16) by bf16 rounding only.
"""

from __future__ import annotations

import math

import torch

from frcnn_tpu_torch.ops.cuda import build

THREADS = 512          # the kernel's block (csrc/bn_epilogue.cu, kThreads)
UNROLL = 4             # vectors of 8 channels a thread has at least, where the tensor allows
SMS = 132              # H100 SXM
BLOCKS_PER_SM = 1      # the kernel's __launch_bounds__(512, 1)


def epilogue_plan(numel: int, c: int) -> dict:
    """Launch geometry for ``numel`` bf16 values of ``c`` channels: THREADS
    a block; enough blocks that each thread has UNROLL vectors of 8 where
    the tensor allows, at most BLOCKS_PER_SM a streaming multiprocessor
    (one wave), rounded up so that blocks x THREADS is a whole number of
    pixels (c / 8 vectors): a thread's channels then stay the same in every
    step of its grid-stride loop."""
    if c % 8 or numel % c:
        raise ValueError(f"bn_epilogue: {numel} values of {c} channels (need c % 8 == 0)")
    vecs = c // 8
    multiple = vecs // math.gcd(vecs, THREADS)
    blocks = min(-(-numel // (8 * THREADS * UNROLL)), SMS * BLOCKS_PER_SM)
    blocks = -(-max(blocks, 1) // multiple) * multiple
    return {"threads": THREADS, "blocks": blocks}


def bn_epilogue_reference(x, bn, relu: bool = True, residual=None, shortcut=None,
                          shortcut_bn=None):
    """act(x * mul + add [+ residual | + shortcut * mul_s + add_s]) in
    PyTorch: (mul, add) folded and rounded to x's dtype, the rest in f32 (f64
    for f64 inputs), one rounding to x's dtype.  x, residual, shortcut
    (B, C, H, W); ``bn``, ``shortcut_bn`` ``FrozenBatchNorm``s."""
    dt = x.dtype
    acc = torch.promote_types(dt, torch.float32)

    def affine(v, norm):
        mul, add = (t.to(acc)[:, None, None] for t in norm.folded(dt))
        return v.to(acc) * mul + add

    y = affine(x, bn)
    if residual is not None:
        y = y + residual.to(acc)
    elif shortcut is not None:
        y = y + affine(shortcut, shortcut_bn)
    if relu:
        y = torch.relu(y)
    return y.to(dt)


def bn_epilogue(x, bn, relu: bool = True, residual=None, shortcut=None, shortcut_bn=None):
    """``bn_epilogue_reference``'s function as one kernel launch.  x (and
    residual or shortcut) (B, C, H, W) in channels-last memory; returns the
    same.  At most one of ``residual`` and ``shortcut`` (with its
    ``shortcut_bn``).  CPU tensors run the plain twin; CUDA tensors launch
    the kernel, which takes bf16 and C a multiple of 8 and raises
    otherwise."""
    if residual is not None and shortcut is not None:
        raise ValueError("bn_epilogue: a residual or a shortcut, not both")
    if not x.is_cuda:
        return bn_epilogue_reference(x, bn, relu, residual, shortcut, shortcut_bn)
    b, c, h, w = x.shape
    bf = torch.bfloat16

    def stats(norm):
        buffers = (norm.weight, norm.bias, norm.running_mean, norm.running_var)
        for t in buffers:
            build.check_cuda("bn_epilogue norm", t, torch.float32, (c,))
        return [t.data_ptr() for t in buffers] + [float(norm.eps)]

    xl = x.permute(0, 2, 3, 1).contiguous()
    build.check_cuda("bn_epilogue x", xl, bf, (b, h, w, c))
    mode, other, ds = 0, None, [None] * 4 + [0.0]
    if residual is not None or shortcut is not None:
        mode = 1 if residual is not None else 2
        other = (residual if residual is not None else shortcut).permute(0, 2, 3, 1).contiguous()
        build.check_cuda("bn_epilogue residual", other, bf, (b, h, w, c))
    if shortcut is not None:
        ds = stats(shortcut_bn)
    plan = epilogue_plan(xl.numel(), c)
    out = torch.empty_like(xl)
    build.launch("frcnn_bn_epilogue", xl.data_ptr(), xl.numel(), c, *stats(bn),
                 None if other is None else other.data_ptr(), mode, *ds, int(relu),
                 plan["threads"], plan["blocks"], out.data_ptr())
    build.LAUNCH_COUNTS["bn_epilogue"] += 1
    return out.permute(0, 3, 1, 2)
