"""K3: fused stride-1 ResNet bottleneck — CUDA kernel wrapper and its twin.

Replaces the TPU kernel ``frcnn_tpu/ops/pallas/fused_block.py``
(``fused_bottleneck`` / ``_kernel``).  The kernel
(``frcnn_tpu_torch/csrc/fused_block.cu``) computes one 8x16 output tile per
block: conv1 over the tile and its 1-pixel halo into shared memory, conv2
from there, conv3 + residual in the epilogue, all on the tensor cores
(wmma, bf16 in, f32 accumulate).  Bound on the H100: the unfused chain moves
three activation tensors through device memory per conv; fused, only the
block input is read and the output written.  Intermediates are rounded to
bf16 after bias + relu, where the TPU kernel rounds them.

``bottleneck_reference`` is the plain twin (``bottleneck_reference`` of the
JAX module): three convolutions with the same folded weights, biases added
in f32 (f64 for f64 inputs), rounding to the input dtype at the same
points.  In bf16 on a card its convolutions are cuDNN's, whose outputs are
also rounded to bf16 before the bias; in f32 it is exact math up to
summation order.

``FusedBottleneckFunction`` gives the block its gradient: forward K3 (the
twin on CPU tensors), backward autograd of ``bottleneck_reference``
recomputed from the saved inputs, as the JAX module's ``_id_bwd`` /
``_ds_bwd``.  The TPU package has no backward kernel for the block, so
neither has this one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from frcnn_tpu_torch.ops.cuda import build

SUPPORTED_MID = (64, 128)


def bottleneck_reference(x, w1, b1, w2, b2, w3, b3, wds=None, bds=None):
    """x (B, H, W, Cin); w1 (Cin, mid); w2 HWIO (3, 3, mid, mid); w3
    (mid, Cout); optional projection wds (Cin, Cout); bias vectors.
    Returns (B, H, W, Cout) in x's dtype."""
    dt = x.dtype
    acc = torch.promote_types(dt, torch.float32)
    xn = x.permute(0, 3, 1, 2)

    def conv(v, k_oihw, pad=0):
        return F.conv2d(v, k_oihw.to(dt), padding=pad).to(acc)

    def act(v, bias):
        return torch.relu(v + bias.to(acc)[:, None, None]).to(dt)

    y = act(conv(xn, w1.t()[:, :, None, None]), b1)
    y = act(conv(y, w2.permute(3, 2, 0, 1), 1), b2)
    y = conv(y, w3.t()[:, :, None, None]) + b3.to(acc)[:, None, None]
    if wds is not None:
        res = conv(xn, wds.t()[:, :, None, None]) + bds.to(acc)[:, None, None]
    else:
        res = xn.to(acc)
    return torch.relu(y + res).to(dt).permute(0, 2, 3, 1).contiguous()


def fused_bottleneck(x, w1, b1, w2cat, b2, w3, b3, wds=None, bds=None):
    """One stride-1 bottleneck block with frozen BN folded into the weights.

    x (B, H, W, Cin); w1 (Cin, mid); w2cat (9*mid, mid) — the HWIO 3x3
    kernel reshaped over (dr, dc) taps; w3 (mid, Cout); optional projection
    wds (Cin, Cout); biases (mid,) / (Cout,).  Cout must equal Cin without a
    projection.  CPU tensors run the plain twin; CUDA tensors launch the
    kernel, which takes bf16 and mid in SUPPORTED_MID and raises otherwise."""
    mid = w1.shape[1]
    if not x.is_cuda:
        return bottleneck_reference(x, w1, b1, w2cat.reshape(3, 3, mid, mid), b2,
                                    w3, b3, wds, bds)
    b, h, w, cin = x.shape
    cout = w3.shape[1]
    if mid not in SUPPORTED_MID:
        raise ValueError(f"fused_bottleneck: mid={mid} not in {SUPPORTED_MID}")
    if wds is None and cin != cout:
        raise ValueError("fused_bottleneck: identity residual needs Cin == Cout")
    bf = torch.bfloat16
    x = x.contiguous()
    weights = [t.to(bf).contiguous() for t in (w1, b1, w2cat, b2, w3, b3)]
    shapes = [(cin, mid), (mid,), (9 * mid, mid), (mid,), (mid, cout), (cout,)]
    if wds is not None:
        weights += [wds.to(bf).contiguous(), bds.to(bf).contiguous()]
        shapes += [(cin, cout), (cout,)]
    build.check_cuda("fused_bottleneck x", x, bf, (b, h, w, cin))
    for i, (t, shape) in enumerate(zip(weights, shapes)):
        build.check_cuda(f"fused_bottleneck weight {i}", t, bf, shape)
    ptrs = [t.data_ptr() for t in weights] + [None] * (8 - len(weights))
    out = torch.empty((b, h, w, cout), dtype=bf, device=x.device)
    build.launch("frcnn_fused_bottleneck", x.data_ptr(), b, h, w, cin, mid, cout,
                 *ptrs, out.data_ptr())
    build.LAUNCH_COUNTS["fused_block"] += 1
    return out


class FusedBottleneckFunction(torch.autograd.Function):
    """``fused_bottleneck`` with a gradient: the forward is K3 (its twin on
    CPU tensors); the backward recomputes ``bottleneck_reference`` from the
    saved inputs under ``enable_grad`` and differentiates it (JAX:
    ``fused_bottleneck_vjp`` / ``fused_bottleneck_ds_vjp``).  Arguments as
    ``fused_bottleneck``; ``wds``/``bds`` may be None."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2cat, b2, w3, b3, wds, bds):
        ctx.save_for_backward(x, w1, b1, w2cat, b2, w3, b3, wds, bds)
        return fused_bottleneck(x, w1, b1, w2cat, b2, w3, b3, wds, bds)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        wanted = [i for i, t in enumerate(saved) if t is not None and ctx.needs_input_grad[i]]
        if not wanted:
            return (None,) * len(saved)
        inputs = [t.detach().requires_grad_(i in wanted) if t is not None else None
                  for i, t in enumerate(saved)]
        x, w1, b1, w2cat, b2, w3, b3, wds, bds = inputs
        mid = w1.shape[1]
        with torch.enable_grad():
            out = bottleneck_reference(x, w1, b1, w2cat.reshape(3, 3, mid, mid), b2,
                                       w3, b3, wds, bds)
            grads = torch.autograd.grad(out, [inputs[i] for i in wanted], grad)
        result = [None] * len(saved)
        for i, g in zip(wanted, grads):
            result[i] = g
        return tuple(result)
