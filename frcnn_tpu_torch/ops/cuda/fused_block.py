"""K3: fused stride-1 ResNet bottleneck — CUDA kernel wrapper and its twin.

Replaces the TPU kernel ``frcnn_tpu/ops/pallas/fused_block.py``
(``fused_bottleneck`` / ``_kernel``).  The kernel
(``frcnn_tpu_torch/csrc/fused_block.cu``) computes one 8x30 output tile per
512-thread block (four warpgroups), one block an SM: conv1 over the tile
and its 1-pixel halo into shared memory, conv2 from there (pixels flattened
at a pitch of 32, so each 3x3 tap is one shifted wgmma operand), conv3 +
residual in the epilogue, all by wgmma (bf16 in, f32 accumulate) with
weights and x staged through a three-stage cp.async ring in shared memory.
Only the block input is read and the output written (16-byte stores).
Bound on the H100 by the count: bytes (the unfused chain moves three
activation tensors through device memory per conv); in fact by the traffic
from L2 into shared memory, since every block stages all the weights again
(timed with parts of the kernel switched off by the ablation script of
commit 06a1628), which is why the tile is as large as a block can hold.
Intermediates are rounded to bf16 after bias + relu, where the TPU kernel
rounds them.  ``fused_plan`` is the launch geometry (tiles,
shared-memory bytes); the launcher refuses a plan that is not the kernel's
layout.

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
neither has this one.  ``gate`` is where a block may take the kernel; which
blocks may (frozen BN, stride 1, the width rule) is the model's to say.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from frcnn_tpu_torch.ops.cuda import build

SUPPORTED_MID = (64, 128)

# the kernel's tile and shared-memory layout (csrc/fused_block.cu, Layout)
TILE_H, TILE_W, PITCH = 8, 30, 32
HALO_ROWS = (TILE_H + 2) * PITCH               # conv1's rows: the flattened halo region
OUT_ROWS = TILE_H * PITCH                      # conv2's and conv3's rows
Y1_ROWS = OUT_ROWS + 2 * PITCH + 2             # the last tap of the last output row
WARPGROUPS = OUT_ROWS // 64                    # one 64-row output tile each
STEP_CHANNELS, TAP_ROWS, PANEL, STAGES = 32, 64, 64, 3


def gate(x) -> bool:
    """Whether a block's input ``x`` may go through K3: bf16 on the card.
    The TPU gate also required a row tile that fits VMEM (pick_row_tile);
    the CUDA kernel tiles any H and W, so that condition is gone."""
    return x.is_cuda and x.dtype == torch.bfloat16


def fused_plan(h: int, w: int, mid: int, cout: int) -> dict:
    """Launch geometry of the kernel for an (h, w) map: tiles along x and y
    (TILE_H x TILE_W output pixels a block) and the block's dynamic shared
    memory in bytes: y1 (y2 and the output tiles take its place later), the
    three-stage ring sized for the largest of the three phases' steps, and
    the f32 biases."""
    y1 = mid // 8 * Y1_ROWS * 16
    y2 = mid // 8 * OUT_ROWS * 16
    out_tiles = WARPGROUPS * 64 * PANEL * 2
    ring = (max(y1, y2 + out_tiles) + 127) // 128 * 128
    stage1 = STEP_CHANNELS // 8 * HALO_ROWS * 16 + STEP_CHANNELS * mid * 2
    stage2 = TAP_ROWS * mid * 2
    stage3 = max(mid * PANEL * 2, STEP_CHANNELS // 8 * OUT_ROWS * 16 + STEP_CHANNELS * PANEL * 2)
    return {"tiles_x": -(-w // TILE_W), "tiles_y": -(-h // TILE_H),
            "smem_bytes": ring + STAGES * max(stage1, stage2, stage3) + (2 * mid + cout) * 4}


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
                 fused_plan(h, w, mid, cout)["smem_bytes"], *ptrs, out.data_ptr())
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
