"""K2: batched RoIAlign forward, K2b: its backward — CUDA kernel wrappers,
their plain twins, and ``RoIAlignFunction`` that joins them for autograd.

Replaces the TPU kernels ``frcnn_tpu/ops/pallas/roi_align_kernel.py``
(``roi_align_pallas`` / ``_fwd_kernel``, and its custom VJP ``_bwd_rule`` /
``_bwd_kernel``).  The TPU kernel phrased bilinear
sampling as interpolation matmuls for its matrix unit; the kernel
(``frcnn_tpu_torch/csrc/roi_align_kernel.cu``) gathers instead: one block
per (image, roi, bin), threads over channels of the channels-last features.
Bound on the H100: memory traffic (the B*R*p*p*C output is written once;
corner reads mostly hit L2).

K2b (same source) scatters each bin's gradient to its sample corners with
f32 atomics, then rounds once to the feature dtype, as the TPU kernel's f32
scratch accumulator; rois get no gradient.  The atomics make its sum order
vary from run to run: the result is not bit-deterministic.

``roi_align_reference`` is the plain twin of K2: the same gather in PyTorch
ops, f32 accumulation (f64 for f64 features), result in the feature dtype.
``roi_align_backward_reference`` is the plain twin of K2b: ``index_add_``
of the same sample weights into an f32 buffer (f64 for f64), then a cast.
It is not autograd of the forward twin, which in bf16 would accumulate in
bf16.
"""

from __future__ import annotations

import torch

from frcnn_tpu_torch.ops.cuda import build


def _axis_samples(lo, hi, p: int, sr: int, size: int):
    """Sample geometry along one axis, as ``frcnn_tpu/ops/roi_align.py``:
    lo/hi (B, R) scaled roi edges → (low, high) indices and their weights,
    each (B, R, p*sr); an empty sample gets zero weights."""
    # divide by tensors: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which is not the correctly rounded quotient
    p_t, sr_t = (torch.tensor(float(v), device=lo.device) for v in (p, sr))
    bin_sz = torch.clamp(hi - lo, min=1.0) / p_t
    s = (torch.arange(p * sr, dtype=torch.float32, device=lo.device) + 0.5) / sr_t
    coords = lo[..., None] + s * bin_sz[..., None]
    empty = (coords < -1.0) | (coords > size)
    c = torch.clamp(coords, 0.0, size - 1.0)
    low = torch.floor(c)
    frac = c - low
    low_i = low.long()
    high_i = torch.clamp(low_i + 1, max=size - 1)
    w_lo = torch.where(empty, 0.0, 1.0 - frac)
    w_hi = torch.where(empty, 0.0, frac)
    return low_i, high_i, w_lo, w_hi


_CHUNK = 64  # rois per step of the twins: bounds their gathered intermediates


def _acc_dtype(dtype):
    """Accumulation dtype of the twins: f32, or f64 for f64 features."""
    return torch.promote_types(dtype, torch.float32)


def _geometry(rois, h: int, w: int, p: int, sr: int, spatial_scale: float):
    scaled = rois.float() * spatial_scale
    ys = _axis_samples(scaled[..., 1], scaled[..., 3], p, sr, h)
    xs = _axis_samples(scaled[..., 0], scaled[..., 2], p, sr, w)
    return ys, xs


def roi_align_reference(feat, rois, output_size: int = 7,
                        spatial_scale: float = 1.0 / 16.0, sampling_ratio: int = 2):
    """RoIAlign (torchvision aligned=False, fixed sampling ratio).
    feat (B, H, W, C), rois (B, R, 4) image coords → (B, R, p, p, C) in
    feat's dtype."""
    b, h, w, c = feat.shape
    r = rois.shape[1]
    p, sr = output_size, sampling_ratio
    acc_dt = _acc_dtype(feat.dtype)
    (yl, yh, wyl, wyh), (xl, xh, wxl, wxh) = _geometry(rois, h, w, p, sr, spatial_scale)
    flat = feat.reshape(b, h * w, c)
    out = torch.empty((b, r, p, p, c), dtype=feat.dtype, device=feat.device)
    for r0 in range(0, r, _CHUNK):
        sl = slice(r0, r0 + _CHUNK)
        acc = 0.0
        for yi, wy in ((yl[:, sl], wyl[:, sl]), (yh[:, sl], wyh[:, sl])):
            for xi, wx in ((xl[:, sl], wxl[:, sl]), (xh[:, sl], wxh[:, sl])):
                idx = (yi[..., :, None] * w + xi[..., None, :]).flatten(1)
                vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c)).to(acc_dt)
                wgt = (wy[..., :, None] * wx[..., None, :]).flatten(1)
                acc = acc + vals * wgt[..., None]
        rc = acc.shape[1] // (p * sr * p * sr)
        acc = acc.reshape(b, rc, p, sr, p, sr, c).mean(dim=(3, 5))
        out[:, sl] = acc.to(feat.dtype)
    return out


def roi_align_forward(feat, rois, output_size: int = 7,
                      spatial_scale: float = 1.0 / 16.0, sampling_ratio: int = 2):
    """RoIAlign over a batch: feat (B, H, W, C) f32/bf16, rois (B, R, 4) →
    (B, R, p, p, C).  CPU tensors run the plain twin; CUDA tensors launch
    the kernel (one launch for the whole batch)."""
    if not feat.is_cuda:
        return roi_align_reference(feat, rois, output_size, spatial_scale,
                                   sampling_ratio)
    b, h, w, c = feat.shape
    r = rois.shape[1]
    if feat.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"roi_align: unsupported dtype {feat.dtype}")
    feat = feat.contiguous()
    rois = rois.float().contiguous()
    build.check_cuda("roi_align feat", feat, feat.dtype, (b, h, w, c))
    build.check_cuda("roi_align rois", rois, torch.float32, (b, r, 4))
    p = output_size
    out = torch.empty((b, r, p, p, c), dtype=feat.dtype, device=feat.device)
    build.launch("frcnn_roi_align_fwd", feat.data_ptr(),
                 int(feat.dtype == torch.bfloat16), rois.data_ptr(), b, h, w, c,
                 r, p, int(sampling_ratio), float(spatial_scale), out.data_ptr())
    build.LAUNCH_COUNTS["roi_align"] += 1
    return out


def roi_align_backward_reference(dout, rois, feat_hw, output_size: int = 7,
                                 spatial_scale: float = 1.0 / 16.0,
                                 sampling_ratio: int = 2):
    """dF of RoIAlign: dout (B, R, p, p, C), rois (B, R, 4), feat_hw (H, W)
    → (B, H, W, C) in dout's dtype, accumulated in f32 (f64 for f64)."""
    b, r, p, _, c = dout.shape
    h, w = feat_hw
    sr = sampling_ratio
    acc_dt = _acc_dtype(dout.dtype)
    (yl, yh, wyl, wyh), (xl, xh, wxl, wxh) = _geometry(rois, h, w, p, sr, spatial_scale)
    dfeat = torch.zeros((b * h * w, c), dtype=acc_dt, device=dout.device)
    base = (torch.arange(b, device=dout.device) * (h * w))[:, None]
    inv_count = torch.tensor(1.0 / (sr * sr), dtype=acc_dt, device=dout.device)
    for r0 in range(0, r, _CHUNK):
        sl = slice(r0, r0 + _CHUNK)
        rc = dout[:, sl].shape[1]
        # each bin's gradient, repeated over its sr x sr samples: (B, rc*(p*sr)^2, C)
        g = dout[:, sl].to(acc_dt) * inv_count
        g = g[:, :, :, None, :, None, :].expand(b, rc, p, sr, p, sr, c)
        g = g.reshape(b, rc * p * sr * p * sr, c)
        for yi, wy in ((yl[:, sl], wyl[:, sl]), (yh[:, sl], wyh[:, sl])):
            for xi, wx in ((xl[:, sl], wxl[:, sl]), (xh[:, sl], wxh[:, sl])):
                idx = (yi[..., :, None] * w + xi[..., None, :]).flatten(1) + base
                wgt = (wy[..., :, None] * wx[..., None, :]).flatten(1).to(acc_dt)
                dfeat.index_add_(0, idx.flatten(), (g * wgt[..., None]).reshape(-1, c))
    return dfeat.reshape(b, h, w, c).to(dout.dtype)


def roi_align_backward(dout, rois, feat_hw, output_size: int = 7,
                       spatial_scale: float = 1.0 / 16.0, sampling_ratio: int = 2):
    """dF of RoIAlign over a batch: dout (B, R, p, p, C) f32/bf16, rois
    (B, R, 4) → (B, H, W, C) in dout's dtype.  CPU tensors run the plain
    twin; CUDA tensors launch K2b (one launch for the whole batch)."""
    if not dout.is_cuda:
        return roi_align_backward_reference(dout, rois, feat_hw, output_size,
                                            spatial_scale, sampling_ratio)
    b, r, p, _, c = dout.shape
    h, w = feat_hw
    if dout.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"roi_align_backward: unsupported dtype {dout.dtype}")
    dout = dout.contiguous()
    rois = rois.float().contiguous()
    build.check_cuda("roi_align_backward dout", dout, dout.dtype, (b, r, p, p, c))
    build.check_cuda("roi_align_backward rois", rois, torch.float32, (b, r, 4))
    dfeat32 = torch.empty((b, h, w, c), dtype=torch.float32, device=dout.device)
    dfeat = dfeat32 if dout.dtype == torch.float32 else torch.empty_like(dfeat32, dtype=dout.dtype)
    build.launch("frcnn_roi_align_bwd", dout.data_ptr(), int(dout.dtype == torch.bfloat16),
                 rois.data_ptr(), b, h, w, c, r, p, int(sampling_ratio),
                 float(spatial_scale), dfeat32.data_ptr(), dfeat.data_ptr())
    build.LAUNCH_COUNTS["roi_align_bwd"] += 1
    return dfeat


class RoIAlignFunction(torch.autograd.Function):
    """RoIAlign with its gradient: forward K2 (``roi_align_forward``),
    backward K2b (``roi_align_backward``) — the kernels on CUDA tensors, their
    twins on CPU tensors.  rois get no gradient (they are detached in the
    lineage, and the TPU kernel's VJP returns zeros for them)."""

    @staticmethod
    def forward(ctx, feat, rois, output_size, spatial_scale, sampling_ratio):
        ctx.save_for_backward(rois)
        ctx.geometry = (feat.shape[1], feat.shape[2], output_size, spatial_scale,
                        sampling_ratio)
        return roi_align_forward(feat, rois, output_size, spatial_scale, sampling_ratio)

    @staticmethod
    def backward(ctx, dout):
        (rois,) = ctx.saved_tensors
        h, w, p, scale, sr = ctx.geometry
        dfeat = roi_align_backward(dout, rois, (h, w), p, scale, sr)
        return dfeat, None, None, None, None
