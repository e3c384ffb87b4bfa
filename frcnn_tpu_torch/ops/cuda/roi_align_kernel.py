"""K2: batched RoIAlign forward — CUDA kernel wrapper and its plain twin.

Replaces the TPU kernel ``frcnn_tpu/ops/pallas/roi_align_kernel.py``
(``roi_align_pallas`` / ``_fwd_kernel``).  The TPU kernel phrased bilinear
sampling as interpolation matmuls for its matrix unit; the kernel
(``frcnn_tpu_torch/csrc/roi_align_kernel.cu``) gathers instead: one block
per (image, roi, bin), threads over channels of the channels-last features.
Bound on the H100: memory traffic (the B*R*p*p*C output is written once;
corner reads mostly hit L2).

``roi_align_reference`` is the plain twin: the same gather in PyTorch ops,
f32 accumulation, result in the feature dtype.
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


_CHUNK = 64  # rois per step of the twin: bounds its gathered intermediates


def roi_align_reference(feat, rois, output_size: int = 7,
                        spatial_scale: float = 1.0 / 16.0, sampling_ratio: int = 2):
    """RoIAlign (torchvision aligned=False, fixed sampling ratio).
    feat (B, H, W, C), rois (B, R, 4) image coords → (B, R, p, p, C) in
    feat's dtype."""
    b, h, w, c = feat.shape
    r = rois.shape[1]
    p, sr = output_size, sampling_ratio
    scaled = rois.float() * spatial_scale
    yl, yh, wyl, wyh = _axis_samples(scaled[..., 1], scaled[..., 3], p, sr, h)
    xl, xh, wxl, wxh = _axis_samples(scaled[..., 0], scaled[..., 2], p, sr, w)
    flat = feat.reshape(b, h * w, c)
    out = torch.empty((b, r, p, p, c), dtype=feat.dtype, device=feat.device)
    for r0 in range(0, r, _CHUNK):
        sl = slice(r0, r0 + _CHUNK)
        acc = 0.0
        for yi, wy in ((yl[:, sl], wyl[:, sl]), (yh[:, sl], wyh[:, sl])):
            for xi, wx in ((xl[:, sl], wxl[:, sl]), (xh[:, sl], wxh[:, sl])):
                idx = (yi[..., :, None] * w + xi[..., None, :]).flatten(1)
                vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c)).float()
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
