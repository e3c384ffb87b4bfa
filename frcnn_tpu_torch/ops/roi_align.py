"""RoI feature extraction (``frcnn_tpu/ops/roi_align.py``): the three
``cfg.POOLING_MODE`` paths of ``extract_roi_features``.

Batched over images: feat (B, H, W, C) channels-last, rois (B, R, 4) in
image coordinates → (B, R, p, p, C).  "align": ``extract_roi_features``
goes through ``RoIAlignFunction``: K2 forward and K2b backward
(``ops/cuda/roi_align_kernel.py``) on CUDA tensors, one launch each for the
batch, their twins on CPU tensors.  ``roi_align`` is the plain forward twin.
"pool" (``roi_pool``) and "crop" (``crop_and_resize_pool``) are plain
PyTorch on every device, differentiated by autograd: the JAX package
computes them outside any Pallas kernel too.

FPN: ``extract_multilevel_features`` pools each roi from its assigned
pyramid level.  It goes through ``RoIAlignMultilevelFunction``: K6 forward
and K6b backward on CUDA tensors, one launch each for all levels and images,
their twins on CPU tensors.  ``roi_align_multilevel`` is the plain forward
twin.
"""

from __future__ import annotations

import torch

from frcnn_tpu_torch.ops.constants import device_constant
from frcnn_tpu_torch.ops.cuda.roi_align_kernel import RoIAlignFunction, RoIAlignMultilevelFunction
from frcnn_tpu_torch.ops.cuda.roi_align_kernel import (  # noqa: F401
    roi_align_multilevel_reference as roi_align_multilevel)
from frcnn_tpu_torch.ops.cuda.roi_align_kernel import roi_align_reference as roi_align  # noqa: F401


# elements of the intermediates a roi chunk of "pool" / "crop" may hold: the
# JAX package maps over chunks of 32 rois for the same reason
_CHUNK_ELEMENTS = 1 << 26


def _roi_chunks(r: int, per_roi: int):
    """Slices of the R rois, each holding at most ``_CHUNK_ELEMENTS`` of
    intermediates (``per_roi`` elements a roi), at least one roi."""
    step = max(1, _CHUNK_ELEMENTS // max(per_roi, 1))
    return [slice(r0, r0 + step) for r0 in range(0, r, step)]


def _bin_max(x, start, end):
    """x (N, L, ...); start, end (N, M, p) int → (N, M, p, ...): the max of
    x[n, start:end] per bin, over a mask of all L positions (the JAX
    package's masks: a shape fixed by x's, so nothing is read back and the
    pool can be captured in a CUDA graph).  ``torch.amax`` splits the
    gradient over ties equally, as ``jnp.max``.  An empty bin gives -inf."""
    pos = torch.arange(x.shape[1], device=x.device)
    live = (pos >= start[..., None]) & (pos < end[..., None])        # (N, M, p, L)
    live = live.reshape(live.shape + (1,) * (x.dim() - 2))
    return torch.where(live, x[:, None, None], float("-inf")).amax(dim=3)


def roi_pool(feat, rois, output_size: int = 7, spatial_scale: float = 1.0 / 16.0):
    """RoIPool ("pool", Caffe semantics): feat (B, H, W, C), rois (B, R, 4)
    → (B, R, p, p, C) in feat's dtype.  The roi's corners round (half to
    even) to integer map cells; bin b of an axis covers [floor(b * n / p),
    ceil((b + 1) * n / p)) cells past the corner, in exact integer
    arithmetic, clipped to the map (adjacent bins may share a cell); the max
    over the bin's cells is taken over rows, then over columns (separable,
    as the JAX package), and an empty bin gives 0.  Each bin masks the whole
    axis, as the JAX package, in roi chunks that bound memory."""
    b, h, w, c = feat.shape
    p = output_size
    q = torch.round(rois.float() * spatial_scale).long()
    x1, y1, x2, y2 = q.unbind(-1)
    pb = torch.arange(p, device=feat.device)

    def bins(lo, hi, size):
        n = torch.clamp(hi - lo + 1, min=1)[..., None]
        start = torch.clamp(pb * n // p + lo[..., None], 0, size)
        end = torch.clamp(((pb + 1) * n + p - 1) // p + lo[..., None], 0, size)
        return start, end

    (hs, he), (ws, we) = bins(y1, y2, h), bins(x1, x2, w)
    outs = []
    for sl in _roi_chunks(rois.shape[1], b * p * h * w * c):
        rows = _bin_max(feat, hs[:, sl], he[:, sl])                  # (B, r, p_y, W, C)
        r = rows.shape[1]
        cols = _bin_max(rows.transpose(2, 3).reshape(b * r, w, p, c),
                        ws[:, sl].reshape(b * r, 1, p), we[:, sl].reshape(b * r, 1, p))
        outs.append(cols.reshape(b, r, p, p, c).transpose(2, 3))     # (B, r, p_y, p_x, C)
    out = torch.cat(outs, dim=1)
    return torch.where(torch.isfinite(out), out, 0.0)


def _interp_matrix(coords, size: int):
    """Dense bilinear interpolation weights (..., P) → (..., P, size) with
    RoIAlign's border rule: a sample below -1 or above ``size`` is empty (all
    zero); any other is clamped to [0, size - 1] and weights its two
    neighbours."""
    empty = (coords < -1.0) | (coords > size)
    cc = torch.clamp(coords, 0.0, size - 1.0)
    low = torch.floor(cc)
    frac = cc - low
    low_i = low.long()
    high_i = torch.clamp(low_i + 1, max=size - 1)
    grid = torch.arange(size, device=coords.device)
    wgt = ((1.0 - frac)[..., None] * (grid == low_i[..., None])
           + frac[..., None] * (grid == high_i[..., None]))
    return torch.where(empty[..., None], 0.0, wgt)


def crop_and_resize_pool(feat, rois, output_size: int = 7, spatial_scale: float = 1.0 / 16.0):
    """"crop": a bilinear crop of each roi to (2p, 2p) on tf.crop_and_resize's
    corner-aligned grid (sample k at y1 + k / (2p - 1) * (y2 - y1), in f32:
    the JAX package writes the step in the map's dtype, but XLA keeps it
    unrounded inside the jitted function), then a 2x2 max pool → (B, R, p,
    p, C) in feat's dtype.  The crop is the JAX package's two
    products with interpolation matrices (``_interp_matrix``), accumulated in
    f32 (f64 for f64 maps), in roi chunks that bound memory."""
    b, h, w, c = feat.shape
    s, p = 2 * output_size, output_size
    acc = torch.promote_types(feat.dtype, torch.float32)
    scaled = rois.to(acc) * spatial_scale
    step = torch.arange(s, dtype=acc, device=feat.device)
    step = step / device_constant(s - 1.0, acc, feat.device)
    x1, y1, x2, y2 = scaled.unbind(-1)
    wy = _interp_matrix(y1[..., None] + step * (y2 - y1)[..., None], h)    # (B, R, s, H)
    wx = _interp_matrix(x1[..., None] + step * (x2 - x1)[..., None], w)    # (B, R, s, W)
    fa = feat.to(acc)
    outs = []
    for sl in _roi_chunks(rois.shape[1], b * h * s * c):
        g = torch.einsum("brqw,bhwc->brhqc", wx[:, sl], fa)
        crops = torch.einsum("brph,brhqc->brpqc", wy[:, sl], g)
        outs.append(crops.reshape(b, -1, p, 2, p, 2, c).amax(dim=(3, 5)))
    return torch.cat(outs, dim=1).to(feat.dtype)


def extract_roi_features(feat, rois, mode: str = "align", output_size: int = 7,
                         spatial_scale: float = 1.0 / 16.0, sampling_ratio: int = 2):
    """cfg.POOLING_MODE dispatcher (reference Network._crop_pool_layer):
    "align", "pool" or "crop".  rois get no gradient."""
    rois = rois.detach()
    if mode == "align":
        return RoIAlignFunction.apply(feat, rois, output_size, spatial_scale, sampling_ratio)
    if mode == "pool":
        return roi_pool(feat, rois, output_size, spatial_scale)
    if mode == "crop":
        return crop_and_resize_pool(feat, rois, output_size, spatial_scale)
    raise ValueError(f"unknown POOLING_MODE: {mode}")


def extract_multilevel_features(feats, rois, levels, strides, output_size: int = 7,
                                sampling_ratio: int = 2):
    """feats: L channels-last maps (B, H_l, W_l, C); rois (B, R, 4) image
    coordinates; levels (B, R) in [0, L); strides: L ints → (B, R, p, p, C),
    in roi order.  rois get no gradient."""
    return RoIAlignMultilevelFunction.apply(rois.detach(), levels, strides, output_size,
                                            sampling_ratio, *feats)
