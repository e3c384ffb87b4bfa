"""RoI feature extraction, align mode (``frcnn_tpu/ops/roi_align.py``).

Batched over images: feat (B, H, W, C) channels-last, rois (B, R, 4) in
image coordinates → (B, R, p, p, C).  With ``use_kernels``
``extract_roi_features`` goes through ``RoIAlignFunction``: K2 forward and
K2b backward (``ops/cuda/roi_align_kernel.py``) on CUDA tensors, one launch
each for the batch, their twins on CPU tensors.  ``roi_align`` is the plain
twin, differentiated by autograd when the kernels are off.

FPN: ``extract_multilevel_features`` pools each roi from its assigned
pyramid level.  With ``use_kernels`` it goes through
``RoIAlignMultilevelFunction``: K6 forward and K6b backward on CUDA tensors,
one launch each for all levels and images, their twins on CPU tensors.
``roi_align_multilevel`` is the plain twin, differentiated by autograd when
the kernels are off.
"""

from __future__ import annotations

from frcnn_tpu_torch.ops.cuda.roi_align_kernel import RoIAlignFunction, RoIAlignMultilevelFunction
from frcnn_tpu_torch.ops.cuda.roi_align_kernel import (
    roi_align_multilevel_reference as roi_align_multilevel)
from frcnn_tpu_torch.ops.cuda.roi_align_kernel import roi_align_reference as roi_align  # noqa: F401


def extract_roi_features(feat, rois, mode: str = "align", output_size: int = 7,
                         spatial_scale: float = 1.0 / 16.0, sampling_ratio: int = 2,
                         use_kernels: bool = True):
    """cfg.POOLING_MODE dispatcher (reference Network._crop_pool_layer).
    Only 'align' is ported.  rois get no gradient."""
    if mode != "align":
        raise ValueError(f"POOLING_MODE {mode!r} is not ported (only 'align')")
    rois = rois.detach()
    if use_kernels:
        return RoIAlignFunction.apply(feat, rois, output_size, spatial_scale, sampling_ratio)
    return roi_align(feat, rois, output_size, spatial_scale, sampling_ratio)


def extract_multilevel_features(feats, rois, levels, strides, output_size: int = 7,
                                sampling_ratio: int = 2, use_kernels: bool = True):
    """feats: L channels-last maps (B, H_l, W_l, C); rois (B, R, 4) image
    coordinates; levels (B, R) in [0, L); strides: L ints → (B, R, p, p, C),
    in roi order.  rois get no gradient."""
    rois = rois.detach()
    if use_kernels:
        return RoIAlignMultilevelFunction.apply(rois, levels, strides, output_size,
                                                sampling_ratio, *feats)
    return roi_align_multilevel(feats, rois, levels, strides, output_size, sampling_ratio)
