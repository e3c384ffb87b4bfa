"""RoI feature extraction, align mode (``frcnn_tpu/ops/roi_align.py``).

Batched over images: feat (B, H, W, C) channels-last, rois (B, R, 4) in
image coordinates → (B, R, p, p, C).  On CUDA tensors ``extract_roi_features``
runs K2 (``ops/cuda/roi_align_kernel.py``) in one launch for the batch;
``roi_align`` is its plain twin.
"""

from __future__ import annotations

from frcnn_tpu_torch.ops.cuda.roi_align_kernel import roi_align_forward
from frcnn_tpu_torch.ops.cuda.roi_align_kernel import roi_align_reference as roi_align  # noqa: F401


def extract_roi_features(feat, rois, mode: str = "align", output_size: int = 7,
                         spatial_scale: float = 1.0 / 16.0, sampling_ratio: int = 2,
                         use_kernels: bool = True):
    """cfg.POOLING_MODE dispatcher (reference Network._crop_pool_layer).
    Only 'align' is ported."""
    if mode != "align":
        raise ValueError(f"POOLING_MODE {mode!r} is not ported (only 'align')")
    fn = roi_align_forward if use_kernels else roi_align
    return fn(feat, rois, output_size, spatial_scale, sampling_ratio)
