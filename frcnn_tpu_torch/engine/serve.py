"""Single-device serving (``frcnn_tpu/engine/serve.py::Detector`` without
the mesh): host-side resize + pad into buckets, one ``detect`` call per
bucket group (all dispatched before the first readback), detections in
original image coordinates.  The detector runs
on the card (``cuda:0``) unless the caller passes ``device``."""

from __future__ import annotations

import numpy as np
import torch

from frcnn_tpu_torch.config import Config
from frcnn_tpu_torch.data.loader import prep_im_for_blob
from frcnn_tpu_torch.engine import resolve_device


def prep_image(im, cfg: Config, keep_uint8: bool = False):
    """One BGR image → (blob (bh, bw, 3) resized to TEST.SCALES[0] and padded
    into its bucket, im_info (3,) float32 [h, w, scale] of the scaled
    image)."""
    blob, scale = prep_im_for_blob(im, cfg.TEST.SCALES[0], cfg.TEST.MAX_SIZE,
                                   cfg.DEVICE.BUCKETS, keep_uint8=keep_uint8)
    h, w = im.shape[:2]
    return blob, np.array([np.round(h * scale), np.round(w * scale), scale], np.float32)


def iter_bucket_batches(images, cfg: Config, batch: int | None = None,
                        keep_uint8: bool = False):
    """Resize/pad each image of the iterable ``images`` into its bucket and
    yield (indices, data (b, bh, bw, 3), im_info (b, 3)): a batch never
    mixes bucket shapes.  A bucket's batch is yielded once it holds
    ``batch`` images (None: no cap), the part-filled ones at the end in
    the order their buckets first appeared."""
    pending: dict = {}
    for i, im in enumerate(images):
        blob, info = prep_image(im, cfg, keep_uint8=keep_uint8)
        group = pending.setdefault(blob.shape[:2], [])
        group.append((i, blob, info))
        if len(group) == batch:
            yield _stack(group)
            pending[blob.shape[:2]] = []
    for group in pending.values():
        if group:
            yield _stack(group)


def _stack(group):
    return ([i for i, _, _ in group], np.stack([blob for _, blob, _ in group]),
            np.stack([info for _, _, info in group]))


class Detector:
    """Batched detection service.  The model is moved to ``device``:
    ``cuda:0`` by default (a ``RuntimeError`` when there is no card),
    ``"cpu"`` on request.

    Usage:
        det = Detector(model)
        results = det(list_of_bgr_images)   # list of (k, 6) float arrays
    """

    def __init__(self, model, cfg: Config | None = None,
                 max_per_image: int | None = None, uint8_input: bool = False,
                 device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = cfg or model.config
        self.max_per_image = max_per_image or self.cfg.TEST.MAX_PER_IMAGE
        # uint8_input: resize/pad/ship uint8 — 4x less host→device traffic;
        # the cast and mean subtraction run on the device either way
        self.uint8_input = uint8_input

    @torch.inference_mode()
    def detect_blobs(self, data, im_info):
        """Fixed-shape entry: data (B, bh, bw, 3), im_info (B, 3), numpy or
        tensors → (dets (B, D, 6), valid (B, D)) on the device."""
        data = torch.as_tensor(data).to(self.device)
        im_info = torch.as_tensor(im_info, dtype=torch.float32).to(self.device)
        return self.model.detect(data, im_info, self.max_per_image)

    def __call__(self, images):
        """images: list of BGR uint8 arrays → list of (k, 6) float32 arrays
        [x1, y1, x2, y2, score, class] in original image coordinates."""
        results = [None] * len(images)
        # launch every bucket group first, keep its detections on the device,
        # then read back: the host never waits on one group before it has
        # handed the device the next
        pending = [(indices, *self.detect_blobs(data, im_info)) for indices, data, im_info
                   in iter_bucket_batches(images, self.cfg, keep_uint8=self.uint8_input)]
        for indices, dets, valid in pending:
            dets, valid = dets.cpu().numpy(), valid.cpu().numpy()
            for bi, i in enumerate(indices):
                results[i] = dets[bi][valid[bi]]
        return results
