"""Serving (``frcnn_tpu/engine/serve.py``): host-side resize + pad into
buckets, one ``detect`` call per bucket group (all dispatched before the
first readback), detections in original image coordinates, and
``throughput``, the steady-state images/s of ``detect_blobs``.  The
detector runs on the card (``cuda:0``) unless the caller passes ``device``.

Under a ``mesh`` (``frcnn_tpu_torch/parallel/mesh.py``) every rank holds a
replica of the model and detects its rows of each bucket group, padded to
a multiple of the mesh size with copies of the group's last image; the
rows are gathered on the host after readback, so every rank returns the
whole list.  Detection is per image, so the result is the unsharded
detector's.

On the card every ``detect`` call replays a CUDA graph captured once per
(B, bh, bw, input dtype, max_per_image), the counterpart of the JAX
engine's ``jax.jit(detect)`` (``engine/graphs.py``: all graphs of one
``Detector`` share a memory pool; under a mesh, one set a rank, the
collectives outside the graphs).  There is no switch, as JAX has none for
``jit``; on the CPU (``device="cpu"``) ``detect`` runs eagerly.

Under a profiler ``detect_blobs`` and ``__call__`` record the spans
``frcnn.serve.detect_blobs`` and ``frcnn.serve.call``, and inside the
latter ``frcnn.serve.prep`` an image and ``frcnn.serve.readback``
(``utils/trace.py``)."""

from __future__ import annotations

import time

import numpy as np
import torch

from frcnn_tpu_torch.config import Config
from frcnn_tpu_torch.data.loader import pick_scale_and_bucket, prep_im_for_blob
from frcnn_tpu_torch.engine import resolve_device
from frcnn_tpu_torch.engine.graphs import DetectGraphs
from frcnn_tpu_torch.parallel.mesh import barrier, gather_rows, replicate, shard_batch
from frcnn_tpu_torch.utils.trace import span


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


def image_bucket(im, cfg: Config):
    """The bucket (bh, bw) ``prep_image`` pads ``im`` into, from its shape."""
    h, w = im.shape[:2]
    return pick_scale_and_bucket(h, w, cfg.TEST.SCALES[0], cfg.TEST.MAX_SIZE,
                                 cfg.DEVICE.BUCKETS)[1]


def _stack(group):
    return ([i for i, _, _ in group], np.stack([blob for _, blob, _ in group]),
            np.stack([info for _, _, info in group]))


class Detector:
    """Batched, optionally data-parallel detection service.  The model is
    moved to ``device``: ``cuda:0`` by default (a ``RuntimeError`` when
    there is no card), ``"cpu"`` on request, the mesh's device under a
    ``mesh``, where it is replicated from rank 0.  On a card ``graphs`` (a
    ``DetectGraphs``, made after the move and the replication) replays
    ``detect``; on the CPU it is None and ``detect`` runs eagerly.

    Usage:
        det = Detector(model)               # or Detector(model, mesh=mesh) on every rank
        results = det(list_of_bgr_images)   # list of (k, 6) float arrays
    """

    def __init__(self, model, cfg: Config | None = None,
                 max_per_image: int | None = None, uint8_input: bool = False,
                 device=None, mesh=None):
        self.mesh = mesh
        self.device = resolve_device(device, mesh)
        self.model = model.to(self.device)
        if mesh is not None:
            replicate(self.model, mesh)
        self.cfg = cfg or model.config
        self.max_per_image = max_per_image or self.cfg.TEST.MAX_PER_IMAGE
        # uint8_input: resize/pad/ship uint8 — 4x less host→device traffic;
        # the cast and mean subtraction run on the device either way
        self.uint8_input = uint8_input
        self.graphs = (DetectGraphs(self.model, self.max_per_image, self.device)
                       if self.device.type == "cuda" else None)

    @torch.inference_mode()
    def _detect(self, data, im_info):
        if self.graphs is not None:
            return self.graphs(data, im_info)
        data = torch.as_tensor(data).to(self.device)
        im_info = torch.as_tensor(im_info, dtype=torch.float32).to(self.device)
        return self.model.detect(data, im_info, self.max_per_image)

    def detect_blobs(self, data, im_info):
        """Fixed-shape entry: data (B, bh, bw, 3), im_info (B, 3), numpy or
        tensors → (dets (B, D, 6), valid (B, D)) on the device.  Under a
        mesh: B a multiple of the mesh size, and the result is this rank's
        rows (``shard_batch``), as a sharded array's addressable shard."""
        with span("frcnn.serve.detect_blobs"):
            if self.mesh is not None:
                data, im_info = shard_batch((data, im_info), self.mesh)
            return self._detect(data, im_info)

    def counters(self) -> dict:
        """The model's device counters since the last read, as ints, then
        zeroed (``FasterRCNNFPN.read_counters``: valid rois a level P2..P5,
        valid proposals, batches); {} for a model that keeps none.  It
        waits for the device: call it outside the timed path."""
        read = getattr(self.model, "read_counters", None)
        return {} if read is None else read()

    def __call__(self, images):
        """images: list of BGR uint8 arrays → list of (k, 6) float32 arrays
        [x1, y1, x2, y2, score, class] in original image coordinates.  Under
        a mesh every rank passes the same images and gets the whole list."""
        with span("frcnn.serve.call"):
            # launch every bucket group first, keep its detections on the
            # device, then read back: the host never waits on one group
            # before it has handed the device the next
            pending = [(indices, *self._detect(data, im_info))
                       for indices, data, im_info in self._my_rows(images)]
            rows = []
            with span("frcnn.serve.readback"):
                for indices, dets, valid in pending:
                    dets, valid = dets.cpu().numpy(), valid.cpu().numpy()
                    rows += [(i, dets[bi][valid[bi]]) for bi, i in enumerate(indices)
                             if i is not None]
            if self.mesh is not None:
                rows = gather_rows(rows, self.mesh)
            results = [None] * len(images)
            for i, dets in rows:
                results[i] = dets
            return results

    def _my_rows(self, images):
        """This rank's rows of each bucket group (in the order the buckets
        first appear; every row with no mesh), the group padded to a
        multiple of the mesh size with its last image: (indices, data,
        im_info) with the padding's indices None; only the rank's images are
        resized."""
        size = 1 if self.mesh is None else self.mesh.size
        groups: dict = {}
        for i, im in enumerate(images):
            groups.setdefault(image_bucket(im, self.cfg), []).append(i)
        for indices in groups.values():
            padded = indices + [indices[-1]] * ((-len(indices)) % size)
            rows = slice(0, len(padded)) if self.mesh is None else self.mesh.rows(len(padded))
            mine = padded[rows]
            keep = [i if pos < len(indices) else None
                    for pos, i in zip(range(rows.start, rows.stop), mine)]
            prepped = []
            for i in mine:
                with span("frcnn.serve.prep"):
                    prepped.append(prep_image(images[i], self.cfg, keep_uint8=self.uint8_input))
            yield (keep, np.stack([blob for blob, _ in prepped]),
                   np.stack([info for _, info in prepped]))


def _sync(detector: Detector) -> None:
    """Wait for the device, then, under a mesh, for every rank."""
    if detector.device.type == "cuda":
        torch.cuda.synchronize(detector.device)
    if detector.mesh is not None:
        barrier(detector.mesh)


def throughput(detector: Detector, batch: int, iters: int = 20, warmup: int = 2) -> float:
    """Steady-state images/s of ``detector.detect_blobs`` on synthetic data
    (``frcnn_tpu/engine/serve.py:99-129``): ``batch`` f32 images of uniform
    noise at DEVICE.BUCKETS[0], made on the detector's device once, ``warmup``
    calls, then ``iters`` calls between two synchronizations of the device
    (the calls queue back to back; the clock stops when the last is done).
    Under a mesh ``batch`` is the global batch, of which each rank's
    ``detect_blobs`` detects its rows, and the two synchronizations wait for
    every rank."""
    h, w = detector.cfg.DEVICE.BUCKETS[0]
    rng = np.random.RandomState(0)
    data = torch.from_numpy(rng.uniform(0, 255, (batch, h, w, 3)).astype(np.float32))
    im_info = torch.tensor([[float(h), float(w), 1.0]] * batch)
    data, im_info = data.to(detector.device), im_info.to(detector.device)
    for _ in range(warmup):
        detector.detect_blobs(data, im_info)
    _sync(detector)
    t0 = time.perf_counter()
    for _ in range(iters):
        detector.detect_blobs(data, im_info)
    _sync(detector)
    return batch * iters / (time.perf_counter() - t0)
