"""Image preparation and training minibatches (``frcnn_tpu/data/loader.py``):
``pick_scale_and_bucket``, ``prep_im_for_blob``, ``snap_to_bucket``,
``im_list_to_blob``, ``get_minibatch`` and ``RoIDataLayer``.  Images come
from a ``reader`` callable (image path → BGR uint8 array); the default,
``read_image``, is ``cv2.imread``, and cv2 is imported only there, so a
machine without cv2 passes its own reader.

``get_minibatch`` takes the JAX package's three routes, in its order: a
``ResizedImageCache`` as the reader (``data/cache.py``) gives uint8 batches
of cached views; with no reader, TRAIN.NATIVE_PREP and entries that carry
their sizes, the native C++ prep (``native/data_prep.py``) decodes and
resizes the batch where its library builds; else each image is read,
resized and padded here in f32.

The resize is bilinear in numpy with the sampling of
``cv2.resize(im, None, fx=scale, fy=scale, interpolation=INTER_LINEAR)``:
output size round(size * scale), source coordinate
(dst + 0.5) / scale - 0.5, clamped at the borders, no antialiasing.  The
tests bound the difference from cv2.
"""

from __future__ import annotations

import numpy as np

from frcnn_tpu_torch.utils.trace import span


def read_image(path: str):
    """The default reader: ``cv2.imread`` → (H, W, 3) BGR uint8."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("reading image files needs cv2 (OpenCV), which is not installed; "
                          "pass reader= (image path -> BGR uint8 array)") from e
    im = cv2.imread(path)
    if im is None:
        raise ValueError(f"failed to read {path}")
    return im


def pick_scale_and_bucket(h: int, w: int, target_size: int, max_size: int, buckets):
    """Resize factor (reference prep_im_for_blob math) + smallest bucket that
    holds the scaled image; else the bucket that loses the least
    resolution, with the scale reduced to fit."""
    im_size_min = min(h, w)
    im_size_max = max(h, w)
    scale = float(target_size) / float(im_size_min)
    if np.round(scale * im_size_max) > max_size:
        scale = float(max_size) / float(im_size_max)
    sh, sw = int(np.round(h * scale)), int(np.round(w * scale))
    for bh, bw in sorted(buckets, key=lambda b: b[0] * b[1]):
        if sh <= bh and sw <= bw:
            return scale, (bh, bw)
    bh, bw = max(buckets, key=lambda b: min(b[0] / sh, b[1] / sw))
    shrink = min(bh / sh, bw / sw)
    return scale * shrink, (bh, bw)


def _taps(n_out: int, n_in: int, scale: float):
    """Source indices (lo, hi) and the weight of hi for each output index."""
    src = ((np.arange(n_out) + 0.5) * (1.0 / scale) - 0.5).astype(np.float32)
    lo = np.floor(src).astype(np.int64)
    frac = (src - lo).astype(np.float32)
    frac[lo < 0] = 0.0
    lo[lo < 0] = 0
    edge = lo >= n_in - 1
    frac[edge] = 0.0
    lo[edge] = n_in - 1
    return lo, np.minimum(lo + 1, n_in - 1), frac


def resize_bilinear(im, scale: float):
    """(H, W, C) image → (round(H*scale), round(W*scale), C) float32."""
    h, w = im.shape[:2]
    oh, ow = int(round(h * scale)), int(round(w * scale))
    src = im.astype(np.float32)
    if (oh, ow) == (h, w) and scale == 1.0:
        return src
    y0, y1, fy = _taps(oh, h, scale)
    x0, x1, fx = _taps(ow, w, scale)
    rows = src[y0] * (1.0 - fy)[:, None, None] + src[y1] * fy[:, None, None]
    return rows[:, x0] * (1.0 - fx)[None, :, None] + rows[:, x1] * fx[None, :, None]


def prep_im_for_blob(im, target_size: int, max_size: int, buckets,
                     keep_uint8: bool = False):
    """Resize into a bucket and zero-pad.  Returns (padded (bh, bw, 3) BGR
    raw pixels, scale); mean subtraction happens in the model.  With
    ``keep_uint8`` the padded image is uint8 (rounded), else float32."""
    h, w = im.shape[:2]
    scale, (bh, bw) = pick_scale_and_bucket(h, w, target_size, max_size, buckets)
    resized = resize_bilinear(im, scale)
    dtype = np.uint8 if keep_uint8 and im.dtype == np.uint8 else np.float32
    if dtype == np.uint8:
        resized = np.clip(np.rint(resized), 0, 255)
    out = np.zeros((bh, bw, 3), dtype=dtype)
    rh, rw = min(resized.shape[0], bh), min(resized.shape[1], bw)
    out[:rh, :rw, :] = resized[:rh, :rw]
    return out, scale


def snap_to_bucket(hws, buckets):
    """Smallest configured bucket covering the componentwise max of the
    (h, w) shapes; the componentwise max over all buckets when none does
    (a batch that mixes orientations)."""
    need_h = max(h for h, _ in hws)
    need_w = max(w for _, w in hws)
    fitting = [b for b in buckets if b[0] >= need_h and b[1] >= need_w]
    if fitting:
        return min(fitting, key=lambda b: (b[0] * b[1], b))
    return (max(b[0] for b in buckets), max(b[1] for b in buckets))


def im_list_to_blob(ims):
    """Pad (H, W, 3) images to their max shape → (N, H, W, 3) float32."""
    max_shape = np.array([im.shape for im in ims]).max(axis=0)
    blob = np.zeros((len(ims), max_shape[0], max_shape[1], 3), dtype=np.float32)
    for i, im in enumerate(ims):
        blob[i, : im.shape[0], : im.shape[1], :] = im
    return blob


def _cached_batch(roidb, targets, cache, t, buckets, rows):
    """The resized-cache route: (uint8 data, scales) of the batch's
    ``rows``, or None on a miss anywhere in the batch (an entry absent or
    cached under another MAX_SIZE or BUCKETS).  Flipped entries take a
    negative-stride view; the views are zero-padded into one batch buffer at
    ``snap_to_bucket`` of the whole batch's sizes."""
    got = [cache.get(e["image"], target, t.MAX_SIZE, buckets) for e, target in zip(roidb, targets)]
    if any(g is None for g in got):
        return None
    bh, bw = snap_to_bucket([im.shape[:2] for im, _ in got], buckets)
    got, roidb = got[rows], roidb[rows]
    data = np.zeros((len(got), bh, bw, 3), np.uint8)
    for blob, entry, (im, _) in zip(data, roidb, got):
        if entry.get("flipped", False):
            im = im[:, ::-1]
        blob[: min(im.shape[0], bh), : min(im.shape[1], bw)] = im[:bh, :bw]
    return data, [scale for _, scale in got]


def _native_batch(roidb, targets, t, buckets, rows):
    """The native route: (f32 data, scales) of the batch's ``rows``, the
    scale and bucket from the entries' stored sizes; None where the library
    is unavailable."""
    from frcnn_tpu_torch.native import data_prep

    picked = [pick_scale_and_bucket(e["height"], e["width"], target, t.MAX_SIZE, buckets)
              for e, target in zip(roidb, targets)]
    bucket = snap_to_bucket([bucket for _, bucket in picked], buckets)
    picked, roidb = picked[rows], roidb[rows]
    res = data_prep.prep_batch([e["image"] for e in roidb],
                               [1 if e.get("flipped", False) else 0 for e in roidb],
                               [scale for scale, _ in picked], bucket)
    return None if res is None else (res[0], [scale for scale, _ in picked])


def _decoded_batch(roidb, targets, reader, t, buckets, rows):
    """The Python route: (f32 data, scales, image sizes) of the batch's
    ``rows``: each of their images read, flipped, resized and padded here."""
    def read(entry):
        im = reader(entry["image"])
        if im is None:
            raise ValueError(f"failed to read {entry['image']}")
        return im

    prepped, scales = [], []
    for entry, target in zip(roidb[rows], targets[rows]):
        im = read(entry)
        if entry.get("flipped", False):
            im = im[:, ::-1, :]
        padded, scale = prep_im_for_blob(im, target, t.MAX_SIZE, buckets)
        prepped.append((im.shape[:2], padded))
        scales.append(scale)
    # one static shape per batch: the smallest bucket covering every image's,
    # the other rows' from their sizes (read where an entry has none)
    hws = [p[1].shape[:2] for p in prepped]
    for i, e in enumerate(roidb):
        if rows.start <= i < rows.stop:
            continue
        h, w = (e["height"], e["width"]) if "height" in e else read(e).shape[:2]
        hws.append(pick_scale_and_bucket(h, w, targets[i], t.MAX_SIZE, buckets)[1])
    bucket_hw = snap_to_bucket(hws, buckets)
    data = np.zeros((len(prepped), *bucket_hw, 3), np.float32)
    for blob, (_, padded) in zip(data, prepped):
        blob[: padded.shape[0], : padded.shape[1]] = padded
    return data, scales, [hw for hw, _ in prepped]


def get_minibatch(roidb, cfg, rng=None, reader=None, rows=None):
    """One fixed-shape minibatch from roidb entries: data (B, bh, bw, 3)
    raw BGR (float32, or uint8 from a ``ResizedImageCache``), im_info (B, 3)
    [h, w, scale] of the scaled unpadded image, gt_boxes (B, MAX_GT, 4)
    scaled, gt_labels (B, MAX_GT) int32, gt_valid (B, MAX_GT) bool.

    ``reader``: a ``ResizedImageCache`` (uint8 batches of its views; a miss
    falls through to the routes below), or a callable that maps
    ``entry["image"]`` to a BGR uint8 array.  With none, the native prep
    runs where TRAIN.NATIVE_PREP is set, the entries carry their sizes and
    the library builds; else ``read_image`` reads each image.

    ``rows`` (a slice; default all): the rows of the batch to prepare, as
    a rank of a data mesh does.  The draws, the route and the bucket are the
    whole batch's, so the rows equal those rows of the whole batch; only
    the rows' images are decoded, resized and padded."""
    from frcnn_tpu_torch.data.cache import ResizedImageCache

    rng = rng or np.random
    rows = slice(*(rows or slice(None)).indices(len(roidb)))
    t = cfg.TRAIN
    buckets = cfg.DEVICE.BUCKETS
    max_gt = cfg.DEVICE.MAX_GT
    # per-image scale sampled from TRAIN.SCALES, as the reference minibatch
    targets = [t.SCALES[rng.randint(0, len(t.SCALES))] if len(t.SCALES) > 1
               else t.SCALES[0] for _ in roidb]
    sized = all("width" in e and "height" in e for e in roidb)

    batch = None
    if isinstance(reader, ResizedImageCache):
        batch = _cached_batch(roidb, targets, reader, t, buckets, rows) if sized else None
        reader = None                     # a miss: the decode routes, not a callable
    if batch is None and reader is None and t.NATIVE_PREP and sized:
        batch = _native_batch(roidb, targets, t, buckets, rows)
    if batch is not None:
        data, scales = batch
        dims = [(e["height"], e["width"]) for e in roidb[rows]]
    else:
        data, scales, dims = _decoded_batch(roidb, targets, reader or read_image, t, buckets,
                                            rows)
    infos = [[np.round(h * scale), np.round(w * scale), scale]
             for (h, w), scale in zip(dims, scales)]

    gtb, gtl, gtv = [], [], []
    for entry, scale in zip(roidb[rows], scales):
        gt_inds = np.where(entry["gt_classes"] > 0)[0] \
            if "gt_classes" in entry else np.arange(len(entry["boxes"]))
        boxes = entry["boxes"][gt_inds].astype(np.float32) * scale
        labels = (entry["gt_classes"][gt_inds] if "gt_classes" in entry
                  else np.ones(len(gt_inds))).astype(np.int32)
        n = min(len(boxes), max_gt)
        b = np.zeros((max_gt, 4), np.float32)
        lab = np.zeros((max_gt,), np.int32)
        v = np.zeros((max_gt,), bool)
        b[:n], lab[:n], v[:n] = boxes[:n], labels[:n], True
        gtb.append(b)
        gtl.append(lab)
        gtv.append(v)

    return {"data": data, "im_info": np.asarray(infos, np.float32),
            "gt_boxes": np.stack(gtb), "gt_labels": np.stack(gtl), "gt_valid": np.stack(gtv)}


class RoIDataLayer:
    """Epoch-less minibatch iterator over a shuffled permutation (reference
    lib/roi_data_layer/layer.py), seeded with RNG_SEED.  With batches of
    several images and both bucket orientations configured, each batch is
    orientation-pure, as in the JAX package.  ``random=True`` (the
    validation layer) reseeds each epoch from the global numpy RNG.
    ``get_state``/``set_state`` carry the cursor, the permutation and the
    RNG for an exact resume.  ``rows`` (a slice of the batch): a rank's
    shard; the layer draws as for the whole batch (``get_minibatch``), so
    its state equals the unsharded layer's."""

    def __init__(self, roidb, cfg, random: bool = False, batch_size: int | None = None,
                 reader=None, rows: slice | None = None):
        self._roidb = roidb
        self._cfg = cfg
        self._random = random
        self._batch = batch_size or cfg.TRAIN.IMS_PER_BATCH
        self._reader = reader
        self._rows = rows
        self._rng = np.random.RandomState(cfg.RNG_SEED)
        self._shuffle_roidb_inds()

    def _shuffle_roidb_inds(self):
        if self._random:
            self._rng = np.random.RandomState(np.random.randint(0, 2**31 - 1))
        group = self._cfg.TRAIN.ASPECT_GROUPING or (
            self._batch > 1 and len(self._cfg.DEVICE.BUCKETS) > 1)
        if group and len(self._roidb) > 0:
            widths = np.array([r["width"] for r in self._roidb])
            heights = np.array([r["height"] for r in self._roidb])
            horz = widths >= heights
            b = self._batch
            groups, partial = [], []
            for inds in (np.where(horz)[0], np.where(~horz)[0]):
                inds = self._rng.permutation(inds)
                for i in range(0, len(inds), b):
                    g = inds[i:i + b]
                    (groups if len(g) == b else partial).append(g)
            order = self._rng.permutation(len(groups))
            # full orientation-pure groups first, the partial tails last
            self._perm = np.concatenate([groups[i] for i in order] + partial)
        else:
            self._perm = self._rng.permutation(len(self._roidb))
        self._cur = 0

    def _get_next_minibatch_inds(self):
        if self._cur + self._batch > len(self._roidb):
            self._shuffle_roidb_inds()
        if self._batch <= len(self._roidb):
            inds = self._perm[self._cur: self._cur + self._batch]
            self._cur += self._batch
            return inds
        # a roidb smaller than the batch: chain whole permutations
        out = list(self._perm)
        while len(out) < self._batch:
            self._shuffle_roidb_inds()
            out.extend(self._perm)
        self._cur = len(self._roidb)
        return np.asarray(out[: self._batch])

    def forward(self):
        with span("frcnn.data.forward"):
            inds = self._get_next_minibatch_inds()
            return get_minibatch([self._roidb[i] for i in inds], self._cfg, self._rng,
                                 reader=self._reader, rows=self._rows)

    def get_state(self):
        return {"cur": self._cur, "perm": np.array(self._perm), "rng": self._rng.get_state()}

    def set_state(self, state):
        self._cur = int(state["cur"])
        self._perm = np.asarray(state["perm"])
        self._rng.set_state(state["rng"])
