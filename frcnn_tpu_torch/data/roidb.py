"""roidb preparation (``frcnn_tpu/data/roidb.py``): attach each entry's
image path and size and per-box max-overlap metadata."""

from __future__ import annotations

import numpy as np

from frcnn_tpu_torch.data import loader


def _image_sizes(imdb, image_size=None):
    """(height, width) of every roidb entry: the entry's own when it has
    both, else ``image_size(path)`` (default: the image read by
    ``loader.read_image``), read once per path."""
    image_size = image_size or (lambda path: loader.read_image(path).shape[:2])
    cache, sizes = {}, []
    for i, entry in enumerate(imdb.roidb):
        if "height" in entry and "width" in entry:
            sizes.append((entry["height"], entry["width"]))
            continue
        path = imdb.image_path_at(i)
        if path not in cache:
            cache[path] = tuple(image_size(path))
        sizes.append(cache[path])
    return sizes


def prepare_roidb(imdb, image_size=None):
    """Enrich ``imdb.roidb`` in place with each entry's image path, its
    (height, width) from ``_image_sizes``, and max_overlaps / max_classes."""
    for i, (entry, (h, w)) in enumerate(zip(imdb.roidb, _image_sizes(imdb, image_size))):
        entry["image"] = imdb.image_path_at(i)
        entry["height"], entry["width"] = h, w
        gt_overlaps = np.asarray(entry["gt_overlaps"])
        if len(gt_overlaps):
            entry["max_overlaps"] = gt_overlaps.max(axis=1)
            entry["max_classes"] = gt_overlaps.argmax(axis=1)
        else:
            entry["max_overlaps"] = np.zeros(0)
            entry["max_classes"] = np.zeros(0, np.int32)
