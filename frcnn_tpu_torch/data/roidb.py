"""roidb preparation (``frcnn_tpu/data/roidb.py``): attach each entry's
image path and size and per-box max-overlap metadata."""

from __future__ import annotations

import numpy as np


def prepare_roidb(imdb, image_size=None):
    """Enrich ``imdb.roidb`` in place.  An entry's (height, width) comes from
    the entry when it has both, else from ``image_size(path)``; a flipped
    entry has its original's size."""
    sizes = {}
    for i, entry in enumerate(imdb.roidb):
        path = imdb.image_path_at(i)
        entry["image"] = path
        if "height" not in entry or "width" not in entry:
            if path not in sizes:
                if image_size is None:
                    raise ValueError(f"no size for {path}: pass image_size=")
                sizes[path] = image_size(path)
            entry["height"], entry["width"] = sizes[path]
        gt_overlaps = np.asarray(entry["gt_overlaps"])
        if len(gt_overlaps):
            entry["max_overlaps"] = gt_overlaps.max(axis=1)
            entry["max_classes"] = gt_overlaps.argmax(axis=1)
        else:
            entry["max_overlaps"] = np.zeros(0)
            entry["max_classes"] = np.zeros(0, np.int32)
