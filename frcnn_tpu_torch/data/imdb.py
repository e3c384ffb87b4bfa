"""imdb: the image-database base class (``frcnn_tpu/data/imdb.py``): a lazy
roidb through a pluggable handler and its pkl cache directory, horizontal
flips (``append_flipped_images``: x1' = W - x2 - 1, doubling the roidb),
proposal recall, roidb merging, competition mode, and the
``evaluate_detections`` contract (all_boxes[class][image] = (k, 5)
[x1, y1, x2, y2, score]).  IoUs come from the port's ``bbox_overlaps`` on
CPU tensors."""

from __future__ import annotations

import os
import os.path as osp

import numpy as np
import torch

from frcnn_tpu_torch.data import loader
from frcnn_tpu_torch.ops.boxes import bbox_overlaps


class imdb:
    def __init__(self, name: str, classes=None):
        self._name = name
        self._classes = classes or []
        self._image_index = []
        self._roidb = None
        self._roidb_handler = self.default_roidb
        self._data_dir = None
        self.config = {}

    @property
    def name(self):
        return self._name

    @property
    def num_classes(self):
        return len(self._classes)

    @property
    def classes(self):
        return self._classes

    @property
    def image_index(self):
        return self._image_index

    @property
    def num_images(self):
        return len(self.image_index)

    @property
    def roidb_handler(self):
        return self._roidb_handler

    @roidb_handler.setter
    def roidb_handler(self, val):
        self._roidb_handler = val

    def set_proposal_method(self, method: str):
        self._roidb_handler = getattr(self, method + "_roidb")

    @property
    def roidb(self):
        if self._roidb is None:
            self._roidb = self.roidb_handler()
        return self._roidb

    def default_roidb(self):
        raise NotImplementedError

    def gt_roidb(self):
        raise NotImplementedError

    @property
    def cache_path(self):
        """<data_dir>/cache, created; data_dir is the instance's, else the
        module config's DATA_DIR."""
        from frcnn_tpu_torch.config import cfg

        path = osp.join(self._data_dir or cfg.DATA_DIR, "cache")
        os.makedirs(path, exist_ok=True)
        return path

    def image_path_at(self, i: int) -> str:
        raise NotImplementedError

    def image_id_at(self, i: int):
        return i

    def _get_widths(self):
        return [loader.read_image(self.image_path_at(i)).shape[1] for i in range(self.num_images)]

    def append_flipped_images(self):
        """Double the roidb with horizontally flipped entries; widths come
        from the entries when every one has its size, else from the images."""
        num_images = self.num_images
        if all("width" in r for r in self.roidb):
            widths = [r["width"] for r in self.roidb]
        else:
            widths = self._get_widths()
        for i in range(num_images):
            boxes = self.roidb[i]["boxes"].copy()
            oldx1 = boxes[:, 0].copy()
            oldx2 = boxes[:, 2].copy()
            boxes[:, 0] = widths[i] - oldx2 - 1
            boxes[:, 2] = widths[i] - oldx1 - 1
            if not (boxes[:, 2] >= boxes[:, 0]).all():
                raise ValueError(f"flipped boxes of image {i} have x2 < x1 (width {widths[i]})")
            entry = {k: v for k, v in self.roidb[i].items() if k not in ("boxes", "flipped")}
            entry["boxes"] = boxes
            entry["flipped"] = True
            self.roidb.append(entry)
        self._image_index = self._image_index * 2

    def evaluate_detections(self, all_boxes, output_dir=None):
        raise NotImplementedError

    def evaluate_recall(self, candidate_boxes=None, thresholds=None, area="all", limit=None):
        """Proposal recall over every area: the share of gt boxes matched at
        each IoU threshold, and their mean (AR)."""
        if thresholds is None:
            thresholds = np.arange(0.5, 0.95 + 1e-5, 0.05)
        gt_total = 0
        max_overlaps_all = []
        for i in range(self.num_images):
            entry = self.roidb[i]
            gt_inds = np.where(entry["gt_classes"] > 0)[0]
            gt_boxes = entry["boxes"][gt_inds]
            gt_total += len(gt_inds)
            if candidate_boxes is None:
                boxes = entry["boxes"][np.where(entry["gt_classes"] == 0)[0]]
            else:
                boxes = candidate_boxes[i]
            if limit is not None:
                boxes = boxes[:limit]
            if boxes.shape[0] == 0 or gt_boxes.shape[0] == 0:
                continue
            ov = bbox_overlaps(torch.from_numpy(np.asarray(boxes, np.float32)),
                               torch.from_numpy(np.asarray(gt_boxes, np.float32))).numpy()
            max_overlaps_all.append(ov.max(axis=0))
        if gt_total == 0:
            return {"recalls": np.zeros_like(thresholds), "thresholds": thresholds,
                    "ar": 0.0, "gt_overlaps": np.zeros(0)}
        gt_overlaps = np.sort(np.concatenate(max_overlaps_all) if max_overlaps_all
                              else np.zeros(0))
        recalls = np.array([(gt_overlaps >= t).sum() / float(gt_total) for t in thresholds])
        return {"ar": recalls.mean(), "recalls": recalls, "thresholds": thresholds,
                "gt_overlaps": gt_overlaps}

    def competition_mode(self, on: bool):
        """Dataset-specific evaluation settings (VOC: results-file salt, cleanup)."""

    @staticmethod
    def merge_roidbs(a, b):
        if len(a) != len(b):
            raise ValueError(f"merge_roidbs: {len(a)} entries against {len(b)}")
        for i in range(len(a)):
            a[i]["boxes"] = np.vstack((a[i]["boxes"], b[i]["boxes"]))
            a[i]["gt_classes"] = np.hstack((a[i]["gt_classes"], b[i]["gt_classes"]))
            a[i]["gt_overlaps"] = np.vstack((a[i]["gt_overlaps"], b[i]["gt_overlaps"]))
            a[i]["seg_areas"] = np.hstack((a[i]["seg_areas"], b[i]["seg_areas"]))
        return a
