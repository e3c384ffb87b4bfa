"""The Pascal VOC detection evaluator (``frcnn_tpu/data/voc_eval.py``):
greedy confidence-ordered TP/FP matching at an IoU threshold with VOC's
inclusive pixel corners, difficult gt boxes neither counting nor
penalising, and both AP metrics (11-point interpolation for VOC <= 2009,
the area under the monotone precision envelope otherwise), with the
annotations cached in a pkl per image set.
"""

from __future__ import annotations

import os
import pickle
import xml.etree.ElementTree as ET

import numpy as np


def parse_rec(filename: str):
    """Parse one VOC xml annotation into a list of object dicts
    (name/pose/truncated/difficult/bbox, bbox in the file's 1-based coords)."""

    def text_of(node, tag, default=None):
        child = node.find(tag)
        return child.text if child is not None else default

    objects = []
    for obj in ET.parse(filename).findall("object"):
        corners = obj.find("bndbox")
        objects.append({
            "name": text_of(obj, "name"),
            "pose": text_of(obj, "pose", ""),
            "truncated": int(text_of(obj, "truncated", 0)),
            "difficult": int(text_of(obj, "difficult", 0)),
            "bbox": [int(float(text_of(corners, t)))
                     for t in ("xmin", "ymin", "xmax", "ymax")],
        })
    return objects


def voc_ap(rec, prec, use_07_metric: bool = False):
    """Average precision from a recall/precision curve.

    use_07_metric: mean of max-precision at the 11 recall points 0, .1 .. 1
    (VOC <= 2009); otherwise exact area under the monotone-decreasing
    precision envelope.
    """
    rec, prec = np.asarray(rec), np.asarray(prec)
    if use_07_metric:
        points = []
        for level in np.arange(0.0, 1.1, 0.1):
            above = prec[rec >= level]
            points.append(above.max() if above.size else 0.0)
        return float(np.mean(points))
    # envelope: prepend/append sentinels, make precision non-increasing
    # right-to-left, integrate over recall steps
    r = np.concatenate(([0.0], rec, [1.0]))
    p = np.concatenate(([0.0], prec, [0.0]))
    p = np.maximum.accumulate(p[::-1])[::-1]
    steps = np.flatnonzero(r[1:] != r[:-1])
    return float(np.sum((r[steps + 1] - r[steps]) * p[steps + 1]))


def _iou_one_to_many(box, gt):
    """IoU of one box (4,) against gt (G, 4), inclusive-corner VOC pixels."""
    lo = np.maximum(gt[:, :2], box[:2])
    hi = np.minimum(gt[:, 2:], box[2:])
    wh = np.maximum(hi - lo + 1.0, 0.0)
    inter = wh[:, 0] * wh[:, 1]
    area = lambda b: (b[..., 2] - b[..., 0] + 1.0) * (b[..., 3] - b[..., 1] + 1.0)
    return inter / (area(box) + area(gt) - inter)


class _ImageGt:
    """Ground truth of one class in one image, with greedy-match state."""

    __slots__ = ("boxes", "difficult", "claimed")

    def __init__(self, objs, use_diff: bool):
        self.boxes = np.array([o["bbox"] for o in objs], dtype=float)
        self.difficult = (np.zeros(len(objs), bool) if use_diff else
                          np.array([o["difficult"] for o in objs], bool))
        self.claimed = np.zeros(len(objs), bool)

    @property
    def n_counted(self) -> int:
        return int((~self.difficult).sum())

    def match(self, box, thresh: float):
        """Greedily match a detection: returns 'tp', 'fp' or 'ignore'."""
        if len(self.boxes) == 0:
            return "fp"
        iou = _iou_one_to_many(box, self.boxes)
        j = int(iou.argmax())
        if iou[j] <= thresh:
            return "fp"
        if self.difficult[j]:
            return "ignore"
        if self.claimed[j]:
            return "fp"  # duplicate detection of an already-matched gt
        self.claimed[j] = True
        return "tp"


def _load_annotations(annopath, imagesetfile, cachedir):
    """All annotations for the image set, through the reference's pkl cache."""
    with open(imagesetfile) as f:
        image_ids = [line.strip() for line in f if line.strip()]
    os.makedirs(cachedir, exist_ok=True)
    cachefile = os.path.join(cachedir, "annots.pkl")
    if os.path.isfile(cachefile):
        with open(cachefile, "rb") as f:
            return image_ids, pickle.load(f)
    annots = {img: parse_rec(annopath % img) for img in image_ids}
    with open(cachefile, "wb") as f:
        pickle.dump(annots, f)
    return image_ids, annots


def voc_eval(detpath, annopath, imagesetfile, classname, cachedir,
             ovthresh: float = 0.5, use_07_metric: bool = False,
             use_diff: bool = False):
    """VOC detection evaluation for one class → (recall, precision, ap).

    detpath: per-class results-file template (``detpath % classname``), one
    detection per line as ``image_id score x1 y1 x2 y2``; annopath: xml
    template (``annopath % image_id``); imagesetfile: one image id per line.
    """
    image_ids, annots = _load_annotations(annopath, imagesetfile, cachedir)
    gt = {img: _ImageGt([o for o in annots[img] if o["name"] == classname],
                        use_diff)
          for img in image_ids}
    n_positive = sum(g.n_counted for g in gt.values())

    with open(detpath % classname) as f:
        rows = [line.split() for line in f if line.strip()]
    det_imgs = [r[0] for r in rows]
    det_scores = np.array([float(r[1]) for r in rows])
    det_boxes = np.array([[float(v) for v in r[2:6]] for r in rows])

    # confidence-descending greedy matching
    order = np.argsort(-det_scores)
    true_pos = np.zeros(len(rows))
    false_pos = np.zeros(len(rows))
    for rank, d in enumerate(order):
        outcome = gt[det_imgs[d]].match(det_boxes[d], ovthresh)
        if outcome == "tp":
            true_pos[rank] = 1.0
        elif outcome == "fp":
            false_pos[rank] = 1.0

    tp_cum = np.cumsum(true_pos)
    fp_cum = np.cumsum(false_pos)
    recall = tp_cum / float(max(n_positive, 1))
    precision = tp_cum / np.maximum(tp_cum + fp_cum,
                                    np.finfo(np.float64).eps)
    return recall, precision, voc_ap(recall, precision, use_07_metric)
