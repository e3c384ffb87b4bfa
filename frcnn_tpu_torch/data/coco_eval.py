"""COCO bbox evaluation in numpy (``frcnn_tpu/data/coco_eval.py``), no
pycocotools: 10 IoU thresholds 0.50:0.05:0.95, 101-point interpolated
precision over recall, the all/small/medium/large area ranges, maxDets
(1, 10, 100), crowd-aware IoU and the standard 12-number summary.

The JAX module's loops, vectorised with the same results (``eval_imgs``
entry for entry, the stats bit for bit): the IoU by broadcasting, once per
(image, category) for the four area ranges; the greedy match over all
ranges and thresholds at once, a det at a time, visiting only the dets
with an IoU of at least 0.5; the precision envelope by a running maximum.

API:
    ev = COCOEval(gt_annotations, detections, categories)
    ev.evaluate(); ev.accumulate(); stats = ev.summarize()

gt_annotations: list of dicts {image_id, category_id, bbox [x,y,w,h],
area, iscrowd, id}; detections: list of dicts {image_id, category_id,
bbox [x,y,w,h], score}.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.00, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = (1, 10, 100)
_RANGES = np.array(list(AREA_RNG.values()))                             # (A, 2)
_THR = np.minimum(IOU_THRS, 1 - 1e-10)[None, :, None]                   # (1, T, 1)


def bbox_iou_xywh(dt, gt, iscrowd):
    """IoU of xywh boxes (D, 4) x (G, 4) → (D, G) f64; for crowd gt,
    intersection over det area (pycocotools maskUtils.iou semantics).  Each
    entry is the loop form's ``inter / union`` in the same f64 steps."""
    d = np.asarray(dt, dtype=np.float64).reshape(-1, 4)[:, None, :]
    g = np.asarray(gt, dtype=np.float64).reshape(-1, 4)[None, :, :]
    crowd = np.asarray(iscrowd, dtype=bool).reshape(1, -1)
    iw = np.minimum(d[..., 0] + d[..., 2], g[..., 0] + g[..., 2]) - np.maximum(d[..., 0], g[..., 0])
    ih = np.minimum(d[..., 1] + d[..., 3], g[..., 1] + g[..., 3]) - np.maximum(d[..., 1], g[..., 1])
    inter = iw * ih
    d_area = d[..., 2] * d[..., 3]
    union = np.where(crowd, d_area, d_area + g[..., 2] * g[..., 3] - inter)
    live = (iw > 0) & (ih > 0)
    return np.divide(inter, union, out=np.zeros(inter.shape), where=live)


class COCOEval:
    def __init__(self, gts, dts, categories):
        self.cat_ids = sorted({c["id"] for c in categories}) \
            if categories and isinstance(categories[0], dict) else sorted(categories)
        self.img_ids = sorted({g["image_id"] for g in gts}
                              | {d["image_id"] for d in dts})
        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        for g in gts:
            g.setdefault("iscrowd", 0)
            g.setdefault("ignore", g["iscrowd"])
            g.setdefault("area", g["bbox"][2] * g["bbox"][3])
            self._gts[g["image_id"], g["category_id"]].append(g)
        for d in dts:
            self._dts[d["image_id"], d["category_id"]].append(d)
        self.eval_imgs = {}
        self._cells = {}       # (area, cat) → the non-empty evals in image order
        self.eval = None

    # -- per-(img, cat) matching --------------------------------------------
    def _evaluate_pair(self, img_id, cat_id, max_det):
        """The evals of one (image, category) under every area range, as
        pycocotools' evaluateImg gives them, or None with no gt and no det.

        The IoU matrix is computed once for the four ranges.  The greedy
        match walks the dets in score order; for each it takes, under every
        (range, threshold) at once, the best gt it may still take: among the
        gts not yet matched (a crowd may take many dets) with IoU >= the
        threshold, those the range does not ignore first, the highest IoU,
        and on a tie the last in the gts' order (non-ignored first, each
        part in input order): the per-det loop's choice, break rule
        included."""
        gt = self._gts.get((img_id, cat_id), [])
        dt = self._dts.get((img_id, cat_id), [])
        if not gt and not dt:
            return None
        T, A, G = len(IOU_THRS), len(_RANGES), len(gt)
        scores = np.array([d["score"] for d in dt])
        order = np.argsort(-scores, kind="mergesort")[:max_det]
        D = len(order)
        d_scores = scores[order] if D else np.array([])
        d_boxes = np.array([dt[i]["bbox"] for i in order], dtype=np.float64).reshape(-1, 4)
        d_area = d_boxes[:, 2] * d_boxes[:, 3]
        outside = (d_area[None] < _RANGES[:, :1]) | (d_area[None] > _RANGES[:, 1:])  # (A, D)
        if not G:                  # nothing to match: a det is ignored where outside the range
            return [{"dtMatches": np.zeros((T, D)), "dtScores": d_scores,
                     "gtIgnore": np.array([]), "dtIgnore": np.repeat(outside[a:a + 1], T, 0)}
                    for a in range(A)]
        g_area = np.array([g["area"] for g in gt], dtype=np.float64)
        ignore = (np.array([bool(g["ignore"]) for g in gt], dtype=bool)[None]
                  | (g_area[None] < _RANGES[:, :1]) | (g_area[None] > _RANGES[:, 1:]))  # (A, G)
        crowd = np.array([bool(int(g["iscrowd"])) for g in gt], dtype=bool)
        g_ids = np.array([g["id"] for g in gt], dtype=np.float64)

        dtm = np.zeros((A, T, D))
        dt_ig = np.zeros((A, T, D), dtype=bool)
        if D:
            ious = bbox_iou_xywh(d_boxes, [g["bbox"] for g in gt], crowd)
            taken = np.zeros((A, T, G), dtype=bool)
            ign = ignore[:, None, :]
            for di in np.flatnonzero(ious.max(axis=1) >= _THR.min()):
                cand = (~taken | crowd) & (ious[di] >= _THR)                   # (A, T, G)
                keep = cand & ~ign
                part = np.where(keep.any(-1, keepdims=True), keep, cand & ign)
                found = part.any(-1)
                if not found.any():
                    continue
                # the last maximum: argmax over the reversed gts
                m = G - 1 - np.where(part, ious[di], -1.0)[..., ::-1].argmax(-1)  # (A, T)
                a, t = np.nonzero(found)
                m = m[a, t]
                taken[a, t, m] = True
                dtm[a, t, di] = g_ids[m]
                dt_ig[a, t, di] = ignore[a, m]
        # unmatched dets outside the area range are ignored too
        dt_ig |= (dtm == 0) & outside[:, None, :]
        return [{"dtMatches": dtm[a], "dtScores": d_scores,
                 "gtIgnore": np.sort(ignore[a]).astype(int), "dtIgnore": dt_ig[a]}
                for a in range(A)]

    def evaluate(self):
        self.eval_imgs = dict.fromkeys(
            (area, img_id, cat_id) for area in AREA_RNG for img_id in self.img_ids
            for cat_id in self.cat_ids)
        self._cells = {}
        cats = set(self.cat_ids)
        pairs = sorted(key for key in set(self._gts) | set(self._dts) if key[1] in cats)
        for img_id, cat_id in pairs:                    # image order within each category
            evals = self._evaluate_pair(img_id, cat_id, MAX_DETS[-1])
            for area, e in zip(AREA_RNG, evals):
                self.eval_imgs[area, img_id, cat_id] = e
                self._cells.setdefault((area, cat_id), []).append(e)

    # -- accumulation ----------------------------------------------------------
    def accumulate(self):
        T, R = len(IOU_THRS), len(REC_THRS)
        K, A, M = len(self.cat_ids), len(AREA_RNG), len(MAX_DETS)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        for ki, cat_id in enumerate(self.cat_ids):
            for ai, area_name in enumerate(AREA_RNG):
                E = self._cells.get((area_name, cat_id))
                if not E:
                    continue
                gt_ig = np.concatenate([e["gtIgnore"] for e in E])
                npig = np.count_nonzero(gt_ig == 0)
                if npig == 0:
                    continue
                # every image's dets once, with their rank in the image: the
                # first max_det of each image are those of rank < max_det
                all_scores = np.concatenate([e["dtScores"] for e in E])
                all_dtm = np.concatenate([e["dtMatches"] for e in E], axis=1)
                all_ig = np.concatenate([e["dtIgnore"] for e in E], axis=1)
                counts = np.array([len(e["dtScores"]) for e in E])
                rank = np.arange(len(all_scores)) - np.repeat(np.cumsum(counts) - counts, counts)
                for mi, max_det in enumerate(MAX_DETS):
                    cut = rank < max_det
                    scores = all_scores[cut]
                    inds = np.flatnonzero(cut)[np.argsort(-scores, kind="mergesort")]
                    dtm = all_dtm[:, inds]
                    dt_ig = all_ig[:, inds]
                    tps = np.logical_and(dtm, np.logical_not(dt_ig))
                    fps = np.logical_and(np.logical_not(dtm),
                                         np.logical_not(dt_ig))
                    tp_sum = np.cumsum(tps, axis=1).astype(float)
                    fp_sum = np.cumsum(fps, axis=1).astype(float)
                    rc = tp_sum / npig
                    pr = tp_sum / np.maximum(tp_sum + fp_sum, np.finfo(float).eps)
                    n = rc.shape[1]
                    recall[:, ki, ai, mi] = rc[:, -1] if n else 0
                    # monotone precision envelope from the right
                    pr = np.maximum.accumulate(pr[:, ::-1], axis=1)[:, ::-1]
                    for ti in range(T):
                        inds_r = np.searchsorted(rc[ti], REC_THRS, side="left")
                        hit = inds_r < n
                        q = np.zeros(R)
                        q[hit] = pr[ti, inds_r[hit]]
                        precision[ti, :, ki, ai, mi] = q
        self.eval = {"precision": precision, "recall": recall}

    # -- summary ----------------------------------------------------------------
    def _summarize(self, ap=1, iou_thr=None, area="all", max_dets=100):
        ai = list(AREA_RNG).index(area)
        mi = MAX_DETS.index(max_dets)
        if ap:
            s = self.eval["precision"]
            if iou_thr is not None:
                s = s[[np.where(np.isclose(IOU_THRS, iou_thr))[0][0]]]
            s = s[:, :, :, ai, mi]
        else:
            s = self.eval["recall"]
            if iou_thr is not None:
                s = s[[np.where(np.isclose(IOU_THRS, iou_thr))[0][0]]]
            s = s[:, :, ai, mi]
        valid = s[s > -1]
        return float(np.mean(valid)) if valid.size else -1.0

    def summarize(self, verbose: bool = True):
        stats = {
            "AP": self._summarize(1),
            "AP50": self._summarize(1, iou_thr=0.5),
            "AP75": self._summarize(1, iou_thr=0.75),
            "APs": self._summarize(1, area="small"),
            "APm": self._summarize(1, area="medium"),
            "APl": self._summarize(1, area="large"),
            "AR1": self._summarize(0, max_dets=1),
            "AR10": self._summarize(0, max_dets=10),
            "AR100": self._summarize(0),
            "ARs": self._summarize(0, area="small"),
            "ARm": self._summarize(0, area="medium"),
            "ARl": self._summarize(0, area="large"),
        }
        if verbose:
            names = {
                "AP": "Average Precision  (AP) @[ IoU=0.50:0.95 | area=   all | maxDets=100 ]",
                "AP50": "Average Precision  (AP) @[ IoU=0.50      | area=   all | maxDets=100 ]",
                "AP75": "Average Precision  (AP) @[ IoU=0.75      | area=   all | maxDets=100 ]",
                "APs": "Average Precision  (AP) @[ IoU=0.50:0.95 | area= small | maxDets=100 ]",
                "APm": "Average Precision  (AP) @[ IoU=0.50:0.95 | area=medium | maxDets=100 ]",
                "APl": "Average Precision  (AP) @[ IoU=0.50:0.95 | area= large | maxDets=100 ]",
                "AR1": "Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all | maxDets=  1 ]",
                "AR10": "Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all | maxDets= 10 ]",
                "AR100": "Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all | maxDets=100 ]",
                "ARs": "Average Recall     (AR) @[ IoU=0.50:0.95 | area= small | maxDets=100 ]",
                "ARm": "Average Recall     (AR) @[ IoU=0.50:0.95 | area=medium | maxDets=100 ]",
                "ARl": "Average Recall     (AR) @[ IoU=0.50:0.95 | area= large | maxDets=100 ]",
            }
            for k, v in stats.items():
                print(f" {names[k]} = {v:.3f}")
        return stats
