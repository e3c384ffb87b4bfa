"""COCO bbox evaluation in numpy (``frcnn_tpu/data/coco_eval.py``), no
pycocotools: 10 IoU thresholds 0.50:0.05:0.95, 101-point interpolated
precision over recall, the all/small/medium/large area ranges, maxDets
(1, 10, 100), crowd-aware IoU and the standard 12-number summary.

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


def bbox_iou_xywh(dt, gt, iscrowd):
    """IoU of xywh boxes; for crowd gt, intersection over det area
    (pycocotools maskUtils.iou semantics)."""
    n, k = len(dt), len(gt)
    out = np.zeros((n, k))
    for j in range(k):
        gx, gy, gw, gh = gt[j]
        garea = gw * gh
        for i in range(n):
            dx, dy, dw, dh = dt[i]
            iw = min(dx + dw, gx + gw) - max(dx, gx)
            ih = min(dy + dh, gy + gh) - max(dy, gy)
            if iw <= 0 or ih <= 0:
                continue
            inter = iw * ih
            union = dw * dh if iscrowd[j] else dw * dh + garea - inter
            out[i, j] = inter / union
    return out


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
        self.eval = None

    # -- per-(img, cat) matching --------------------------------------------
    def _evaluate_img(self, img_id, cat_id, area_rng, max_det):
        gt = self._gts[img_id, cat_id]
        dt = self._dts[img_id, cat_id]
        if len(gt) == 0 and len(dt) == 0:
            return None
        for g in gt:
            g["_ignore"] = 1 if (g["ignore"] or g["area"] < area_rng[0]
                                 or g["area"] > area_rng[1]) else 0
        # sort gt: non-ignored first; dt by descending score, truncate maxDet
        gtind = np.argsort([g["_ignore"] for g in gt], kind="mergesort")
        gt = [gt[i] for i in gtind]
        dtind = np.argsort([-d["score"] for d in dt], kind="mergesort")
        dt = [dt[i] for i in dtind[:max_det]]
        iscrowd = [int(g["iscrowd"]) for g in gt]

        ious = bbox_iou_xywh([d["bbox"] for d in dt], [g["bbox"] for g in gt],
                             iscrowd) if dt and gt else np.zeros((len(dt), len(gt)))

        T = len(IOU_THRS)
        G, D = len(gt), len(dt)
        gtm = np.zeros((T, G))
        dtm = np.zeros((T, D))
        gt_ig = np.array([g["_ignore"] for g in gt])
        dt_ig = np.zeros((T, D))
        for ti, t in enumerate(IOU_THRS):
            for di in range(D):
                iou = min(t, 1 - 1e-10)
                m = -1
                for gi in range(G):
                    # gi already matched (crowds can absorb many dets)
                    if gtm[ti, gi] > 0 and not iscrowd[gi]:
                        continue
                    # non-ignored gts exhausted; stop at first ignored match
                    if m > -1 and gt_ig[m] == 0 and gt_ig[gi] == 1:
                        break
                    if ious[di, gi] < iou:
                        continue
                    iou = ious[di, gi]
                    m = gi
                if m == -1:
                    continue
                dt_ig[ti, di] = gt_ig[m]
                dtm[ti, di] = gt[m]["id"]
                gtm[ti, m] = 1
        # unmatched dets outside the area range are ignored too
        a = np.array([d["bbox"][2] * d["bbox"][3] < area_rng[0]
                      or d["bbox"][2] * d["bbox"][3] > area_rng[1]
                      for d in dt]).reshape(1, -1) if D else np.zeros((1, 0), bool)
        dt_ig = np.logical_or(dt_ig, np.logical_and(dtm == 0, np.repeat(a, T, 0)))
        return {
            "dtMatches": dtm,
            "dtScores": np.array([d["score"] for d in dt]),
            "gtIgnore": gt_ig,
            "dtIgnore": dt_ig,
        }

    def evaluate(self):
        for area_name, area_rng in AREA_RNG.items():
            for img_id in self.img_ids:
                for cat_id in self.cat_ids:
                    self.eval_imgs[area_name, img_id, cat_id] = \
                        self._evaluate_img(img_id, cat_id, area_rng, MAX_DETS[-1])

    # -- accumulation ----------------------------------------------------------
    def accumulate(self):
        T, R = len(IOU_THRS), len(REC_THRS)
        K, A, M = len(self.cat_ids), len(AREA_RNG), len(MAX_DETS)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        for ki, cat_id in enumerate(self.cat_ids):
            for ai, area_name in enumerate(AREA_RNG):
                for mi, max_det in enumerate(MAX_DETS):
                    E = [self.eval_imgs[area_name, img_id, cat_id]
                         for img_id in self.img_ids]
                    E = [e for e in E if e is not None]
                    if not E:
                        continue
                    scores = np.concatenate([e["dtScores"][:max_det] for e in E])
                    inds = np.argsort(-scores, kind="mergesort")
                    dtm = np.concatenate(
                        [e["dtMatches"][:, :max_det] for e in E], axis=1)[:, inds]
                    dt_ig = np.concatenate(
                        [e["dtIgnore"][:, :max_det] for e in E], axis=1)[:, inds]
                    gt_ig = np.concatenate([e["gtIgnore"] for e in E])
                    npig = np.count_nonzero(gt_ig == 0)
                    if npig == 0:
                        continue
                    tps = np.logical_and(dtm, np.logical_not(dt_ig))
                    fps = np.logical_and(np.logical_not(dtm),
                                         np.logical_not(dt_ig))
                    tp_sum = np.cumsum(tps, axis=1).astype(float)
                    fp_sum = np.cumsum(fps, axis=1).astype(float)
                    for ti in range(T):
                        tp, fp = tp_sum[ti], fp_sum[ti]
                        rc = tp / npig
                        pr = tp / np.maximum(tp + fp, np.finfo(float).eps)
                        recall[ti, ki, ai, mi] = rc[-1] if len(rc) else 0
                        # monotone precision envelope from the right
                        pr = pr.tolist()
                        for i in range(len(pr) - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds_r = np.searchsorted(rc, REC_THRS, side="left")
                        q = np.zeros(R)
                        for ri, pi in enumerate(inds_r):
                            if pi < len(pr):
                                q[ri] = pr[pi]
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
