"""COCO (``frcnn_tpu/data/coco.py``) without pycocotools: the roidb from
``instances_*.json`` (boxes clipped to the image, degenerate ones dropped,
crowds marked -1 in gt_overlaps), a results json, and evaluation through
the numpy ``COCOEval``.

Layout: DATA_DIR/coco/annotations/instances_<split><year>.json and
DATA_DIR/coco/images/<split><year>/<file_name>; minival and
valminusminival read their own annotation files and val2014's images.
"""

from __future__ import annotations

import json
import os.path as osp
import pickle

import numpy as np

from frcnn_tpu_torch.data.imdb import imdb


class coco(imdb):
    def __init__(self, image_set: str, year: str, data_path: str | None = None,
                 data_dir: str | None = None):
        super().__init__(f"coco_{year}_{image_set}")
        self._year = year
        self._image_set = image_set
        from frcnn_tpu_torch.config import cfg

        self._data_dir = data_dir
        self._data_path = data_path or osp.join(data_dir or cfg.DATA_DIR,
                                                "coco")
        self._anno_file = osp.join(
            self._data_path, "annotations",
            f"instances_{image_set}{year}.json")
        if not osp.exists(self._anno_file):
            raise FileNotFoundError(f"annotation file missing: {self._anno_file}")
        with open(self._anno_file) as f:
            dataset = json.load(f)

        cats = sorted(dataset["categories"], key=lambda c: c["id"])
        self._classes = ["__background__"] + [c["name"] for c in cats]
        self._class_to_coco_cat_id = {c["name"]: c["id"] for c in cats}
        self._coco_cat_id_to_class_ind = {
            c["id"]: i + 1 for i, c in enumerate(cats)}
        self._cats = cats

        self._imgs = {img["id"]: img for img in dataset["images"]}
        self._image_index = sorted(self._imgs.keys())
        self._anns_by_img = {}
        for ann in dataset["annotations"]:
            self._anns_by_img.setdefault(ann["image_id"], []).append(ann)
        self._roidb_handler = self.gt_roidb
        # train2014 / val2014 style prefix for image paths
        self._data_name = (
            "val2014" if image_set in ("minival", "valminusminival")
            else image_set + year)
        self.config = {"cleanup": True, "use_salt": True}

    def image_path_at(self, i: int) -> str:
        img = self._imgs[self._image_index[i]]
        file_name = img["file_name"]
        return osp.join(self._data_path, "images", self._data_name, file_name)

    def image_id_at(self, i: int):
        return self._image_index[i]

    def gt_roidb(self):
        cache_file = osp.join(self.cache_path, self.name + "_gt_roidb.pkl")
        if osp.exists(cache_file):
            with open(cache_file, "rb") as f:
                return pickle.load(f)
        roidb = [self._load_coco_annotation(idx) for idx in self._image_index]
        with open(cache_file, "wb") as f:
            pickle.dump(roidb, f)
        return roidb

    def _load_coco_annotation(self, index):
        img = self._imgs[index]
        width, height = img["width"], img["height"]
        objs = []
        for ann in self._anns_by_img.get(index, []):
            # clip to image, drop degenerate (reference does the same)
            x1 = max(0, ann["bbox"][0])
            y1 = max(0, ann["bbox"][1])
            x2 = min(width - 1, x1 + max(0, ann["bbox"][2] - 1))
            y2 = min(height - 1, y1 + max(0, ann["bbox"][3] - 1))
            if ann.get("area", 0) > 0 and x2 >= x1 and y2 >= y1:
                objs.append((ann, [x1, y1, x2, y2]))
        num_objs = len(objs)
        boxes = np.zeros((num_objs, 4), dtype=np.uint16)
        gt_classes = np.zeros(num_objs, dtype=np.int32)
        overlaps = np.zeros((num_objs, self.num_classes), dtype=np.float32)
        seg_areas = np.zeros(num_objs, dtype=np.float32)
        for ix, (ann, box) in enumerate(objs):
            cls = self._coco_cat_id_to_class_ind[ann["category_id"]]
            boxes[ix, :] = box
            gt_classes[ix] = cls
            seg_areas[ix] = ann.get("area", 0)
            if ann.get("iscrowd", 0):
                overlaps[ix, :] = -1.0  # reference marks crowds with -1
            else:
                overlaps[ix, cls] = 1.0
        return {
            "width": width,
            "height": height,
            "boxes": boxes,
            "gt_classes": gt_classes,
            "gt_overlaps": overlaps,
            "flipped": False,
            "seg_areas": seg_areas,
        }

    # -- results / evaluation ---------------------------------------------------
    def _results_to_json(self, all_boxes):
        results = []
        for cls_ind, cls in enumerate(self.classes):
            if cls == "__background__":
                continue
            cat_id = self._class_to_coco_cat_id[cls]
            for im_ind, index in enumerate(self._image_index):
                dets = all_boxes[cls_ind][im_ind]
                if len(dets) == 0:
                    continue
                dets = np.asarray(dets, dtype=np.float64)
                xs, ys = dets[:, 0], dets[:, 1]
                ws = dets[:, 2] - xs + 1
                hs = dets[:, 3] - ys + 1
                for k in range(dets.shape[0]):
                    results.append({
                        "image_id": int(index),
                        "category_id": int(cat_id),
                        "bbox": [float(xs[k]), float(ys[k]),
                                 float(ws[k]), float(hs[k])],
                        "score": float(dets[k, -1]),
                    })
        return results

    def evaluate_detections(self, all_boxes, output_dir=None):
        from frcnn_tpu_torch.data.coco_eval import COCOEval

        results = self._results_to_json(all_boxes)
        if output_dir:
            res_file = osp.join(output_dir, f"detections_{self.name}_results.json")
            with open(res_file, "w") as f:
                json.dump(results, f)
            print(f"Wrote COCO results to {res_file}")
        if "test" in self._image_set:
            print("test split: no annotations — results file only")
            return {}
        gts = []
        for index in self._image_index:
            for ann in self._anns_by_img.get(index, []):
                gts.append({
                    "id": ann["id"],
                    "image_id": ann["image_id"],
                    "category_id": ann["category_id"],
                    "bbox": list(ann["bbox"]),
                    "area": ann.get("area", ann["bbox"][2] * ann["bbox"][3]),
                    "iscrowd": ann.get("iscrowd", 0),
                })
        ev = COCOEval(gts, results, self._cats)
        ev.evaluate()
        ev.accumulate()
        return ev.summarize()

    def competition_mode(self, on: bool):
        self.config["use_salt"] = not on
        self.config["cleanup"] = not on
