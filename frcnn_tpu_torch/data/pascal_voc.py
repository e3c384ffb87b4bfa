"""Pascal VOC (``frcnn_tpu/data/pascal_voc.py``): 21 classes
(__background__ + 20), the VOCdevkit layout, Annotations XML parsed into a
gt roidb (1-based pixels made 0-based, difficult objects dropped unless
``use_diff``) with a pkl cache, comp4 results files, and the per-class
``voc_eval`` AP table (the 11-point metric for years before 2010).

Image paths must exist; their pixels are read by the caller's reader.
"""

from __future__ import annotations

import os
import os.path as osp
import pickle
import uuid
import xml.etree.ElementTree as ET

import numpy as np

from frcnn_tpu_torch.data.imdb import imdb
from frcnn_tpu_torch.data.voc_eval import voc_eval

VOC_CLASSES = (
    "__background__",
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


def _require(path: str) -> str:
    if not osp.exists(path):
        raise FileNotFoundError(f"path does not exist: {path}")
    return path


class pascal_voc(imdb):
    def __init__(self, image_set: str, year: str, use_diff: bool = False,
                 devkit_path: str | None = None, data_dir: str | None = None):
        name = f"voc_{year}_{image_set}" + ("_diff" if use_diff else "")
        super().__init__(name, list(VOC_CLASSES))
        self._year = year
        self._image_set = image_set
        self._data_dir = data_dir
        self._devkit_path = _require(devkit_path or self._default_path())
        self._data_path = _require(osp.join(self._devkit_path, "VOC" + year))
        self._class_to_ind = dict(zip(self.classes, range(self.num_classes)))
        self._image_ext = ".jpg"
        self._image_index = self._load_image_set_index()
        self._roidb_handler = self.gt_roidb
        self._salt = str(uuid.uuid4())
        self._comp_id = "comp4"
        self.config = {"cleanup": True, "use_salt": True, "use_diff": use_diff}

    def _default_path(self):
        from frcnn_tpu_torch.config import cfg

        return osp.join(self._data_dir or cfg.DATA_DIR, "VOCdevkit" + self._year)

    def _load_image_set_index(self):
        image_set_file = _require(osp.join(self._data_path, "ImageSets", "Main",
                                           self._image_set + ".txt"))
        with open(image_set_file) as f:
            return [x.strip() for x in f.readlines() if x.strip()]

    def image_path_at(self, i: int) -> str:
        return self.image_path_from_index(self._image_index[i])

    def image_path_from_index(self, index: str) -> str:
        return _require(osp.join(self._data_path, "JPEGImages", index + self._image_ext))

    def gt_roidb(self):
        cache_file = osp.join(self.cache_path, self.name + "_gt_roidb.pkl")
        if osp.exists(cache_file):
            with open(cache_file, "rb") as f:
                roidb = pickle.load(f)
            print(f"{self.name} gt roidb loaded from {cache_file}")
            return roidb
        roidb = [self._load_pascal_annotation(index) for index in self.image_index]
        with open(cache_file, "wb") as f:
            pickle.dump(roidb, f)
        print(f"wrote gt roidb to {cache_file}")
        return roidb

    def _load_pascal_annotation(self, index: str):
        tree = ET.parse(osp.join(self._data_path, "Annotations", index + ".xml"))
        objs = tree.findall("object")
        if not self.config["use_diff"]:
            objs = [obj for obj in objs if int(obj.find("difficult").text) == 0]
        num_objs = len(objs)
        boxes = np.zeros((num_objs, 4), dtype=np.uint16)
        gt_classes = np.zeros(num_objs, dtype=np.int32)
        overlaps = np.zeros((num_objs, self.num_classes), dtype=np.float32)
        seg_areas = np.zeros(num_objs, dtype=np.float32)
        for ix, obj in enumerate(objs):
            bbox = obj.find("bndbox")
            # VOC pixels are 1-based
            x1, y1, x2, y2 = (float(bbox.find(t).text) - 1
                              for t in ("xmin", "ymin", "xmax", "ymax"))
            cls = self._class_to_ind[obj.find("name").text.lower().strip()]
            boxes[ix, :] = [x1, y1, x2, y2]
            gt_classes[ix] = cls
            overlaps[ix, cls] = 1.0
            seg_areas[ix] = (x2 - x1 + 1) * (y2 - y1 + 1)
        return {"boxes": boxes, "gt_classes": gt_classes, "gt_overlaps": overlaps,
                "flipped": False, "seg_areas": seg_areas}

    def _get_comp_id(self):
        return f"{self._comp_id}_{self._salt}" if self.config["use_salt"] else self._comp_id

    def _get_voc_results_file_template(self):
        # VOCdevkit/results/VOC2007/Main/<comp_id>_det_test_aeroplane.txt
        filename = self._get_comp_id() + f"_det_{self._image_set}_%s.txt"
        filedir = osp.join(self._devkit_path, "results", "VOC" + self._year, "Main")
        os.makedirs(filedir, exist_ok=True)
        return osp.join(filedir, filename)

    def _write_voc_results_file(self, all_boxes):
        for cls_ind, cls in enumerate(self.classes):
            if cls == "__background__":
                continue
            with open(self._get_voc_results_file_template() % cls, "wt") as f:
                for im_ind, index in enumerate(self.image_index):
                    dets = all_boxes[cls_ind][im_ind]
                    for k in range(len(dets)):
                        # back to 1-based VOC pixels
                        f.write(f"{index} {dets[k, -1]:.3f} {dets[k, 0] + 1:.1f} "
                                f"{dets[k, 1] + 1:.1f} {dets[k, 2] + 1:.1f} {dets[k, 3] + 1:.1f}\n")

    def _do_python_eval(self, output_dir: str = "output"):
        annopath = osp.join(self._data_path, "Annotations", "%s.xml")
        imagesetfile = osp.join(self._data_path, "ImageSets", "Main", self._image_set + ".txt")
        cachedir = osp.join(self.cache_path, "annotations_cache", self.name)
        use_07_metric = int(self._year) < 2010
        print(f"VOC07 metric? {'Yes' if use_07_metric else 'No'}")
        os.makedirs(output_dir, exist_ok=True)
        aps, results = [], {}
        for cls in self.classes:
            if cls == "__background__":
                continue
            rec, prec, ap = voc_eval(self._get_voc_results_file_template(), annopath,
                                     imagesetfile, cls, cachedir, ovthresh=0.5,
                                     use_07_metric=use_07_metric,
                                     use_diff=self.config["use_diff"])
            aps.append(ap)
            results[cls] = ap
            print(f"AP for {cls} = {ap:.4f}")
            with open(osp.join(output_dir, cls + "_pr.pkl"), "wb") as f:
                pickle.dump({"rec": rec, "prec": prec, "ap": ap}, f)
        print(f"Mean AP = {np.mean(aps):.4f}")
        results["mAP"] = float(np.mean(aps))
        return results

    def evaluate_detections(self, all_boxes, output_dir=None):
        self._write_voc_results_file(all_boxes)
        results = self._do_python_eval(output_dir or "output")
        if self.config["cleanup"]:
            for cls in self.classes[1:]:
                filename = self._get_voc_results_file_template() % cls
                if osp.exists(filename):
                    os.remove(filename)
        return results

    def competition_mode(self, on: bool):
        self.config["use_salt"] = not on
        self.config["cleanup"] = not on
