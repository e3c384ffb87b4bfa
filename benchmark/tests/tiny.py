"""Tiny cells for the CPU tests: the real cells' configurations and traffic
with the sizes cut so that a run takes seconds on a CPU (ResNet-50, buckets
of 128 x 192, a few hundred anchors kept, short windows)."""

from __future__ import annotations

import copy
import json
import os

from benchmark.harness.main import Cell, load_cell

# the benchmark's cell, and the cells whose traffic files are kept without
# an entry in BENCHMARK.json
CELLS = ("res101_c4_coco.serve_blobs", "res101_c4_coco.train_cached",
         "res50_fpn_voc.serve_raw", "res50_fpn_voc.train_uncached")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# limits for the training cells' checks at these tiny sizes: a cell added to
# BENCHMARK.json brings limits of its own, set on the card from the program's
# and the control's readings at the configuration's sizes
KEPT_LIMITS = {
    "res101_c4_coco.train_cached": {"rpn_grad_diff": 0.04, "grad_gap": 0.15, "update_gap": 0.12},
    "res50_fpn_voc.train_uncached": {"rpn_grad_diff": 0.04, "loss_gap": 0.05,
                                     "update_gap_median": 0.05},
}
# the kept cells' metrics and units, each per-layer one with a reader file
# under benchmark/metrics/
TRAIN_METRICS = {"train_images_per_s": "images/s", "train.device_idle_share": "%",
                 "train.mfu": "%", "train.data_ms_per_batch": "ms", "k3_roofline.train": "%"}
RAW_METRICS = {"raw_images_per_s": "images/s", "raw.device_idle_share": "%", "raw.mfu": "%",
               "raw.prep_ms_per_image": "ms", "k3_roofline.raw": "%"}

TINY = {
    "DEVICE.BUCKETS": [[128, 192], [192, 128]],
    "TRAIN.SCALES": [128], "TRAIN.MAX_SIZE": 192, "TEST.SCALES": [128], "TEST.MAX_SIZE": 192,
    "TEST.RPN_PRE_NMS_TOP_N": 256, "TEST.RPN_POST_NMS_TOP_N": 32, "TEST.MAX_PER_IMAGE": 20,
    "TRAIN.RPN_PRE_NMS_TOP_N": 512, "TRAIN.RPN_POST_NMS_TOP_N": 64, "TRAIN.BATCH_SIZE": 16,
    "TRAIN.RPN_BATCHSIZE": 32, "DEVICE.MAX_GT": 8,
    "FPN.PRE_NMS_PER_LEVEL_TRAIN": 128, "FPN.PRE_NMS_PER_LEVEL_TEST": 64,
}
TINY_TRAFFIC = {"count": 12, "requests": 4, "sample_requests": 2, "request_images": 8,
                "trace_count": 2, "warm_steps": 1}


def _cell(name: str) -> Cell:
    """The cell ``name`` of BENCHMARK.json, or, for a cell whose files are
    kept without an entry, the same built from its configuration, traffic
    and limits files (``<config>.<traffic>``, ``KEPT_LIMITS``)."""
    try:
        return load_cell(ROOT, name)
    except KeyError:
        config, traffic = name.split(".")

        def read(*parts):
            with open(os.path.join(ROOT, "benchmark", *parts)) as f:
                return json.load(f)

        metrics = RAW_METRICS if "serve" in traffic else TRAIN_METRICS
        rate = next(iter(metrics))
        return Cell(name=name, chips=1, config=read("configs", config + ".json"),
                    traffic=read("traffic", traffic + ".json"), limits=limits(name),
                    end_to_end=[rate, "setup_s"], per_layer=list(metrics)[1:], root=ROOT,
                    units={"setup_s": "s", **metrics})


def tiny_cell(name: str) -> Cell:
    """The cell ``name`` cut to CPU size."""
    cell = copy.deepcopy(_cell(name))
    conf = cell.config
    conf["net"] = "res50_fpn" if conf["net"].endswith("_fpn") else "res50"
    conf["num_classes"] = 5
    conf["cfg"].update(TINY)
    if not conf["net"].endswith("_fpn"):
        conf["cfg"]["ANCHOR_SCALES"] = [2.0, 4.0, 8.0]
        conf["weights"] = {"residual_gain": 0.5, "cls_score_std": 0.05}   # ResNet-50's depth
    t = cell.traffic
    t["images"].update(count=TINY_TRAFFIC["count"] if t["kind"] == "serve" else 16,
                       long_side=160)
    t["images"]["short_side"] = [100, 159]
    t["gts"] = [1, 4]
    t["gt_mean"] = 2
    for k in ("requests", "sample_requests", "request_images", "trace_count", "warm_steps"):
        if k in t:
            t[k] = TINY_TRAFFIC[k]
    t.setdefault("set", {})["TRAIN.IMS_PER_BATCH"] = 2
    return cell


def limits(name: str) -> dict:
    if name in KEPT_LIMITS:
        return dict(KEPT_LIMITS[name])
    with open(os.path.join(ROOT, "benchmark", "limits", name + ".json")) as f:
        return json.load(f)
