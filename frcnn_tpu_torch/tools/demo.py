#!/usr/bin/env python
"""Detection demo on image files, with the flags of ``tools/demo.py`` (the
reference's ``tools/demo.py``):

    python frcnn_tpu_torch/tools/demo.py --net res50 --model <snapshot>.pth \\
        --images a.jpg b.jpg [--out-dir output/demo] [--conf 0.8] [--cpu]

Each image is read with ``data.loader.read_image`` (cv2) and goes through
``engine.test.im_detect``; per class, the rows above ``--conf`` go through
greedy NMS at 0.3 (``native.host_ops.nms_cpu``), as the reference's demo.
The kept boxes are printed and drawn (``utils.visualization``, PIL) into
``<out-dir>/<image name>.png``.  ``--model`` takes a snapshot ``.pth`` of
the port's trainer or a params-only state_dict of a 21-class VOC model.
It runs on the card (bf16 trunk under DEVICE.DTYPE bfloat16); ``--cpu``
asks for the CPU (f32).
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import sys

CONF_THRESH = 0.8
NMS_THRESH = 0.3
NETS = ("vgg16", "res50", "res101", "res152", "mobile", "res50_fpn", "res101_fpn",
        "res152_fpn", "res50_fpn_gn", "res101_fpn_gn", "res152_fpn_gn")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Faster R-CNN demo")
    parser.add_argument("--net", dest="net", default="res50", choices=NETS)
    parser.add_argument("--model", dest="model_ckpt", required=True,
                        help="snapshot .pth of the trainer, or a state_dict .pth")
    parser.add_argument("--cfg", dest="cfg_file", default=None)
    parser.add_argument("--images", nargs="+", required=True)
    parser.add_argument("--out-dir", default="output/demo")
    parser.add_argument("--conf", type=float, default=CONF_THRESH)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    parser.add_argument("--set", dest="set_cfgs", nargs=argparse.REMAINDER, default=None)
    return parser.parse_args(argv)


def class_detections(scores, boxes, valid, conf, nms_thresh=NMS_THRESH):
    """``im_detect``'s per-class scores (N, C) and boxes (N, 4C) → (k, 6)
    [x1, y1, x2, y2, score, class]: per class, the valid rows scoring at
    least ``conf``, after greedy NMS at ``nms_thresh``."""
    import numpy as np

    from frcnn_tpu_torch.native.host_ops import nms_cpu

    rows = []
    for cls in range(1, scores.shape[1]):
        dets = np.concatenate([boxes[valid, 4 * cls:4 * cls + 4], scores[valid, cls:cls + 1]], 1)
        dets = dets[dets[:, 4] >= conf]
        dets = dets[nms_cpu(dets, nms_thresh)]
        rows.append(np.concatenate([dets, np.full((len(dets), 1), float(cls))], 1))
    return np.concatenate(rows).astype(np.float32) if rows else np.zeros((0, 6), np.float32)


def main(argv=None):
    args = parse_args(argv)
    import numpy as np
    import torch
    from PIL import Image

    from frcnn_tpu_torch.config import cfg_from_file, cfg_from_list, default_config
    from frcnn_tpu_torch.data import loader
    from frcnn_tpu_torch.data.pascal_voc import VOC_CLASSES
    from frcnn_tpu_torch.engine.checkpoint import load_params
    from frcnn_tpu_torch.engine.test import im_detect
    from frcnn_tpu_torch.models.network import build_model
    from frcnn_tpu_torch.utils.visualization import draw_bounding_boxes

    cfg = default_config()
    if args.cfg_file:
        cfg = cfg_from_file(cfg, args.cfg_file)
    if args.set_cfgs:
        cfg = cfg_from_list(cfg, args.set_cfgs)
    bf16 = cfg.DEVICE.DTYPE == "bfloat16" and not args.cpu
    model = build_model(args.net, len(VOC_CLASSES), cfg,
                        dtype=torch.bfloat16 if bf16 else torch.float32)
    model.load_state_dict(load_params(args.model_ckpt))
    model.eval()
    os.makedirs(args.out_dir, exist_ok=True)
    written = []
    for path in args.images:
        im = loader.read_image(path)
        scores, boxes, valid = im_detect(model, im, cfg, device="cpu" if args.cpu else None)
        dets = class_detections(scores, boxes, valid, args.conf)
        print(f"{path}: {len(dets)} detections >= {args.conf}")
        for d in dets:
            print(f"  {VOC_CLASSES[int(d[5])]:>12s} {d[4]:.3f} "
                  f"[{d[0]:.0f}, {d[1]:.0f}, {d[2]:.0f}, {d[3]:.0f}]")
        vis = draw_bounding_boxes(np.ascontiguousarray(im[:, :, ::-1]), dets[:, :4],
                                  dets[:, 5].astype(int), VOC_CLASSES)
        out = osp.join(args.out_dir, osp.splitext(osp.basename(path))[0] + ".png")
        Image.fromarray(vis).save(out)
        print(f"  wrote {out}")
        written.append((out, dets))
    return written


if __name__ == "__main__":
    sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), "..", ".."))
    main()
