#!/usr/bin/env python
"""Re-evaluate saved detections without running the network, with the
flags of ``tools/reval.py`` (the reference's ``tools/reval.py``):

    python frcnn_tpu_torch/tools/reval.py output/default/voc_2007_test/default \\
        --imdb voc_2007_test [--nms] [--nms-thresh 0.3] [--data-dir DIR]

It reads ``detections.pkl`` from the directory, optionally applies the
per-class NMS again (``engine.test.apply_nms``, the C++ host op), and calls
``imdb.evaluate_detections`` (the AP files go to the same directory).  No
device is used.
"""

from __future__ import annotations

import argparse
import os.path as osp
import pickle
import sys


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Re-evaluate results")
    parser.add_argument("output_dir", help="directory containing detections.pkl")
    parser.add_argument("--imdb", dest="imdb_name", default="voc_2007_test")
    parser.add_argument("--comp", dest="comp_mode", action="store_true")
    parser.add_argument("--nms", dest="apply_nms", action="store_true",
                        help="re-apply per-class NMS before evaluating")
    parser.add_argument("--nms-thresh", type=float, default=0.3)
    parser.add_argument("--data-dir", default=None,
                        help="dataset root (defaults to the config's DATA_DIR)")
    return parser.parse_args(argv)


def from_dets(imdb_name, output_dir, args):
    """Evaluate ``output_dir``/detections.pkl on ``imdb_name``; returns
    ``imdb.evaluate_detections``' results (VOC: per-class AP and mAP)."""
    from frcnn_tpu_torch.data.factory import get_imdb
    from frcnn_tpu_torch.engine.test import apply_nms

    imdb = get_imdb(imdb_name, data_dir=args.data_dir)
    imdb.competition_mode(args.comp_mode)
    with open(osp.join(output_dir, "detections.pkl"), "rb") as f:
        dets = pickle.load(f)
    if args.apply_nms:
        print(f"Applying NMS to all detections (thresh {args.nms_thresh})")
        dets = apply_nms(dets, args.nms_thresh)
    print("Evaluating detections")
    return imdb.evaluate_detections(dets, output_dir)


def main(argv=None):
    args = parse_args(argv)
    return from_dets(args.imdb_name, osp.abspath(args.output_dir), args)


if __name__ == "__main__":
    sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), "..", ".."))
    main()
