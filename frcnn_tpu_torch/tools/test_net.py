#!/usr/bin/env python
"""Test a Faster R-CNN network on an image database with the PyTorch port,
with the flags of ``tools/test_net.py``:

    python frcnn_tpu_torch/tools/test_net.py --net res50 --imdb voc_2007_test \\
        --model output/default/voc_2007_trainval/default/default_iter_70000.pth

``--model`` takes a snapshot ``.pth`` of the port's trainer or a
params-only state_dict.  It runs on the card (cuda:0, bf16 trunk under
DEVICE.DTYPE bfloat16); ``--cpu`` asks for the CPU (f32).  Images are read
with cv2.  detections.pkl and the per-class AP files go to
ROOT_DIR/output/EXP_DIR/<imdb>/<tag>.
"""

from __future__ import annotations

import argparse
import os.path as osp
import sys

NETS = ("res50", "res101", "res152", "res50_fpn", "res101_fpn", "res152_fpn")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Test a Faster R-CNN network")
    parser.add_argument("--cfg", dest="cfg_file", default=None)
    parser.add_argument("--model", dest="model_ckpt", required=True,
                        help="snapshot .pth of the trainer, or a state_dict .pth")
    parser.add_argument("--imdb", dest="imdb_name", default="voc_2007_test")
    parser.add_argument("--comp", dest="comp_mode", action="store_true")
    parser.add_argument("--num_dets", dest="max_per_image", type=int, default=100)
    parser.add_argument("--tag", dest="tag", default="")
    parser.add_argument("--net", dest="net", default="res50", choices=NETS)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    parser.add_argument("--set", dest="set_cfgs", nargs=argparse.REMAINDER, default=None)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import numpy as np
    import torch

    from frcnn_tpu_torch.config import (cfg_from_file, cfg_from_list, default_config,
                                        get_output_dir)
    from frcnn_tpu_torch.data.factory import get_imdb
    from frcnn_tpu_torch.engine.checkpoint import load_params
    from frcnn_tpu_torch.engine.test import test_net
    from frcnn_tpu_torch.models.network import build_model

    cfg = default_config()
    if args.cfg_file:
        cfg = cfg_from_file(cfg, args.cfg_file)
    if args.set_cfgs:
        cfg = cfg_from_list(cfg, args.set_cfgs)
    print("Using config:")
    print(cfg)
    np.random.seed(cfg.RNG_SEED)

    imdb = get_imdb(args.imdb_name, data_dir=cfg.DATA_DIR)
    imdb.competition_mode(args.comp_mode)
    bf16 = cfg.DEVICE.DTYPE == "bfloat16" and not args.cpu
    model = build_model(args.net, imdb.num_classes, cfg,
                        dtype=torch.bfloat16 if bf16 else torch.float32)
    model.load_state_dict(load_params(args.model_ckpt))
    output_dir = get_output_dir(cfg, args.imdb_name, args.tag or "default")
    return test_net(model.eval(), imdb, cfg, output_dir, max_per_image=args.max_per_image,
                    batch=args.batch, device="cpu" if args.cpu else None)


if __name__ == "__main__":
    sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), "..", ".."))
    main()
