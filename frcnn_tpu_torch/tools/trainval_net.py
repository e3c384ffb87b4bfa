#!/usr/bin/env python
"""Train a Faster R-CNN network with the PyTorch port, with the flags of
``tools/trainval_net.py``:

    python frcnn_tpu_torch/tools/trainval_net.py --net res50 \\
        --imdb voc_2007_trainval --imdbval voc_2007_test --iters 70000 \\
        --weight resnet50.pth --set TRAIN.IMS_PER_BATCH 2

It runs on the card (cuda:0, bf16 trunk under DEVICE.DTYPE bfloat16);
``--cpu`` asks for the CPU (f32).  ``--weight`` takes a ``.pth`` state_dict
with torchvision names (an ImageNet ResNet or VGG-16: the tensors whose
name and shape match are loaded); ``--net`` takes vgg16, res{50,101,152},
mobile, res{50,101,152}_fpn and res{50,101,152}_fpn_gn.  Without ``--weight``
a GroupNorm net (``--net res50_fpn_gn``, with ``--set RESNET.FIXED_BLOCKS
0``) starts from the JAX package's from-scratch initialisation.  Datasets live under DATA_DIR; their images are
read with cv2.  Snapshots and ``train_log.jsonl`` go to
ROOT_DIR/output/EXP_DIR/<imdb>/<tag>, and a run there resumes from its
latest snapshot.
"""

from __future__ import annotations

import argparse
import os.path as osp
import sys

NETS = ("vgg16", "res50", "res101", "res152", "mobile", "res50_fpn", "res101_fpn",
        "res152_fpn", "res50_fpn_gn", "res101_fpn_gn", "res152_fpn_gn")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train a Faster R-CNN network")
    parser.add_argument("--cfg", dest="cfg_file", default=None, help="optional config yaml")
    parser.add_argument("--weight", dest="weight", default=None,
                        help="pretrained weights: a .pth state_dict with torchvision names")
    parser.add_argument("--imdb", dest="imdb_name", default="voc_2007_trainval",
                        help="dataset to train on")
    parser.add_argument("--imdbval", dest="imdbval_name", default="voc_2007_test",
                        help="dataset to validate on ('' for none)")
    parser.add_argument("--iters", dest="max_iters", type=int, default=70000)
    parser.add_argument("--tag", dest="tag", default=None)
    parser.add_argument("--net", dest="net", default="res50", choices=NETS)
    parser.add_argument("--data-parallel", dest="data_parallel", type=int, default=0,
                        help="shard batches over N devices (not ported: must be 0)")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    parser.add_argument("--set", dest="set_cfgs", nargs=argparse.REMAINDER, default=None,
                        help="config overrides: K V pairs")
    args = parser.parse_args(argv)
    if args.data_parallel:
        parser.error("--data-parallel is not ported: the PyTorch port trains on one device "
                     "(multi-GPU data parallel is not written yet)")
    return args


def main(argv=None):
    args = parse_args(argv)
    import numpy as np
    import torch

    from frcnn_tpu_torch.config import (cfg_from_file, cfg_from_list, default_config,
                                        get_output_dir, get_output_tb_dir)
    from frcnn_tpu_torch.engine.checkpoint import load_params
    from frcnn_tpu_torch.engine.train import combined_roidb, train_net
    from frcnn_tpu_torch.models.network import build_model

    cfg = default_config()
    if args.cfg_file:
        cfg = cfg_from_file(cfg, args.cfg_file)
    if args.set_cfgs:
        cfg = cfg_from_list(cfg, args.set_cfgs)
    print("Using config:")
    print(cfg)
    np.random.seed(cfg.RNG_SEED)
    torch.manual_seed(cfg.RNG_SEED)  # the model's initial weights

    imdb, roidb = combined_roidb(args.imdb_name, cfg)
    print(f"{len(roidb)} roidb entries")
    output_dir = get_output_dir(cfg, args.imdb_name, args.tag)
    tb_dir = get_output_tb_dir(cfg, args.imdb_name, args.tag)
    print(f"Output will be saved to `{output_dir}`")
    valroidb = None
    if args.imdbval_name:
        _, valroidb = combined_roidb(args.imdbval_name, cfg)
        print(f"{len(valroidb)} validation roidb entries")

    bf16 = cfg.DEVICE.DTYPE == "bfloat16" and not args.cpu
    model = build_model(args.net, imdb.num_classes, cfg,
                        dtype=torch.bfloat16 if bf16 else torch.float32)
    pretrained = load_params(args.weight) if args.weight else None
    return train_net(model, imdb, roidb, valroidb, output_dir, tb_dir, cfg=cfg,
                     pretrained=pretrained, max_iters=args.max_iters,
                     device="cpu" if args.cpu else None)


if __name__ == "__main__":
    sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), "..", ".."))
    main()
