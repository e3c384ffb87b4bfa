#!/usr/bin/env python
"""Trained-AP regression of the PyTorch port (``frcnn_tpu_torch``) on one
CUDA card: the recipe of ``scripts/ap_regression.py`` through the port's
drivers, as one seed-pinned command with an asserted floor.

  * the 120-image synthetic VOC of ``tools/make_synthetic_voc.py`` (seed 0,
    classes dog/cat/car/person with a fixed colour each; trainval 90, test
    30), drawn here with numpy in the tool's order.  The annotations and
    ImageSets are written with the standard library and the pixels are
    served by a reader, so no image codec is needed: the images are the
    tool's pixels before its JPEG encoding;
  * ``res50_fpn_gn`` (ResNet-50 + FPN, GroupNorm) from scratch
    (``init_reference_``) for ``--iters`` steps through ``train_net``, bf16
    trunk on the card;
  * ``test_net`` over the test split in competition mode → VOC APs;
  * exit 1 when the mean AP over the classes present in the test split is
    below ``--floor`` (default 0.75).

The recipe (``RECIPE``) is ``ap_regression.py``'s, TRAIN.IMAGE_CACHE
included: the images are read through the reader once, into the
resized-image cache under ``<root>/cache``, and the batches go to the card
as uint8.

With ``--json-out PATH`` the result is written with the keys of
``AP_r05.json`` (``mean_ap``, ``per_class``, ``iters``, ``floor``, ``pass``,
``net``, ``seconds``, ``s_per_iter_incl_compile``, ``s_per_iter_steady``,
``backend``) and the card's name and power limit, on failure too.

Usage: python scripts/ap_regression_torch.py [--iters 1500] [--floor 0.75]
       [--root DIR] [--json-out PATH] [--cpu]
(``--cpu``: a rehearsal on the CPU in f32; the card otherwise, and no card
is an error.)
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import subprocess
import sys
import tempfile
import time
import xml.etree.ElementTree as ET

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), ".."))

import numpy as np  # noqa: E402

CLASSES = ("dog", "cat", "car", "person")

# ap_regression.py's overrides, as --set pairs of the port's config
RECIPE = [
    "RESNET.FIXED_BLOCKS", "0",
    "TRAIN.IMS_PER_BATCH", "2", "TRAIN.SCALES", "(600,)", "TRAIN.MAX_SIZE", "1024",
    "TRAIN.GRAD_CLIP", "10.0", "TRAIN.WARMUP_ITERS", "500", "TRAIN.WARMUP_FACTOR", "0.1",
    "TRAIN.STEPSIZE", "(1200,)", "TRAIN.SNAPSHOT_ITERS", "10000", "TRAIN.DISPLAY", "100",
    "TRAIN.USE_FLIPPED", "True", "TRAIN.SUMMARY_INTERVAL", "0", "TRAIN.IMAGE_CACHE", "True",
    "TEST.SCALES", "(600,)", "TEST.MAX_SIZE", "1024",
    "DEVICE.BUCKETS", "((608, 1024),)", "DEVICE.MAX_GT", "8",
]


def synthetic_voc(root: str, images: int = 120, seed: int = 0, classes=CLASSES):
    """``tools/make_synthetic_voc.py``'s dataset under ``root`` (the same
    draws, names and splits): VOCdevkit2007/VOC2007 with Annotations XML,
    ImageSets/Main/{trainval,test}.txt and an empty placeholder for each
    JPEGImages path.  Returns the reader: image path → BGR uint8 pixels."""
    d = osp.join(root, "VOCdevkit2007", "VOC2007")
    for sub in ("Annotations", osp.join("ImageSets", "Main"), "JPEGImages"):
        os.makedirs(osp.join(d, sub), exist_ok=True)
    rng = np.random.RandomState(seed)
    colors = {c: rng.randint(40, 255, 3) for c in classes}
    index, pixels = [], {}
    for i in range(images):
        name = f"{i:06d}"
        index.append(name)
        h = int(rng.choice([240, 320, 360]))
        w = int(rng.choice([320, 400, 480]))
        im = rng.randint(0, 80, (h, w, 3)).astype(np.uint8)
        ann = ET.Element("annotation")
        ET.SubElement(ann, "folder").text = "VOC2007"
        ET.SubElement(ann, "filename").text = name + ".jpg"
        size = ET.SubElement(ann, "size")
        for tag, v in (("width", w), ("height", h), ("depth", 3)):
            ET.SubElement(size, tag).text = str(v)
        for _ in range(rng.randint(1, 4)):
            bw, bh = rng.randint(40, 100, 2)
            x1 = rng.randint(0, w - bw - 1)
            y1 = rng.randint(0, h - bh - 1)
            cls = classes[rng.randint(len(classes))]
            im[y1:y1 + bh, x1:x1 + bw] = colors[cls]
            obj = ET.SubElement(ann, "object")
            for tag, v in (("name", cls), ("pose", "Left"), ("truncated", "0"),
                           ("difficult", "0")):
                ET.SubElement(obj, tag).text = v
            box = ET.SubElement(obj, "bndbox")
            for tag, v in (("xmin", x1), ("ymin", y1), ("xmax", x1 + bw), ("ymax", y1 + bh)):
                ET.SubElement(box, tag).text = str(v + 1)
        ET.ElementTree(ann).write(osp.join(d, "Annotations", name + ".xml"))
        path = osp.join(d, "JPEGImages", name + ".jpg")
        open(path, "wb").close()
        pixels[path] = im
    split = max(2, images * 3 // 4)
    for image_set, names in (("trainval", index[:split]), ("test", index[split:])):
        with open(osp.join(d, "ImageSets", "Main", image_set + ".txt"), "w") as f:
            f.write("\n".join(names) + "\n")
    return pixels.__getitem__


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def steady_s_per_iter(out_dir: str, iters: int):
    """The slope of train_log.jsonl's timestamps from its second logged
    point on (the first window holds the kernels' build and warm-up)."""
    with open(osp.join(out_dir, "train_log.jsonl")) as f:
        pts = sorted((p["iter"], p["ts"]) for p in map(json.loads, f)
                     if "ts" in p and p["iter"] <= iters)
    pts = pts[1:]
    if len(pts) < 2:
        return None
    return (pts[-1][1] - pts[0][1]) / (pts[-1][0] - pts[0][0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=1500)
    ap.add_argument("--floor", type=float, default=0.75)
    ap.add_argument("--root", default=None, help="data and output directory (default: a "
                                                 "temporary one, removed at the end)")
    ap.add_argument("--net", default="res50_fpn_gn")
    ap.add_argument("--json-out", default=None, help="also write the result as JSON")
    ap.add_argument("--cpu", action="store_true", help="a rehearsal on the CPU (f32)")
    args = ap.parse_args(argv)

    import torch

    if not args.cpu and not torch.cuda.is_available():
        print("ap_regression_torch: no CUDA device (pass --cpu for a CPU rehearsal)",
              file=sys.stderr)
        return 2
    from frcnn_tpu_torch import cfg_from_list, default_config
    from frcnn_tpu_torch.data.pascal_voc import pascal_voc
    from frcnn_tpu_torch.engine.test import test_net
    from frcnn_tpu_torch.engine.train import combined_roidb, train_net
    from frcnn_tpu_torch.models.network import build_model

    with tempfile.TemporaryDirectory(prefix="ap_regression_torch_") as tmp:
        root = args.root or tmp
        reader = synthetic_voc(root)
        cfg = cfg_from_list(default_config(), RECIPE + ["DATA_DIR", root])
        device = "cpu" if args.cpu else None
        card = None if args.cpu else card_line()
        np.random.seed(cfg.RNG_SEED)
        imdb, roidb = combined_roidb("voc_2007_trainval", cfg, reader=reader)
        dtype = torch.float32 if args.cpu else torch.bfloat16
        model = build_model(args.net, imdb.num_classes, cfg, dtype=dtype)
        out_dir = osp.join(root, "out")
        t0 = time.time()
        train_net(model, imdb, roidb, None, out_dir, cfg=cfg, max_iters=args.iters,
                  reader=reader, device=device)
        t_train = time.time() - t0
        s_steady = steady_s_per_iter(out_dir, args.iters)
        print(f"trained {args.iters} iters in {t_train:.1f}s ({t_train / args.iters:.4f} s/iter "
              "incl. the kernels' build" + (f"; steady-state {s_steady:.4f} s/iter" if s_steady
                                            else "") + ")")

        dst = pascal_voc("test", "2007", devkit_path=osp.join(root, "VOCdevkit2007"),
                         data_dir=root)
        dst.competition_mode(True)
        res = test_net(model.eval(), dst, cfg, osp.join(root, "eval"), max_per_image=100,
                       batch=2, reader=reader, device=device)
        present = {dst.classes[c] for r in dst.gt_roidb() for c in r["gt_classes"]}
        aps = {k: float(v) for k, v in res.items()
               if k in present and np.isfinite(v)}
        mean_ap = float(np.mean(list(aps.values()))) if aps else 0.0
        print(f"AP by class: { {k: round(v, 4) for k, v in aps.items()} }")
        print(f"mean AP over {len(aps)} present classes: {mean_ap:.4f} (floor {args.floor})")
        if card:
            print(card)
        ok = mean_ap >= args.floor
        if args.json_out:
            name, _, limit = (card or "cpu, not measured").partition(", ")
            with open(args.json_out, "w") as f:
                json.dump({"mean_ap": round(mean_ap, 4),
                           "per_class": {k: round(v, 4) for k, v in aps.items()},
                           "iters": args.iters, "floor": args.floor, "pass": ok,
                           "net": args.net, "seconds": round(t_train, 1),
                           "s_per_iter_incl_compile": round(t_train / args.iters, 4),
                           "s_per_iter_steady": round(s_steady, 4) if s_steady else None,
                           "backend": "cpu" if args.cpu else "cuda",
                           "device": name, "power_limit": limit}, f, indent=1)
                f.write("\n")
            print(f"wrote {args.json_out}")
    if not ok:
        print("AP REGRESSION: below floor", file=sys.stderr)
        return 1
    print("AP regression check PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
