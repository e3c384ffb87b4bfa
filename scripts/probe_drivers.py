#!/usr/bin/env python3
"""Where the time of the two drivers goes on one card: a ``train_net``
iteration against the bare ``SolverWrapper.train_step`` of ``chip_smoke.py``
phase 16, and a ``test_net`` batch against the bare
``Detector.detect_blobs`` of phase 12:

    python3 scripts/probe_drivers.py

res50 C4, bf16 trunk, seeded weights, over the synthetic VOC devkit of
``chip_smoke.py`` with a larger test split (pixels from a seeded reader).
Each row is the median of 8 after 2 warm-up repeats, in ms.

The train rows (batch 8, 608x1024; trainval: 16 images 600 pixels high and
their flips):

  * ``prep``: ``RoIDataLayer.forward`` alone on the main thread (the numpy
    minibatch: 8 f32 images padded to 608x1024);
  * ``copy``: the minibatch to the card as ``train_step`` sends it
    (pageable host memory), synchronised; ``copy pinned``: the same from
    page-locked memory;
  * ``step queued``: ``train_step`` on a device-resident batch, synchronised
    once after the repeats (phase 16's figure);
  * ``step + readback``: the same, each step followed by the five
    ``float()`` loss readbacks that ``train_model`` makes;
  * ``serial iteration``: prep, copy, step and readback in turn on one
    thread;
  * ``train_model``: the driver's iteration (the prefetch thread on), from
    its ``train_log.jsonl`` timestamps.

The test rows (batch 8 at 800x1216; test: 48 images 800 pixels high, so
nothing is resized, six batches), each a batch of 8:

  * ``test prep``: read, prepare and stack 8 images
    (``serve.iter_bucket_batches``) on the main thread; ``test prep uint8``:
    the same kept uint8;
  * ``test copy``: the f32 batch (93 MB) to the card from pageable memory,
    synchronised; ``test copy pinned``, ``test copy uint8`` (23 MB);
  * ``test detect queued``: ``detect_blobs`` on a device-resident batch,
    synchronised once after the repeats (phase 12's figure);
  * ``test detect + readback``: ``detect_blobs`` from the host f32 batch and
    the readback of its detections, what ``test_net``'s timer spans;
    ``... uint8``: the same from the uint8 batch (``Detector(uint8_input=
    True)``); ``... prep thread busy``: the f32 form while a second thread
    prepares batches without pause, as ``test_net``'s producer does;
  * ``test_net timer``: the median batch of ``test_net``'s own timer (its
    printed time per image times 8), batches 2-6;
  * ``test_net total``: ``test_net`` over the 48 images, per batch;
    ``test evaluate``: ``imdb.evaluate_detections`` on its detections
    alone.
The card's name and power limit come first.
"""

import contextlib
import io
import os
import pickle
import re
import shutil
import threading
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def timed(fn, n=8, warmup=2, sync=True):
    """Median wall time of fn() in ms, each call synchronised when ``sync``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        if sync:
            torch.cuda.synchronize()
        times.append(1000.0 * (time.perf_counter() - t0))
    return statistics.median(times)


def main():
    if not torch.cuda.is_available():
        print("probe_drivers: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    workdir = tempfile.mkdtemp(prefix="probe_drivers_")
    try:
        shapes = chip_smoke.devkit_shapes(np.random.RandomState(6))
        shapes["test"] = [(800, int(w)) for w in np.random.RandomState(9).randint(1000, 1217, 48)]
        reader = chip_smoke.write_voc_devkit(workdir, shapes, np.random.RandomState(7))
        rows = measure(chip_smoke, workdir, reader)
        rows.update(measure_test(chip_smoke, workdir, reader))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for name, ms in rows.items():
        print(f"{name:>40}: {ms:9.3f} ms")
    return 0


def measure(chip_smoke, workdir, reader):
    from frcnn_tpu_torch.engine.train import SolverWrapper, _to_device, combined_roidb, train_net

    dev = torch.device("cuda", 0)
    cfg = chip_smoke.train_config(["DATA_DIR", workdir, "TRAIN.SNAPSHOT_ITERS", "1000"])
    _, roidb = combined_roidb("voc_2007_trainval", cfg, reader=reader)
    solver = SolverWrapper(chip_smoke.build_seeded(cfg, torch.bfloat16), roidb, cfg,
                           reader=reader)
    layer = solver.data_layer
    blobs = layer.forward()
    feed = _to_device(blobs, dev)
    pinned = {k: torch.as_tensor(v).pin_memory() for k, v in blobs.items()}
    rows = {
        "prep": timed(layer.forward, sync=False),
        "copy": timed(lambda: _to_device(blobs, dev)),
        "copy pinned": timed(lambda: {k: v.to(dev, non_blocking=True)
                                      for k, v in pinned.items()}),
    }
    # queued steps: one synchronisation after the repeats
    for _ in range(2):
        solver.train_step(feed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        solver.train_step(feed)
    torch.cuda.synchronize()
    rows["step queued"] = 1000.0 * (time.perf_counter() - t0) / 8
    rows["step + readback"] = timed(
        lambda: [float(v) for v in solver.train_step(feed).values()], sync=False)
    rows["serial iteration"] = timed(
        lambda: [float(v) for v in solver.train_step(layer.forward()).values()], sync=False)

    out = os.path.join(workdir, "run")
    train_net(chip_smoke.build_seeded(cfg, torch.bfloat16), None, roidb, None, out, cfg=cfg,
              max_iters=10, reader=reader)
    log = chip_smoke.read_train_log(out)
    rows["train_model"] = statistics.median(1000.0 * (log[k]["ts"] - log[k - 1]["ts"])
                                            for k in range(2, 10))
    return rows



def measure_test(chip_smoke, workdir, reader):
    from frcnn_tpu_torch.data.factory import get_imdb
    from frcnn_tpu_torch.engine.serve import Detector, iter_bucket_batches
    from frcnn_tpu_torch.engine.test import test_net

    dev = torch.device("cuda", 0)
    cfg = chip_smoke.smoke_config(["DATA_DIR", workdir])
    imdb = get_imdb("voc_2007_test", data_dir=workdir)
    model = chip_smoke.build_seeded(cfg, torch.bfloat16)
    images = [reader(imdb.image_path_at(i)) for i in range(8)]

    def prep(keep_uint8=False):
        return next(iter_bucket_batches((reader(imdb.image_path_at(i)) for i in range(8)), cfg,
                                        8, keep_uint8=keep_uint8))

    _, data, im_info = prep()
    _, data8, _ = prep(keep_uint8=True)
    det = Detector(model, cfg, max_per_image=100)
    det8 = Detector(model, cfg, max_per_image=100, uint8_input=True)
    pinned = torch.from_numpy(data).pin_memory()
    rows = {
        "test prep": timed(prep, sync=False),
        "test prep uint8": timed(lambda: prep(keep_uint8=True), sync=False),
        "test copy": timed(lambda: torch.from_numpy(data).to(dev)),
        "test copy pinned": timed(lambda: pinned.to(dev, non_blocking=True)),
        "test copy uint8": timed(lambda: torch.from_numpy(data8).to(dev)),
    }
    feed, info = torch.from_numpy(data).to(dev), torch.from_numpy(im_info).to(dev)
    for _ in range(2):
        det.detect_blobs(feed, info)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        det.detect_blobs(feed, info)
    torch.cuda.synchronize()
    rows["test detect queued"] = 1000.0 * (time.perf_counter() - t0) / 8

    def detect_readback(d, x):
        dets, valid = d.detect_blobs(x, im_info)
        return dets.cpu().numpy(), valid.cpu().numpy()

    rows["test detect + readback"] = timed(lambda: detect_readback(det, data), sync=False)
    rows["test detect + readback uint8"] = timed(lambda: detect_readback(det8, data8),
                                                 sync=False)
    stop = threading.Event()

    def busy():
        while not stop.is_set():
            list(iter_bucket_batches(images, cfg, 8))

    thread = threading.Thread(target=busy, daemon=True)
    thread.start()
    try:
        rows["test detect + readback, prep thread busy"] = timed(
            lambda: detect_readback(det, data), sync=False)
    finally:
        stop.set()
        thread.join()

    out = os.path.join(workdir, "test")
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        test_net(model, imdb, cfg, out, max_per_image=100, batch=8, reader=reader)
    rows["test_net total"] = 1000.0 * (time.perf_counter() - t0) / (imdb.num_images / 8)
    per_image = [float(t) for t in re.findall(r"^im_detect: \d+/\d+ ([\d.]+)s/image",
                                              printed.getvalue(), re.M)]
    rows["test_net timer"] = statistics.median(8000.0 * t for t in per_image[1:])
    with open(os.path.join(out, "detections.pkl"), "rb") as f:
        all_boxes = pickle.load(f)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        imdb.evaluate_detections(all_boxes, out)
    rows["test evaluate"] = 1000.0 * (time.perf_counter() - t0)
    return rows


if __name__ == "__main__":
    sys.exit(main())
