"""Evaluation (``frcnn_tpu/engine/test.py``): ``im_detect`` (one image →
per-class scores and decoded boxes in original coordinates), ``test_net``
(a dataset through the fixed-shape ``detect`` → detections.pkl →
``imdb.evaluate_detections``) and ``apply_nms`` (per-class NMS over saved
detections on the host, ``native.host_ops.nms_cpu``).

``test_net`` groups the images by bucket into batches of ``batch``; a last
partial batch is padded with zero images, whose detections are dropped.
A producer thread prepares and stacks the batches (``_prep_stream``) while
the device runs the previous one: with no ``reader``, a roidb that carries
the image sizes and the native prep built (``native/data_prep.py``), the
images are grouped by bucket up front and each batch is decoded and resized
in C++; else each image is read with ``reader`` (default ``cv2.imread``)
and batched by ``serve.iter_bucket_batches``.  The batches go through
``Detector.detect_blobs``.  Both entry points run the model on the card
unless the caller passes ``device``.
"""

from __future__ import annotations

import os
import os.path as osp
import pickle
import queue
import threading

import numpy as np
import torch

from frcnn_tpu_torch.data import loader
from frcnn_tpu_torch.engine import resolve_device
from frcnn_tpu_torch.engine.serve import Detector, iter_bucket_batches, prep_image
from frcnn_tpu_torch.native import data_prep
from frcnn_tpu_torch.native.host_ops import nms_cpu
from frcnn_tpu_torch.utils.timer import Timer


def im_detect(model, im, cfg=None, device=None):
    """One BGR image through ``predict`` and ``decode_detections`` →
    numpy (scores (N, C), boxes (N, 4C) in original image coordinates,
    valid (N,)).  The model is moved to ``device`` (outside inference
    mode, so it can still be trained): ``cuda:0`` by default, ``"cpu"`` on
    request.  It runs ``predict`` eagerly, also on the card: one image of a
    size of its own is no shape a captured graph would be replayed at
    (``Detector`` and ``test_net`` replay ``detect``'s graphs)."""
    cfg = cfg or model.config
    device = resolve_device(device)
    model = model.to(device)
    blob, info = prep_image(im, cfg)
    with torch.inference_mode():
        data = torch.from_numpy(blob[None]).to(device)
        im_info = torch.from_numpy(info[None]).to(device)
        out = model.predict(data, im_info)
        boxes = model.decode_detections(out, im_info)
    return (out["cls_prob"][0].cpu().numpy(), boxes[0].cpu().numpy(),
            out["roi_valid"][0].cpu().numpy())


def _sized_entries(imdb):
    """``imdb.roidb`` when it carries every image's size, else None."""
    try:
        entries = imdb.roidb
    except (NotImplementedError, OSError):      # no roidb (or no annotations): the reader route
        return None
    n = imdb.num_images
    if len(entries) < n or not all("width" in e and "height" in e for e in entries[:n]):
        return None
    return entries


def _prep_stream(imdb, cfg, batch: int, reader=None):
    """Yield (indices, data (b, bh, bw, 3), im_info (b, 3)), one bucket shape
    a batch.  With no ``reader``, stored sizes and the native prep, the
    scale and bucket need no pixels: the images are grouped by bucket up
    front and each batch is prepared by ``data_prep.prep_batch``; else each
    image is read with ``reader`` (default ``read_image``) and batched by
    ``iter_bucket_batches``."""
    t = cfg.TEST
    entries = _sized_entries(imdb) if reader is None else None
    if entries is not None and data_prep.have_native():
        groups: dict = {}
        for i in range(imdb.num_images):
            h, w = entries[i]["height"], entries[i]["width"]
            scale, bucket = loader.pick_scale_and_bucket(h, w, t.SCALES[0], t.MAX_SIZE,
                                                         cfg.DEVICE.BUCKETS)
            groups.setdefault(bucket, []).append((i, scale, h, w))
        for bucket, items in groups.items():
            for s in range(0, len(items), batch):
                part = items[s:s + batch]
                data, _ = data_prep.prep_batch([imdb.image_path_at(i) for i, _, _, _ in part],
                                               [0] * len(part), [sc for _, sc, _, _ in part],
                                               bucket)
                im_info = np.array([[np.round(h * sc), np.round(w * sc), sc]
                                    for _, sc, h, w in part], np.float32)
                yield [i for i, _, _, _ in part], data, im_info
        return
    reader = reader or loader.read_image
    images = (reader(imdb.image_path_at(i)) for i in range(imdb.num_images))
    yield from iter_bucket_batches(images, cfg, batch)


def test_net(model, imdb, cfg=None, output_dir: str = "output", max_per_image: int = 100,
             batch: int = 8, reader=None, device=None):
    """Detect every image of ``imdb``, write ``detections.pkl``
    (all_boxes[class][image] = (k, 5) [x1, y1, x2, y2, score]) to
    ``output_dir`` and return ``imdb.evaluate_detections`` (VOC: per-class
    AP and mAP; COCO: the 12 stats).  ``reader`` maps an image path to BGR
    uint8 pixels (default ``read_image``); with none, the stored-size route
    runs where the roidb and the native prep allow (``_prep_stream``)."""
    cfg = cfg or model.config
    detector = Detector(model, cfg, max_per_image=max_per_image, device=device)
    num_images = imdb.num_images
    all_boxes = [[np.zeros((0, 5), np.float32) for _ in range(num_images)]
                 for _ in range(imdb.num_classes)]
    timers = {"im_detect": Timer(), "misc": Timer()}
    done = 0

    def produce():
        """Prepare and pad the batches (zero images with im_info [1, 1, 1]
        fill a part-filled batch)."""
        try:
            for indices, data, im_info in _prep_stream(imdb, cfg, batch, reader):
                pad = batch - len(indices)
                if pad:
                    data = np.concatenate([data, np.zeros((pad, *data.shape[1:]), data.dtype)])
                    im_info = np.concatenate([im_info, np.ones((pad, 3), np.float32)])
                q.put((indices, data, im_info))
            q.put(None)
        except Exception as e:  # raised again in the consumer
            q.put(e)

    q: queue.Queue = queue.Queue(maxsize=2)
    producer = threading.Thread(target=produce, daemon=True)
    producer.start()
    while (item := q.get()) is not None:
        if isinstance(item, Exception):
            raise RuntimeError("image preparation thread failed") from item
        indices, data, im_info = item
        timers["im_detect"].tic()
        dets, valid = detector.detect_blobs(data, im_info)
        dets, valid = dets.cpu().numpy(), valid.cpu().numpy()
        detect_time = timers["im_detect"].toc(average=False)
        timers["misc"].tic()
        for bi, i in enumerate(indices):
            d = dets[bi][valid[bi]]
            for cls_ind in range(1, imdb.num_classes):
                rows = d[d[:, 5] == cls_ind]
                if len(rows):
                    all_boxes[cls_ind][i] = rows[:, :5].astype(np.float32)
        misc_time = timers["misc"].toc(average=False)
        done += len(indices)
        print(f"im_detect: {done}/{num_images} {detect_time / len(indices):.3f}s/image "
              f"{misc_time / len(indices):.3f}s/image")
    producer.join()

    os.makedirs(output_dir, exist_ok=True)
    with open(osp.join(output_dir, "detections.pkl"), "wb") as f:
        pickle.dump(all_boxes, f, pickle.HIGHEST_PROTOCOL)
    print("Evaluating detections")
    return imdb.evaluate_detections(all_boxes, output_dir)


def apply_nms(all_boxes, thresh: float):
    """Per-class greedy NMS over saved detections (all_boxes[class][image]
    (k, 5)) on the host with ``nms_cpu``; kept rows in score order."""
    nms_boxes = [[np.zeros((0, 5), np.float32) for _ in per_class] for per_class in all_boxes]
    for cls_ind, per_class in enumerate(all_boxes):
        for im_ind, dets in enumerate(per_class):
            if len(dets) == 0:
                continue
            nms_boxes[cls_ind][im_ind] = np.asarray(dets)[nms_cpu(dets, thresh)]
    return nms_boxes
