"""Evaluation (``frcnn_tpu/engine/test.py``): ``im_detect`` (one image →
per-class scores and decoded boxes in original coordinates), ``test_net``
(a dataset through the fixed-shape ``detect`` → detections.pkl →
``imdb.evaluate_detections``) and ``apply_nms`` (per-class NMS over saved
detections, on the host).

``test_net`` groups the images by bucket into batches of ``batch``; a last
partial batch is padded with zero images, whose detections are dropped.
A producer thread reads, prepares and stacks the images (``reader``,
default ``cv2.imread``; ``serve.iter_bucket_batches``) while the device
runs the previous batch.  The batches go through ``Detector.detect_blobs``.
Both entry points run the model on the card unless the caller passes
``device``.
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
from frcnn_tpu_torch.ops.nms import nms_fixed
from frcnn_tpu_torch.utils.timer import Timer


def im_detect(model, im, cfg=None, device=None):
    """One BGR image through ``predict`` and ``decode_detections`` →
    numpy (scores (N, C), boxes (N, 4C) in original image coordinates,
    valid (N,)).  The model is moved to ``device`` (outside inference
    mode, so it can still be trained): ``cuda:0`` by default, ``"cpu"`` on
    request."""
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


def test_net(model, imdb, cfg=None, output_dir: str = "output", max_per_image: int = 100,
             batch: int = 8, reader=None, device=None):
    """Detect every image of ``imdb``, write ``detections.pkl``
    (all_boxes[class][image] = (k, 5) [x1, y1, x2, y2, score]) to
    ``output_dir`` and return ``imdb.evaluate_detections`` (VOC: per-class
    AP and mAP; COCO: the 12 stats)."""
    cfg = cfg or model.config
    reader = reader or loader.read_image
    detector = Detector(model, cfg, max_per_image=max_per_image, device=device)
    num_images = imdb.num_images
    all_boxes = [[np.zeros((0, 5), np.float32) for _ in range(num_images)]
                 for _ in range(imdb.num_classes)]
    timers = {"im_detect": Timer(), "misc": Timer()}
    done = 0

    def produce():
        """Read, prepare, stack and pad the batches (zero images with
        im_info [1, 1, 1] fill a part-filled batch)."""
        try:
            images = (reader(imdb.image_path_at(i)) for i in range(num_images))
            for indices, data, im_info in iter_bucket_batches(images, cfg, batch):
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
    (k, 5)) with the port's NMS on CPU tensors; kept rows in score order."""
    nms_boxes = [[np.zeros((0, 5), np.float32) for _ in per_class] for per_class in all_boxes]
    for cls_ind, per_class in enumerate(all_boxes):
        for im_ind, dets in enumerate(per_class):
            if len(dets) == 0:
                continue
            t = torch.from_numpy(np.asarray(dets, np.float32))
            idx, keep = nms_fixed(t[:, :4], t[:, 4], thresh, len(dets), use_kernels=False)
            nms_boxes[cls_ind][im_ind] = np.asarray(dets)[idx[keep].numpy()]
    return nms_boxes
