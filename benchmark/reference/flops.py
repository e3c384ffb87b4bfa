"""Dense floating-point operations of one image through the reference
detector, counted by ``torch.utils.flop_counter.FlopCounterMode`` on the
meta device (shapes only, nothing computed): convolutions and matrix
products, 2 per multiply-add.  The roi counts are the configuration's
(TEST.RPN_POST_NMS_TOP_N rois an image served, TRAIN.BATCH_SIZE trained),
so the count is the same whatever implements the step."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference.detector import Net, param_specs, trainable


def _meta_net(net, num_classes, c, grads=False):
    W = {}
    for name, shape, _ in param_specs(net, num_classes, c):
        W[name] = torch.empty(shape, device="meta",
                              requires_grad=grads and trainable(name, c))
    return Net(W, c, net, num_classes)


def detect_flops(net: str, num_classes: int, c: dict, bucket) -> float:
    """FLOPs of ``detect`` for one image padded to ``bucket`` (h, w)."""
    ref = _meta_net(net, num_classes, c)
    images = torch.empty((1, *bucket, 3), device="meta")
    im_info = torch.empty((1, 3), device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        ref.detect(images, im_info)
    return float(counter.get_total_flops())


def train_flops(net: str, num_classes: int, c: dict, bucket) -> float:
    """FLOPs of one training step's forward and backward for one image
    padded to ``bucket``, the gradients of the trained weights only."""
    ref = _meta_net(net, num_classes, c, grads=True)
    g = c["DEVICE.MAX_GT"]
    images = torch.empty((1, *bucket, 3), device="meta")
    args = (torch.empty((1, 3), device="meta"), torch.empty((1, g, 4), device="meta"),
            torch.zeros((1, g), dtype=torch.int32, device="meta"),
            torch.zeros((1, g), dtype=torch.bool, device="meta"))
    with FlopCounterMode(display=False) as counter:
        losses = ref.train_losses(images, *args, lambda *size: torch.empty(size, device="meta"))
        losses["total_loss"].backward()
    return float(counter.get_total_flops())

