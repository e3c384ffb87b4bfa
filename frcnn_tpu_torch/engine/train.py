"""Training on one device (``frcnn_tpu/engine/train.py``): roidb
assembly, the SGD + momentum optimizer with the reference's parameter
groups, and ``SolverWrapper`` with ``train_step`` and ``train_model``.

The optimizer equals the JAX package's optax chains: weights get weight
decay, then momentum, then the learning rate; biases get momentum and
2x the learning rate (DOUBLE_BIAS) with no decay (BIAS_DECAY off); frozen
parameters (``requires_grad=False``: conv1, the FIXED_BLOCKS layers) are
left out.  The schedule is read at the step count before it increments.
``GRAD_CLIP`` clips the global norm of the trainable gradients.

Sampling draws come from a ``torch.Generator`` on the model's device,
seeded with ``RNG_SEED + 1``.  Snapshots and resume are not ported yet.
"""

from __future__ import annotations

import time

import torch

from frcnn_tpu_torch.data.loader import RoIDataLayer
from frcnn_tpu_torch.data.roidb import prepare_roidb


def get_training_roidb(imdb, cfg, image_size=None):
    """Flip augmentation + metadata prep (reference get_training_roidb)."""
    if cfg.TRAIN.USE_FLIPPED:
        imdb.append_flipped_images()
    prepare_roidb(imdb, image_size)
    return imdb.roidb


def filter_roidb(roidb, cfg):
    """Drop entries with no usable fg or bg box (reference filter_roidb)."""
    t = cfg.TRAIN

    def is_valid(entry):
        overlaps = entry["max_overlaps"]
        fg = overlaps >= t.FG_THRESH
        bg = (overlaps < t.BG_THRESH_HI) & (overlaps >= t.BG_THRESH_LO)
        return bool(fg.any() or bg.any())

    return [entry for entry in roidb if is_valid(entry)]


def make_lr_schedule(cfg):
    """step → learning rate: LEARNING_RATE * GAMMA^(STEPSIZEs passed), with
    the optional linear warmup over WARMUP_ITERS from WARMUP_FACTOR."""
    t = cfg.TRAIN
    boundaries = sorted(int(s) for s in t.STEPSIZE)

    def schedule(step: int) -> float:
        lr = t.LEARNING_RATE * t.GAMMA ** sum(step >= b for b in boundaries)
        if t.WARMUP_ITERS > 0:
            frac = min(step / t.WARMUP_ITERS, 1.0)
            lr *= t.WARMUP_FACTOR + (1.0 - t.WARMUP_FACTOR) * frac
        return lr

    return schedule


def make_optimizer(model, cfg):
    """(torch.optim.SGD over two parameter groups, schedule).  Each group's
    ``lr_scale`` multiplies the schedule (2 for biases under DOUBLE_BIAS)."""
    t = cfg.TRAIN
    schedule = make_lr_schedule(cfg)
    weights, biases = [], []
    for name, param in model.named_parameters():
        if param.requires_grad:
            (biases if name.endswith("bias") else weights).append(param)
    groups = [{"params": weights, "weight_decay": t.WEIGHT_DECAY, "lr_scale": 1.0},
              {"params": biases, "weight_decay": t.WEIGHT_DECAY if t.BIAS_DECAY else 0.0,
               "lr_scale": 2.0 if t.DOUBLE_BIAS else 1.0}]
    optimizer = torch.optim.SGD(groups, lr=schedule(0), momentum=t.MOMENTUM)
    return optimizer, schedule


def clip_by_global_norm_(params, max_norm: float) -> None:
    """optax.clip_by_global_norm in place: scale every gradient by
    max_norm / norm when the global norm exceeds max_norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))


def _to_device(blobs, device):
    return {"data": torch.as_tensor(blobs["data"]).to(device),
            "im_info": torch.as_tensor(blobs["im_info"], dtype=torch.float32).to(device),
            "gt_boxes": torch.as_tensor(blobs["gt_boxes"], dtype=torch.float32).to(device),
            "gt_labels": torch.as_tensor(blobs["gt_labels"]).to(device),
            "gt_valid": torch.as_tensor(blobs["gt_valid"]).to(device)}


class SolverWrapper:
    """Training orchestrator (reference SolverWrapper) for a model on one
    device.  ``reader`` maps a roidb entry's ``image`` to a BGR array."""

    def __init__(self, model, roidb, cfg=None, reader=None):
        self.model = model
        self.cfg = cfg or model.config
        self.device = next(model.parameters()).device
        self.data_layer = RoIDataLayer(roidb, self.cfg, reader=reader)
        self.optimizer, self.schedule = make_optimizer(model, self.cfg)
        self.generator = torch.Generator(device=self.device).manual_seed(self.cfg.RNG_SEED + 1)
        self.step = 0

    def train_step(self, blobs, draws=None):
        """One SGD step on a minibatch (numpy or tensors).  ``draws``: the
        sampling draws (default: from the solver's generator).  Returns the
        step's losses as detached scalars."""
        cfg = self.cfg
        feed = _to_device(blobs, self.device)
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step) * group["lr_scale"]
        losses, _ = self.model.train_forward(
            feed["data"], feed["im_info"], feed["gt_boxes"], feed["gt_labels"],
            feed["gt_valid"], self.generator if draws is None else draws)
        self.optimizer.zero_grad(set_to_none=True)
        losses["total_loss"].backward()
        if cfg.TRAIN.GRAD_CLIP > 0:
            params = [p for g in self.optimizer.param_groups for p in g["params"]]
            clip_by_global_norm_(params, cfg.TRAIN.GRAD_CLIP)
        self.optimizer.step()
        self.step += 1
        return {name: v.detach() for name, v in losses.items()}

    def train_model(self, max_iters: int):
        """Train until ``max_iters`` steps; returns each step's losses
        (floats).  Prints them every TRAIN.DISPLAY steps."""
        history = []
        t0 = time.perf_counter()
        while self.step < max_iters:
            losses = self.train_step(self.data_layer.forward())
            values = {name: float(v) for name, v in losses.items()}
            history.append(values)
            if self.step % self.cfg.TRAIN.DISPLAY == 0:
                speed = (time.perf_counter() - t0) / len(history)
                print(f"iter: {self.step} / {max_iters}, total loss: {values['total_loss']:.6f}\n"
                      f" >>> rpn_loss_cls: {values['rpn_cross_entropy']:.6f}\n"
                      f" >>> rpn_loss_box: {values['rpn_loss_box']:.6f}\n"
                      f" >>> loss_cls: {values['cross_entropy']:.6f}\n"
                      f" >>> loss_box: {values['loss_box']:.6f}\n"
                      f" >>> lr: {self.schedule(self.step):f}\n"
                      f"speed: {speed:.3f}s / iter")
        return history
