"""The training run: ``SolverWrapper.train_model`` over a seeded roidb,
with TRAIN.IMAGE_CACHE as the traffic sets it.

Set-up builds the solver once and steps it through ``train_model`` itself:
one step (the optimizer's momentum then holds the first gradient), two
more (the change of every weight over three steps), then the warm-up
steps, whose time sets the window's step count.  The window is one
``train_model`` call of that many steps, timed whole.  The check follows
the first three steps with the reference on the same batches and draws.
"""

from __future__ import annotations

import math
import os
import shutil
import tempfile
import time
import types

import torch

from benchmark.harness import program, traffic
from benchmark.harness.check import training_readings
from benchmark.harness.weights import make_weights
from benchmark.reference import data as refdata
from benchmark.reference.detector import Net, trainable


def _norms(tensors: dict) -> dict:
    return {k: float(v.detach().float().norm()) for k, v in tensors.items()}


class TrainCell:
    kind = "train"

    def __init__(self, cell, seed: int, device, workdir: str | None = None):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.t = cell.traffic
        self.c = program.settings(cell.config, self.t, seed)
        self.workdir = workdir or os.path.join(tempfile.gettempdir(), "frcnn_benchmark",
                                               cell.name)

    # -- set-up ---------------------------------------------------------------
    def setup(self):
        from frcnn_tpu_torch.engine.train import SolverWrapper

        conf, c, t = self.cell.config, self.c, self.t
        image_dir = os.path.join(self.workdir, "images")
        os.makedirs(image_dir, exist_ok=True)
        self.roidb, self.images = traffic.roidb({**t, "image_dir": image_dir},
                                                conf["num_classes"], self.seed, self.device)
        for path in self.images:       # the image cache records each file's size and time
            open(path, "wb").close()
        self.weights = make_weights(conf["net"], conf["num_classes"], c, self.seed, self.device,
                                    conf.get("weights"))
        model, cfg = program.build(conf, c, self.weights, self.device)
        self.weights = {k: v.cpu() for k, v in self.weights.items()}
        imdb = types.SimpleNamespace(name="benchmark", classes=[],
                                     cache_path=os.path.join(self.workdir, "cache"))
        self.solver = SolverWrapper(model, self.roidb, cfg, reader=self.images.__getitem__,
                                    device=self.device, imdb=imdb if c["TRAIN.IMAGE_CACHE"] else None)
        params = {n: p for n, p in model.named_parameters() if p.requires_grad}
        start = {n: p.detach().clone() for n, p in params.items()}
        first = self.solver.train_model(1)
        state = self.solver.optimizer.state
        # a weight the step left without momentum was never updated: gradient 0
        bufs = {n: state.get(p, {}).get("momentum_buffer", torch.zeros_like(p))
                for n, p in params.items()}
        grad = _norms(bufs)
        rpn_grad = {n: v.detach().float().cpu().clone() for n, v in bufs.items()
                    if n.startswith("rpn_")}
        del bufs
        rest = self.solver.train_model(self.t["check_steps"])
        update = _norms({n: p.detach().float() - start[n].float() for n, p in params.items()})
        self.answers = {"losses": [h["total_loss"] for h in first + rest], "grad": grad,
                        "update": update, "rpn_grad": rpn_grad,
                        "rpn_loss": first[0]["rpn_cross_entropy"] + first[0]["rpn_loss_box"]}
        del start
        # warm up every bucket the traffic's batches use: steps up to the first
        # batch of each bucket in the data layer's order, at least ``warm_steps``
        steps = self.solver.step
        buckets = [bk for _, bk in self._buckets(0, len(self.roidb) // c["TRAIN.IMS_PER_BATCH"])]
        last_new = max(buckets.index(bk) for bk in set(buckets))
        n = max(self.t["warm_steps"], last_new + 1 - steps)
        t0 = time.perf_counter()
        self.solver.train_model(steps + n)
        self.step_s = (time.perf_counter() - t0) / n

    # -- the timed path ---------------------------------------------------------
    def window(self, seconds: float, count: int | None = None):
        """One ``train_model`` call of ``count`` steps, or of as many as the
        warm-up's step time puts in ``seconds`` → [(steps, start, end)]."""
        n = count or max(1, math.ceil(seconds / self.step_s))
        t0 = time.perf_counter()
        self.solver.train_model(self.solver.step + n)
        return [(n, t0, time.perf_counter())]

    def end_to_end(self, recs) -> dict:
        n, t0, t1 = recs[0]
        return {self.t["metrics"]["rate"]: traffic.rate(n * self.c["TRAIN.IMS_PER_BATCH"], t1 - t0)}

    def _buckets(self, first: int, n: int):
        """(B, bucket) of steps first..first+n-1 of the data layer's first
        order (an epoch; later epochs hold the same batches reshuffled)."""
        c = self.c
        b = c["TRAIN.IMS_PER_BATCH"]
        order = refdata.batch_order(self.roidb, b, c["RNG_SEED"], c["DEVICE.BUCKETS"])
        out = []
        for s in range(first, first + n):
            idx = [order[(s * b + j) % len(order)] for j in range(b)]
            shapes = [refdata.scale_and_bucket(self.roidb[i]["height"], self.roidb[i]["width"],
                                               c["TRAIN.SCALES"][0], c["TRAIN.MAX_SIZE"],
                                               c["DEVICE.BUCKETS"])[1] for i in idx]
            out.append((b, tuple(refdata.snap(shapes, c["DEVICE.BUCKETS"]))))
        return out

    def batches(self, recs):
        """(B, bucket) of every step of the window, as the data layer made
        them (recorded by the traced window's span on its ``forward``)."""
        return self.spans.shapes[:recs[0][0]]

    def free(self):
        """Drop the solver and the files the set-up wrote (the placeholder
        images, the resized-image cache)."""
        del self.solver
        shutil.rmtree(self.workdir, ignore_errors=True)

    # -- the check -------------------------------------------------------------
    def reference_steps(self, quant=None, fault=None) -> dict:
        """The reference's first ``check_steps`` SGD steps (the lineage's two
        groups: weights with decay, biases at twice the rate without; momentum;
        the global-norm clip where set) on the batches the data layer's first
        order gives and the draws of a generator seeded as the solver's.
        ``fault`` plants one in the reference put in the program's place:
        "half_batch" (the first half of each batch, the mean over it) or
        "scaled_loss" (the loss x1.5 where it is made)."""
        c, conf = self.c, self.cell.config
        W = {k: v.to(self.device).clone() for k, v in self.weights.items()}
        names = [k for k in W if trainable(k, c)]
        for k in names:
            W[k].requires_grad_(True)
        ref = Net(W, c, conf["net"], conf["num_classes"], quant)
        b = c["TRAIN.IMS_PER_BATCH"]
        order = refdata.batch_order(self.roidb, b, c["RNG_SEED"], c["DEVICE.BUCKETS"])
        g = torch.Generator(device=self.device).manual_seed(c["RNG_SEED"] + 1)
        start = {k: W[k].detach().clone() for k in names}
        bufs, losses, out = {}, [], {}
        for step in range(self.t["check_steps"]):
            entries = [self.roidb[i] for i in order[step * b:(step + 1) * b]]
            batch = refdata.train_batch(entries, self.images, c, bool(c["TRAIN.IMAGE_CACHE"]))
            batch = [torch.as_tensor(x).to(self.device) for x in batch]
            if fault == "half_batch":
                batch = [x[:(b + 1) // 2] for x in batch]
            loss = ref.train_losses(*batch, lambda *size: torch.rand(size, generator=g,
                                                                     device=g.device))
            if fault == "scaled_loss":
                loss = {k: v * 1.5 for k, v in loss.items()}
            if step == 0:
                out["rpn_loss"] = float((loss["rpn_cross_entropy"] + loss["rpn_loss_box"]).detach())
            for k in names:
                W[k].grad = None
            loss["total_loss"].backward()
            losses.append(float(loss["total_loss"].detach()))
            with torch.no_grad():
                grads = {k: W[k].grad for k in names}
                if step == 0:
                    out["raw_grad"] = _norms(grads)
                if c["TRAIN.GRAD_CLIP"] > 0:
                    norm = torch.sqrt(sum((v ** 2).sum() for v in grads.values()))
                    if norm >= c["TRAIN.GRAD_CLIP"]:
                        grads = {k: v / norm * c["TRAIN.GRAD_CLIP"] for k, v in grads.items()}
                lr = _lr(c, step)
                for k in names:
                    bias = k.endswith("bias")
                    d = grads[k] if bias and not c["TRAIN.BIAS_DECAY"] \
                        else grads[k] + c["TRAIN.WEIGHT_DECAY"] * W[k]
                    bufs[k] = d.clone() if step == 0 else c["TRAIN.MOMENTUM"] * bufs[k] + d
                    W[k] -= lr * (2.0 if bias and c["TRAIN.DOUBLE_BIAS"] else 1.0) * bufs[k]
                if step == 0:
                    out["grad"] = _norms(bufs)
                    out["rpn_grad"] = {k: v.float().cpu() for k, v in bufs.items()
                                       if k.startswith("rpn_")}
        out["losses"] = losses
        out["update"] = _norms({k: W[k].detach() - start[k] for k in names})
        return out

    def readings(self, recs, quant=None, fault=None) -> dict:
        ref = self.reference_steps()
        prog = (self.answers if quant is None and fault is None
                else self.reference_steps(quant, fault))
        return training_readings(prog, ref)


def _lr(c: dict, step: int) -> float:
    lr = c["TRAIN.LEARNING_RATE"] * c["TRAIN.GAMMA"] ** sum(step >= s for s in c["TRAIN.STEPSIZE"])
    if c["TRAIN.WARMUP_ITERS"] > 0:
        frac = min(step / c["TRAIN.WARMUP_ITERS"], 1.0)
        lr *= c["TRAIN.WARMUP_FACTOR"] + (1.0 - c["TRAIN.WARMUP_FACTOR"]) * frac
    return lr
