"""Training (``frcnn_tpu/engine/train.py``): roidb
assembly, the SGD + momentum optimizer with the reference's parameter
groups, ``SolverWrapper`` with ``train_step``, ``train_model``, snapshots
and exact resume, and the ``train_net`` driver.

The optimizer equals the JAX package's optax chains: weights get weight
decay, then momentum, then the learning rate; biases get momentum and
2x the learning rate (DOUBLE_BIAS) with no decay (BIAS_DECAY off); a
GroupNorm scale is a weight, its bias a bias; frozen parameters
(``requires_grad=False``: the stem, the FIXED_BLOCKS layers) are left out.
The schedule is read at the step count before it increments.
``GRAD_CLIP`` clips the global norm of the trainable gradients.

The solver runs on the card (``cuda:0``) unless the caller passes
``device``.  Sampling draws come from a ``torch.Generator`` on that device,
seeded with ``RNG_SEED + 1``.  ``train_model`` takes its batches from a
thread that runs the data layer one batch ahead of the step.  Under
TRAIN.IMAGE_CACHE the data layers read a ``ResizedImageCache``
(``build_image_cache``) and the batches are uint8.

With an ``output_dir``, ``train_model`` resumes from the latest snapshot
there, logs the losses to ``train_log.jsonl`` every DISPLAY steps and
snapshots every SNAPSHOT_ITERS steps and at the end, keeping the last
SNAPSHOT_KEPT.  A snapshot is ``<SNAPSHOT_PREFIX>_iter_N.pth`` (the model's
and the optimizer's state_dicts, the step) and a ``.pkl`` beside it: the
step, the global numpy RNG, the data layers' states as of the last batch
the step consumed, and the state of the sampling generator.  The JAX run
derives each step's key from the step; here the draws come from a
stateful generator, so its state is part of the snapshot, and a run
stopped at a snapshot and resumed equals the straight run bit for bit.

Under a ``mesh`` (``frcnn_tpu_torch/parallel/mesh.py``) each rank holds a
replica of the model on the mesh's device and trains on its rows of every
global batch of IMS_PER_BATCH images (which must be a multiple of the mesh
size): its data layer makes the whole batch's draws but prepares only its
rows, its sampling draws are the whole batch's rows for its images
(``ShardedDraws``), and the gradients are averaged over the ranks in f32
after ``backward()`` and before the clip and the update.  The step then
equals the one-device step on the global batch up to the order of the
gradient reduction.  Rank 0 alone writes snapshots, ``train_log.jsonl``,
summaries and the log; every rank restores from a snapshot.
"""

from __future__ import annotations

import glob
import importlib.util
import json
import os
import os.path as osp
import pickle
import queue
import threading
import time

import numpy as np
import torch

from frcnn_tpu_torch.data.loader import RoIDataLayer
from frcnn_tpu_torch.data.roidb import prepare_roidb
from frcnn_tpu_torch.engine import resolve_device
from frcnn_tpu_torch.models.targets import ShardedDraws
from frcnn_tpu_torch.parallel.mesh import (all_reduce_grads_, all_reduce_mean, barrier,
                                           broadcast_flag, rank0_first, replicate)
from frcnn_tpu_torch.utils.timer import Timer
from frcnn_tpu_torch.utils.trace import span


def get_training_roidb(imdb, cfg, image_size=None):
    """Metadata prep + flip augmentation (reference get_training_roidb).
    The entries are prepared first, so the flip takes each image's width
    from its entry and the flipped entries carry the metadata with them;
    ``image_size`` maps an image path to (height, width) where an entry has
    no size (default: the image read by ``read_image``)."""
    prepare_roidb(imdb, image_size)
    if cfg.TRAIN.USE_FLIPPED:
        imdb.append_flipped_images()
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


def combined_roidb(imdb_names: str, cfg, reader=None):
    """(imdb of the first name, training roidb of every '+'-joined name)
    (reference trainval_net.combined_roidb); datasets under cfg.DATA_DIR,
    image sizes read through ``reader`` (default: ``read_image``)."""
    from frcnn_tpu_torch.data.factory import get_imdb

    image_size = None if reader is None else (lambda path: reader(path).shape[:2])

    def get_roidb(name):
        imdb = get_imdb(name, data_dir=cfg.DATA_DIR)
        print(f"Loaded dataset `{imdb.name}`")
        imdb.set_proposal_method(cfg.TRAIN.PROPOSAL_METHOD)
        return imdb, get_training_roidb(imdb, cfg, image_size)

    names = imdb_names.split("+")
    imdb, roidb = get_roidb(names[0])
    for name in names[1:]:
        roidb.extend(get_roidb(name)[1])
    return imdb, roidb


def build_image_cache(imdb, roidb, valroidb, cfg, reader=None):
    """The ``ResizedImageCache`` of TRAIN.IMAGE_CACHE
    (``frcnn_tpu/engine/train.py:371-390``): every image of ``roidb`` and
    ``valroidb`` at every TRAIN.SCALES under TRAIN.MAX_SIZE and
    DEVICE.BUCKETS, read through ``reader`` (default ``read_image``), at
    ``<imdb.cache_path>/<imdb.name>_resized``: at the dataset level, so
    experiments share one copy.  A current cache there is reused."""
    from frcnn_tpu_torch.data.cache import ResizedImageCache

    paths = [r["image"] for r in roidb] + [r["image"] for r in valroidb or ()]
    return ResizedImageCache.build(paths, osp.join(imdb.cache_path, f"{imdb.name}_resized"),
                                   targets=cfg.TRAIN.SCALES, max_size=cfg.TRAIN.MAX_SIZE,
                                   buckets=cfg.DEVICE.BUCKETS, reader=reader)


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
    """The batch on ``device``; ``data`` keeps its dtype (uint8 from the
    resized-image cache: the model casts it)."""
    return {"data": torch.as_tensor(blobs["data"]).to(device),
            "im_info": torch.as_tensor(blobs["im_info"], dtype=torch.float32).to(device),
            "gt_boxes": torch.as_tensor(blobs["gt_boxes"], dtype=torch.float32).to(device),
            "gt_labels": torch.as_tensor(blobs["gt_labels"]).to(device),
            "gt_valid": torch.as_tensor(blobs["gt_valid"]).to(device)}




class _Prefetcher:
    """A thread that runs the data layer one batch ahead of the training
    loop.  Each item is a batch and the layer's state after it, so a
    snapshot taken after batch k resumes with batch k + 1 however far the
    thread has run ahead.  The layer belongs to the thread until ``close``."""

    def __init__(self, layer, n: int):
        self._queue: queue.Queue = queue.Queue(maxsize=1)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(layer, n), daemon=True)
        self._thread.start()

    def _run(self, layer, n):
        try:
            for _ in range(n):
                if self._stop.is_set():
                    return
                blobs = layer.forward()
                self._queue.put((blobs, layer.get_state()))
        except Exception as e:  # raised again in the consumer
            self._queue.put(e)

    def get(self):
        item = self._queue.get()
        if isinstance(item, Exception):
            raise RuntimeError("data prefetch thread failed") from item
        return item

    def close(self):
        self._stop.set()
        while self._thread.is_alive():  # unblock a put the loop will never take
            try:
                self._queue.get(timeout=0.05)
            except queue.Empty:
                pass
        self._thread.join()


class SolverWrapper:
    """Training orchestrator (reference SolverWrapper).  The model is moved
    to ``device`` before the optimizer is made:
    ``cuda:0`` by default (a ``RuntimeError`` when there is no card),
    ``"cpu"`` on request.  ``reader`` maps a roidb entry's ``image`` to a
    BGR array (default ``read_image``).  ``aux`` holds the last step's
    auxiliary outputs of ``train_forward`` (detached).

    Keyword-only: ``imdb`` (class names for the image summary),
    ``valroidb`` (validation losses every SUMMARY_INTERVAL seconds),
    ``output_dir`` (snapshots, resume, ``train_log.jsonl``), ``tb_dir``
    (summaries) and ``pretrained`` (a state_dict whose tensors of matching
    name and shape replace the model's).

    Under TRAIN.IMAGE_CACHE the roidbs' images are read once through
    ``reader`` into ``build_image_cache``'s cache, before the data layers
    are made, and the layers read the cache: uint8 batches.  DEVICE.REMAT
    is accepted and ignored, as in the JAX package, where no module reads
    it.

    ``mesh``: train data-parallel as one rank of it (the module docstring);
    the model is replicated from rank 0, ``device`` defaults to the mesh's,
    and IMS_PER_BATCH must be a multiple of the mesh size (``ValueError``)."""

    def __init__(self, model, roidb, cfg=None, reader=None, device=None, *, imdb=None,
                 valroidb=None, output_dir=None, tb_dir=None, pretrained=None, mesh=None):
        self.cfg = cfg or model.config
        if self.cfg.TRAIN.IMAGE_CACHE and imdb is None:
            raise ValueError("TRAIN.IMAGE_CACHE needs the imdb (imdb=...): the resized-image "
                             "cache lives at <imdb.cache_path>/<imdb.name>_resized")
        self.mesh = mesh
        self.device = resolve_device(device, mesh)
        rows = None if mesh is None else mesh.rows(self.cfg.TRAIN.IMS_PER_BATCH)
        self._lead = mesh is None or mesh.rank == 0
        if self.cfg.TRAIN.IMAGE_CACHE:
            reader = rank0_first(
                lambda: build_image_cache(imdb, roidb, valroidb, self.cfg, reader), mesh)
        if pretrained is not None:
            model.load_state_dict(_merge_pretrained(model.state_dict(), pretrained))
        self.model = model.to(self.device)
        if mesh is not None:
            replicate(self.model, mesh)
        self.imdb = imdb
        self.output_dir = output_dir
        self.tb_dir = tb_dir
        self.data_layer = RoIDataLayer(roidb, self.cfg, reader=reader, rows=rows)
        self.data_layer_val = (RoIDataLayer(valroidb, self.cfg, random=True, reader=reader,
                                            rows=rows)
                               if valroidb is not None else None)
        self.optimizer, self.schedule = make_optimizer(model, self.cfg)
        self.generator = torch.Generator(device=self.device).manual_seed(self.cfg.RNG_SEED + 1)
        self.step = 0
        self.aux = {}
        self._layer_state_consumed = None
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)

    def _draws(self, generator):
        return (generator if self.mesh is None
                else ShardedDraws(generator, self.mesh.rank, self.mesh.size))

    def train_step(self, blobs, draws=None):
        """One SGD step on a minibatch (numpy or tensors).  ``draws``: the
        sampling draws (default: from the solver's generator).  Under a mesh
        ``blobs`` and ``draws`` are this rank's rows (``shard_batch``,
        ``shard_draws``).  Returns the step's losses as detached scalars,
        under a mesh their mean over the ranks."""
        cfg = self.cfg
        feed = _to_device(blobs, self.device)
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step) * group["lr_scale"]
        losses, aux = self.model.train_forward(
            feed["data"], feed["im_info"], feed["gt_boxes"], feed["gt_labels"],
            feed["gt_valid"], self._draws(self.generator) if draws is None else draws)
        self.optimizer.zero_grad(set_to_none=True)
        losses["total_loss"].backward()
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        if self.mesh is not None:
            # before the clip, so that every rank clips the same global norm
            all_reduce_grads_(params, self.mesh)
            losses = all_reduce_mean(losses, self.mesh)
        if cfg.TRAIN.GRAD_CLIP > 0:
            clip_by_global_norm_(params, cfg.TRAIN.GRAD_CLIP)
        self.optimizer.step()
        self.step += 1
        self.aux = {name: v.detach() if torch.is_tensor(v) else v for name, v in aux.items()}
        return {name: v.detach() for name, v in losses.items()}

    @torch.no_grad()
    def val_losses(self, blobs):
        """``train_forward``'s losses on a validation batch, as floats.  The
        draws come from a generator of their own seeded from the step, so
        validation leaves the training draws alone.  Under a mesh: this rank's
        rows, and the losses' mean over the ranks."""
        feed = _to_device(blobs, self.device)
        draws = torch.Generator(device=self.device).manual_seed(
            self.cfg.RNG_SEED + 10**9 + self.step)
        losses, _ = self.model.train_forward(feed["data"], feed["im_info"], feed["gt_boxes"],
                                             feed["gt_labels"], feed["gt_valid"],
                                             self._draws(draws))
        if self.mesh is not None:
            losses = all_reduce_mean(losses, self.mesh)
        return {name: float(v) for name, v in losses.items()}

    # -- snapshots (reference snapshot / find_previous / from_snapshot) -----
    def _snapshots(self):
        """The snapshots' .pkl paths in ``output_dir``, oldest first."""
        pkls = glob.glob(osp.join(self.output_dir, f"{self.cfg.TRAIN.SNAPSHOT_PREFIX}_iter_*.pkl"))
        return sorted(pkls, key=lambda p: int(p.rsplit("_", 1)[1][:-4]))

    def snapshot(self, step: int) -> str:
        """Write ``<prefix>_iter_<step>.pth`` and its ``.pkl``; prune.  Under
        a mesh rank 0 writes and prunes (the replicas and their states are
        equal), with a barrier between, so no rank reads a part-written
        snapshot."""
        path = osp.join(self.output_dir, f"{self.cfg.TRAIN.SNAPSHOT_PREFIX}_iter_{step}")
        if self._lead:
            self._write_snapshot(step, path)
        if self.mesh is not None:
            barrier(self.mesh)
        if self._lead:
            self._prune_snapshots()
        return path + ".pth"

    def _write_snapshot(self, step, path):
        torch.save({"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                    "step": step}, path + ".pth")
        layer_state = self._layer_state_consumed
        if layer_state is None:
            layer_state = self.data_layer.get_state()
        with open(path + ".pkl", "wb") as f:
            pickle.dump({"iter": step, "np_rng": np.random.get_state(),
                         "layer_state": layer_state,
                         "val_layer_state": (self.data_layer_val.get_state()
                                             if self.data_layer_val is not None else None),
                         "generator": self.generator.get_state()}, f)
        print(f"Wrote snapshot to: {path}.pth")

    def _prune_snapshots(self):
        kept = self.cfg.TRAIN.SNAPSHOT_KEPT
        if not kept:
            return
        for pkl in self._snapshots()[:-kept]:
            os.remove(pkl)
            pth = pkl[:-4] + ".pth"
            if osp.exists(pth):
                os.remove(pth)

    def find_previous(self):
        """The latest snapshot's .pkl in ``output_dir``, or None."""
        pkls = self._snapshots()
        return pkls[-1] if pkls else None

    def from_snapshot(self, pkl_path: str) -> int:
        """Restore the model, the optimizer, the step, the numpy RNG, the
        data layers and the sampling generator; returns the step."""
        with open(pkl_path, "rb") as f:
            meta = pickle.load(f)
        state = torch.load(pkl_path[:-4] + ".pth", map_location=self.device, weights_only=True)
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        np.random.set_state(meta["np_rng"])
        self.data_layer.set_state(meta["layer_state"])
        self._layer_state_consumed = meta["layer_state"]
        if self.data_layer_val is not None and meta.get("val_layer_state") is not None:
            self.data_layer_val.set_state(meta["val_layer_state"])
        self.generator.set_state(meta["generator"])
        if self._lead:
            print(f"Restored from {pkl_path} (iter {meta['iter']})")
        return self.step

    # -- the loop -------------------------------------------------------------
    def _gt_overlay(self, blobs):
        """The batch's first image with its gt boxes drawn (uint8 RGB)."""
        from frcnn_tpu_torch.utils.visualization import draw_bounding_boxes

        im = np.clip(np.asarray(blobs["data"][0])[:, :, ::-1], 0, 255).astype(np.uint8)
        v = np.asarray(blobs["gt_valid"][0])
        names = list(getattr(self.imdb, "classes", [])) or None
        return draw_bounding_boxes(im, np.asarray(blobs["gt_boxes"][0])[v],
                                   labels=np.asarray(blobs["gt_labels"][0])[v], class_names=names)

    def _profile_window(self, profiler):
        """Open torch.profiler at DEVICE.PROFILE_START for PROFILE_STEPS
        steps, over every thread; the trace, with the ``frcnn.train.*`` and
        ``frcnn.data.forward`` spans (``utils/trace.py``), goes to
        PROFILE_DIR/trace_iter_<start>.json."""
        d = self.cfg.DEVICE
        if profiler is None and d.PROFILE_DIR and self.step == d.PROFILE_START:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            every_thread = torch.profiler._ExperimentalConfig(profile_all_threads=True)
            profiler = torch.profiler.profile(activities=activities,
                                              experimental_config=every_thread)
            profiler.start()
        elif profiler is not None and self.step == d.PROFILE_START + d.PROFILE_STEPS:
            self._close_profile(profiler)
            profiler = None
        return profiler

    def _close_profile(self, profiler):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        os.makedirs(self.cfg.DEVICE.PROFILE_DIR, exist_ok=True)
        path = osp.join(self.cfg.DEVICE.PROFILE_DIR,
                        f"trace_iter_{self.cfg.DEVICE.PROFILE_START}.json")
        profiler.export_chrome_trace(path)
        print(f"wrote profiler trace to {path}")

    def train_model(self, max_iters: int):
        """Train until ``max_iters`` steps; returns the losses (floats) of
        each step this call ran.  Prints them every TRAIN.DISPLAY steps."""
        cfg = self.cfg
        t = cfg.TRAIN
        if self.output_dir:
            last = self.find_previous()
            if last:
                self.from_snapshot(last)
        start = self.step
        lead = self._lead
        log_f = (open(osp.join(self.output_dir, "train_log.jsonl"), "a")
                 if self.output_dir and lead else None)
        writer = None
        if self.tb_dir and lead:
            from frcnn_tpu_torch.utils.summary import SummaryWriter

            writer = SummaryWriter(self.tb_dir)
        batches = _Prefetcher(self.data_layer, max_iters - start)
        history, timer, profiler = [], Timer(), None
        last_summary = time.time()
        try:
            with torch.autograd.set_detect_anomaly(cfg.DEVICE.DEBUG_NANS):
                while self.step < max_iters:
                    if lead:
                        profiler = self._profile_window(profiler)
                    timer.tic()
                    with span("frcnn.train.data_wait"):
                        blobs, self._layer_state_consumed = batches.get()
                    with span("frcnn.train.step"):
                        losses = self.train_step(blobs)
                    with span("frcnn.train.loss_readback"):
                        values = {name: float(v) for name, v in losses.items()}
                    timer.toc()
                    history.append(values)
                    step = self.step
                    if step % t.DISPLAY == 0 and lead:
                        lr = self.schedule(step)
                        print(f"iter: {step} / {max_iters}, total loss: {values['total_loss']:.6f}\n"
                              f" >>> rpn_loss_cls: {values['rpn_cross_entropy']:.6f}\n"
                              f" >>> rpn_loss_box: {values['rpn_loss_box']:.6f}\n"
                              f" >>> loss_cls: {values['cross_entropy']:.6f}\n"
                              f" >>> loss_box: {values['loss_box']:.6f}\n"
                              f" >>> lr: {lr:f}\n"
                              f"speed: {timer.average_time:.3f}s / iter")
                        if log_f is not None:
                            log_f.write(json.dumps({"iter": step, "ts": time.time(), "lr": lr,
                                                    **values}) + "\n")
                            log_f.flush()
                        if writer is not None:
                            writer.scalars({**values, "lr": lr,
                                            "speed_s_per_iter": timer.average_time}, step)
                    if self.output_dir and step % t.SNAPSHOT_ITERS == 0:
                        self.snapshot(step)
                    if self.data_layer_val is not None or self.tb_dir:
                        due = time.time() - last_summary > t.SUMMARY_INTERVAL
                        if self.mesh is not None:   # val_losses is collective: rank 0 decides
                            due = broadcast_flag(due, self.mesh)
                        if due:
                            self._summarize(blobs, writer, log_f)
                            last_summary = time.time()
            if self.output_dir and self.step > start and self.step % t.SNAPSHOT_ITERS != 0:
                self.snapshot(self.step)
        finally:
            batches.close()
            if profiler is not None:
                self._close_profile(profiler)
            if writer is not None:
                writer.close()
            if log_f is not None:
                log_f.close()
        return history

    def _summarize(self, blobs, writer, log_f):
        """The validation losses (to the log and the writer) and, where PIL
        is installed, the gt overlay of the last batch (to the writer)."""
        step = self.step
        if writer is not None and importlib.util.find_spec("PIL") is not None:
            writer.image("ground_truth", self._gt_overlay(blobs), step)
        if self.data_layer_val is None:
            return
        vloss = self.val_losses(self.data_layer_val.forward())
        if writer is not None:
            writer.scalars({f"val/{k}": v for k, v in vloss.items()}, step)
        if log_f is not None:
            log_f.write(json.dumps({"iter": step, **{f"val_{k}": v for k, v in vloss.items()}})
                        + "\n")
            log_f.flush()


def train_net(model, imdb, roidb, valroidb, output_dir: str, tb_dir: str | None = None,
              cfg=None, pretrained=None, max_iters: int = 40000, reader=None, device=None,
              mesh=None):
    """Train entry point (reference train_val.train_net): filter the
    roidbs, resume from ``output_dir`` if it holds a snapshot, train to
    ``max_iters``.  With no ``pretrained`` weights a GroupNorm net starts
    from ``init_reference_`` (its generator seeded with RNG_SEED).  Under a
    ``mesh`` this process trains as one rank of it (``SolverWrapper``).
    Returns the SolverWrapper."""
    cfg = cfg or model.config
    if pretrained is None and model.backbone.norm == "group":
        # from scratch: the weights the JAX package's model.init draws
        from frcnn_tpu_torch.models.fpn import init_reference_

        init_reference_(model, torch.Generator().manual_seed(cfg.RNG_SEED))
    elif pretrained is None:
        # a frozen-BN ResNet or MobileNet, or VGG-16, normalizes nothing at random init
        print("WARNING: no pretrained weights and a frozen-BN or VGG-16 backbone — the reference "
              "design assumes ImageNet initialization.  For training from scratch use a "
              "*_fpn_gn net (GroupNorm) or set TRAIN.WARMUP_ITERS/GRAD_CLIP and a lower "
              "LEARNING_RATE.")
    roidb = filter_roidb(roidb, cfg)
    valroidb = filter_roidb(valroidb, cfg) if valroidb is not None else None
    sw = SolverWrapper(model, roidb, cfg, reader=reader, device=device, imdb=imdb,
                       valroidb=valroidb, output_dir=output_dir, tb_dir=tb_dir,
                       pretrained=pretrained, mesh=mesh)
    if sw._lead:
        print("Solving...")
    sw.train_model(max_iters)
    if sw._lead:
        print("done solving")
    return sw


def _merge_pretrained(state, pretrained):
    """``state`` with every tensor of ``pretrained`` whose name and shape
    match put in its place (both state_dicts); prints the count."""
    merged = dict(state)
    n = 0
    for name, tensor in pretrained.items():
        if name in state and tuple(state[name].shape) == tuple(tensor.shape):
            merged[name] = tensor
            n += 1
    print(f"Loaded {n}/{len(pretrained)} pretrained tensors")
    return merged
