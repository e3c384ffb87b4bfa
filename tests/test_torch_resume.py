"""Snapshots and exact resume of the port's trainer, on the CPU, f32: res50
C4 at the 128x192 bucket, batch 2 (the overrides of
``tests/test_torch_train.py``), seeded weights, the ``voc_root`` devkit
read through the default reader.

  * exact resume (the recipe of ``tests/test_resume_exact.py``, through the
    prefetch thread): 4 steps straight equal 2 steps, a snapshot, a new
    ``train_net`` on the same directory and 2 more steps, bit for bit (the
    parameters, the buffers, the optimizer's momentum, the logged losses),
    where the interrupted run's prefetch thread had read a batch past the
    snapshot.
    The straight run also computes validation losses every step and writes
    summaries, which must leave the training draws alone; the resumed
    half runs with anomaly detection on and the first half opens a
    profiler window;
  * ``train_net`` gives the losses and the parameters of
    ``SolverWrapper.train_step`` over the same batches;
  * snapshot files: the .pth/.pkl pairs, pruning to SNAPSHOT_KEPT,
    ``find_previous`` picks the highest iteration;
  * ``load_params`` reads a snapshot and a params-only file;
    ``_merge_pretrained`` takes the tensors whose name and shape match;
  * TRAIN.IMAGE_CACHE without an imdb raises a ValueError naming it;
    DEVICE.REMAT is accepted.
"""

import json
import os
import os.path as osp
import pickle

import numpy as np
import pytest
import torch

from frcnn_tpu_torch import cfg_from_list, default_config
from frcnn_tpu_torch.data.loader import RoIDataLayer
from frcnn_tpu_torch.data.pascal_voc import pascal_voc
from frcnn_tpu_torch.engine.checkpoint import load_params, save_params
from frcnn_tpu_torch.engine.train import (SolverWrapper, _merge_pretrained, filter_roidb,
                                          get_training_roidb, train_net)
from frcnn_tpu_torch.models.network import build_model, init_random_
from frcnn_tpu_torch.utils import summary
from tests.test_torch_train import OVERRIDES

RUN = ["TRAIN.DISPLAY", "1", "TRAIN.SNAPSHOT_KEPT", "3", "TRAIN.SUMMARY_INTERVAL", "0",
       "TRAIN.LEARNING_RATE", "0.01"]


def _cfg(*extra):
    return cfg_from_list(default_config(), OVERRIDES + RUN + list(extra))


def _model(cfg):
    model = build_model("res50", 21, cfg)
    init_random_(model, torch.Generator().manual_seed(0))
    return model


def _log(out_dir):
    with open(osp.join(out_dir, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(voc_root, tmp_path_factory):
    root, _ = voc_root
    base = tmp_path_factory.mktemp("resume")
    ds = pascal_voc("trainval", "2007", devkit_path=osp.join(root, "VOCdevkit2007"),
                    data_dir=str(base))
    roidb = get_training_roidb(ds, _cfg())
    valroidb = [dict(e) for e in roidb[:4]]
    a, b = str(base / "a"), str(base / "b")

    # A: 4 steps straight, validation losses and summaries every step
    cfg_a = _cfg("TRAIN.SNAPSHOT_ITERS", "100")
    board = summary.SummaryWriter._board
    summary.SummaryWriter._board = lambda self: None   # the JSONL only: no TensorBoard import
    try:
        sw_a = train_net(_model(cfg_a), ds, roidb, valroidb, a, tb_dir=str(base / "tb"),
                         cfg=cfg_a, max_iters=4, device="cpu")
    finally:
        summary.SummaryWriter._board = board
    # B: a run stopped after its snapshot at 2 (a profiler window over step
    # 1): it ran to 3, and the snapshot at 3 is removed, so the prefetch
    # thread was a batch ahead of the snapshot at 2; then a new train_net on
    # the same directory to 4 with anomaly detection on
    profile_dir = str(base / "profile")
    cfg_b = _cfg("TRAIN.SNAPSHOT_ITERS", "2", "DEVICE.PROFILE_DIR", profile_dir,
                 "DEVICE.PROFILE_START", "0", "DEVICE.PROFILE_STEPS", "1")
    train_net(_model(cfg_b), ds, roidb, None, b, cfg=cfg_b, max_iters=3, device="cpu")
    for ext in (".pth", ".pkl"):
        os.remove(osp.join(b, "default_iter_3" + ext))
    cfg_b2 = _cfg("TRAIN.SNAPSHOT_ITERS", "100", "DEVICE.DEBUG_NANS", "True")
    sw_b = train_net(_model(cfg_b2), ds, roidb, None, b, cfg=cfg_b2, max_iters=4, device="cpu")
    return {"roidb": roidb, "a": a, "b": b, "sw_a": sw_a, "sw_b": sw_b, "base": base,
            "profile_dir": profile_dir}


def test_interrupted_training_is_bit_exact(runs):
    sw_a, sw_b = runs["sw_a"], runs["sw_b"]
    assert sw_a.step == sw_b.step == 4
    state_a, state_b = sw_a.model.state_dict(), sw_b.model.state_dict()
    assert state_a.keys() == state_b.keys()
    for name, value in state_a.items():
        assert torch.equal(value, state_b[name]), name
    opt_a, opt_b = sw_a.optimizer.state_dict()["state"], sw_b.optimizer.state_dict()["state"]
    assert opt_a.keys() == opt_b.keys() and len(opt_a) > 0
    for k in opt_a:
        assert torch.equal(opt_a[k]["momentum_buffer"], opt_b[k]["momentum_buffer"])
    assert torch.equal(sw_a.generator.get_state(), sw_b.generator.get_state())
    train_a = [r for r in _log(runs["a"]) if "total_loss" in r]
    train_b = [r for r in _log(runs["b"]) if "total_loss" in r]
    assert [r["iter"] for r in train_a] == [1, 2, 3, 4]
    assert [r["iter"] for r in train_b] == [1, 2, 3, 3, 4]      # step 3 before and after resume
    by_iter = {r["iter"]: {k: v for k, v in r.items() if k != "ts"} for r in train_a}
    for rb in train_b:
        assert {k: v for k, v in rb.items() if k != "ts"} == by_iter[rb["iter"]]
    assert all(np.isfinite(r["total_loss"]) for r in train_a)
    assert train_a[0]["rpn_loss_box"] > 0 and train_a[0]["loss_box"] > 0


def test_validation_and_summaries_are_logged(runs):
    val = [r for r in _log(runs["a"]) if "val_total_loss" in r]
    assert [r["iter"] for r in val] == [1, 2, 3, 4]
    assert all(np.isfinite(r["val_total_loss"]) for r in val)
    with open(runs["base"] / "tb" / "events.jsonl") as f:
        events = [json.loads(line) for line in f]
    assert {"total_loss", "lr", "speed_s_per_iter"} <= set(events[0])
    assert any("val/total_loss" in e for e in events)
    assert os.listdir(runs["profile_dir"]) == ["trace_iter_0.json"]


def test_train_net_equals_train_step(runs):
    """The driver (prefetch thread, snapshots, log) against the bare
    ``train_step`` over the same batches from the same weights."""
    cfg = _cfg()
    roidb = filter_roidb(runs["roidb"], cfg)
    solver = SolverWrapper(_model(cfg), roidb, cfg, device="cpu")
    layer = RoIDataLayer(roidb, cfg)
    losses = [{k: float(v) for k, v in solver.train_step(layer.forward()).items()}
              for _ in range(2)]
    logged = [r for r in _log(runs["a"]) if "total_loss" in r][:2]
    for got, want in zip(losses, logged):
        assert got == {k: v for k, v in want.items() if k in got}
    # B's snapshot at step 2 holds the same parameters
    snap = load_params(osp.join(runs["b"], "default_iter_2.pth"))
    for name, value in solver.model.state_dict().items():
        assert torch.equal(value, snap[name]), name


def test_snapshot_files_and_pruning(runs, tmp_path):
    b = runs["b"]
    assert sorted(os.listdir(b)) == ["default_iter_2.pkl", "default_iter_2.pth",
                                     "default_iter_4.pkl", "default_iter_4.pth",
                                     "train_log.jsonl"]
    with open(osp.join(b, "default_iter_4.pkl"), "rb") as f:
        meta = pickle.load(f)
    assert meta["iter"] == 4 and meta["val_layer_state"] is None
    assert {"np_rng", "layer_state", "generator"} <= set(meta)
    assert set(torch.load(osp.join(b, "default_iter_4.pth"), weights_only=True)) == \
        {"model", "optimizer", "step"}

    cfg = _cfg("TRAIN.SNAPSHOT_KEPT", "2", "TRAIN.SNAPSHOT_PREFIX", "lin")
    model = torch.nn.Linear(3, 2)
    sw = SolverWrapper(model, runs["roidb"], cfg, device="cpu", output_dir=str(tmp_path))
    assert sw.find_previous() is None
    for step in (1, 10, 2, 9):
        sw.snapshot(step)
    assert sorted(os.listdir(tmp_path)) == ["lin_iter_10.pkl", "lin_iter_10.pth",
                                            "lin_iter_9.pkl", "lin_iter_9.pth"]
    assert sw.find_previous() == str(tmp_path / "lin_iter_10.pkl")
    saved = model.weight.detach().clone()
    with torch.no_grad():
        model.weight.add_(1.0)
    assert sw.from_snapshot(sw.find_previous()) == 10 and sw.step == 10
    assert torch.equal(model.weight, saved)


def test_load_params_reads_snapshots_and_params_files(runs, tmp_path):
    want = runs["sw_b"].model.state_dict()
    for path in (osp.join(runs["b"], "default_iter_4.pth"), str(tmp_path / "params.pth")):
        if not osp.exists(path):
            save_params(path, runs["sw_b"].model)
        got = load_params(path)
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)
    lin = torch.nn.Linear(3, 2)
    pretrained = {"weight": torch.ones(2, 3), "bias": torch.ones(5), "fc.weight": torch.ones(1)}
    merged = _merge_pretrained(lin.state_dict(), pretrained)
    assert torch.equal(merged["weight"], torch.ones(2, 3))          # name and shape match
    assert torch.equal(merged["bias"], lin.bias.detach())           # shape differs: kept
    assert "fc.weight" not in merged


@pytest.mark.parametrize("key", ["TRAIN.IMAGE_CACHE", "DEVICE.REMAT"])
def test_unported_options_raise(runs, key):
    """Both keys raised NotImplementedError while they were unported.  Now
    TRAIN.IMAGE_CACHE without an imdb raises a ValueError that names it (the
    cache lives at the imdb's level), and DEVICE.REMAT, which no module of
    the JAX package reads, is accepted (``tests/test_torch_host_drivers.py``
    holds a run with it bit-equal to one without)."""
    cfg = _cfg(key, "True")
    if key == "DEVICE.REMAT":
        solver = SolverWrapper(torch.nn.Linear(3, 2), runs["roidb"], cfg, device="cpu")
        assert solver.cfg.DEVICE.REMAT
        return
    with pytest.raises(ValueError, match="imdb"):
        SolverWrapper(torch.nn.Linear(3, 2), runs["roidb"], cfg, device="cpu")
