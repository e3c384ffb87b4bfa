"""The port's profiler spans (``frcnn_tpu_torch/utils/trace.py``), on the
CPU: which ``frcnn.*`` ranges a ``torch.profiler`` session records around
the graphed detect step (through the stand-in graph), a ``Detector``
request, and a tiny ``train_model`` run, and how they nest; with no
profiler, ``span`` is one shared null context and enters no range."""

import contextlib
import json
import os

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from frcnn_tpu_torch import cfg_from_list, default_config
from frcnn_tpu_torch.engine.graphs import DetectGraphs
from frcnn_tpu_torch.engine.serve import Detector
from frcnn_tpu_torch.engine.train import SolverWrapper
from frcnn_tpu_torch.utils import trace
from tests.test_torch_graphs import StandInGraph, ToyModel, _toy_batch

GRAPH_SPANS = ("frcnn.graphs.lookup", "frcnn.graphs.copy_in", "frcnn.graphs.replay")


def _spans(prof):
    return [e for e in prof.events() if e.name.startswith("frcnn.")]


def _ancestors(event):
    out, p = [], event.cpu_parent
    while p is not None:
        out.append(p.name)
        p = p.cpu_parent
    return out


def test_no_profiler_gives_the_one_shared_null_context(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    first, second = trace.span("frcnn.a"), trace.span("frcnn.b")
    assert first is second and isinstance(first, contextlib.nullcontext)
    with first:
        pass
    monkeypatch.undo()
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(trace.span("frcnn.a"), record_function)
    assert trace.span("frcnn.a") is first


def test_graphed_calls_record_lookup_copy_in_replay_and_one_capture():
    graphs = DetectGraphs(ToyModel(), 100, "cpu", graph=StandInGraph)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i, value in enumerate((1.0, 2.0, 3.0)):
            with record_function(f"caller{i}"):
                graphs(*_toy_batch(2, value))
    spans = _spans(prof)
    for i in range(3):
        mine = [e for e in spans if f"caller{i}" in _ancestors(e)]
        names = sorted(e.name for e in mine)
        assert sorted(n for n in names if n in GRAPH_SPANS) == sorted(GRAPH_SPANS)
        assert names.count("frcnn.graphs.capture") == (1 if i == 0 else 0)
    assert len(spans) == 3 * len(GRAPH_SPANS) + 1
    # the first call's copy into the static inputs is part of its capture
    first_copy = next(e for e in spans if e.name == "frcnn.graphs.copy_in")
    assert _ancestors(first_copy)[0] == "frcnn.graphs.capture"


def test_a_detector_request_records_a_prep_per_image_and_its_readback():
    cfg = cfg_from_list(default_config(), ["TEST.SCALES", "(128,)", "TEST.MAX_SIZE", "192",
                                           "DEVICE.BUCKETS", "((128, 192), (192, 128))"])
    det = Detector(ToyModel(), cfg, device="cpu")
    rng = np.random.RandomState(0)
    images = [rng.randint(0, 255, shape).astype(np.uint8)
              for shape in ((128, 192, 3), (192, 128, 3), (128, 192, 3))]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        results = det(images)
        det.detect_blobs(*_toy_batch(2, 1.0))
    assert len(results) == 3 and all(r.shape[1] == 6 for r in results)
    spans = _spans(prof)
    by_name = {}
    for e in spans:
        by_name.setdefault(e.name, []).append(e)
    assert {n: len(v) for n, v in by_name.items()} == {
        "frcnn.serve.call": 1, "frcnn.serve.prep": 3, "frcnn.serve.readback": 1,
        "frcnn.serve.detect_blobs": 1}
    for e in by_name["frcnn.serve.prep"] + by_name["frcnn.serve.readback"]:
        assert _ancestors(e)[0] == "frcnn.serve.call"


class ToyTrainModel(torch.nn.Module):
    """``train_forward`` of a toy: the four losses of the detector from one
    weight and the batch's mean."""

    def __init__(self, cfg):
        super().__init__()
        self.config = cfg
        self.weight = torch.nn.Parameter(torch.ones(()))

    def train_forward(self, data, im_info, gt_boxes, gt_labels, gt_valid, draws):
        x = data.float().mean() * self.weight
        losses = {k: x * (i + 1) for i, k in enumerate(
            ("rpn_cross_entropy", "rpn_loss_box", "cross_entropy", "loss_box"))}
        losses["total_loss"] = sum(losses.values())
        return losses, {}


def _solver(*extra):
    cfg = cfg_from_list(default_config(), ["TRAIN.SCALES", "(96,)", "TRAIN.MAX_SIZE", "128",
                                           "DEVICE.BUCKETS", "((96, 128),)",
                                           "TRAIN.DISPLAY", "1000", *extra])
    roidb = [{"image": str(i), "height": 96, "width": 128, "flipped": False,
              "boxes": np.array([[8, 8, 40, 50]], np.float32),
              "gt_classes": np.array([1], np.int32)} for i in range(4)]
    return SolverWrapper(ToyTrainModel(cfg), roidb, cfg, device="cpu",
                         reader=lambda path: np.full((96, 128, 3), int(path), np.uint8))


def test_train_model_records_each_steps_spans_and_the_data_layer_on_its_thread():
    solver = _solver()
    every_thread = torch.profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU], experimental_config=every_thread) as prof:
        history = solver.train_model(3)
    assert len(history) == 3
    spans = _spans(prof)
    counts = {}
    for e in spans:
        counts[e.name] = counts.get(e.name, 0) + 1
    assert counts == {"frcnn.train.data_wait": 3, "frcnn.train.step": 3,
                      "frcnn.train.loss_readback": 3, "frcnn.data.forward": 3}
    loop = {e.thread for e in spans if e.name.startswith("frcnn.train.")}
    data = {e.thread for e in spans if e.name == "frcnn.data.forward"}
    assert len(loop) == 1 and len(data) == 1 and loop != data


def test_the_profile_window_writes_the_train_spans(tmp_path):
    solver = _solver("DEVICE.PROFILE_DIR", str(tmp_path), "DEVICE.PROFILE_START", "1",
                     "DEVICE.PROFILE_STEPS", "1")
    solver.train_model(3)
    with open(os.path.join(tmp_path, "trace_iter_1.json")) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    for name in ("frcnn.train.data_wait", "frcnn.train.step", "frcnn.train.loss_readback"):
        assert names.count(name) == 1, name
