"""The check refuses a broken timed path.  At tiny sizes on the CPU, with the
port in float32 (where a sound run reads nought to rounding, and passes),
each fault a cell can have is planted underneath a whole run and
``correct`` must come out false under the cells' limits:

  * serving: half of each batch's answers left out; every answer altered
    where it is produced (boxes moved by 40 pixels); the answers of one
    batch slot altered, in requests of 8 images; the reference computed in
    float8 in the program's place (the control);
  * training: a step that leaves the weights unchanged; half of the batch
    left out, the losses the mean over the rest; the loss altered where it
    is produced (x1.5); the control.

One chip a cell: there is no exchange between chips to leave out."""

import contextlib
import time

import pytest
import torch

from benchmark.harness.check import judge
from benchmark.harness.main import make_runner, run_cell
from benchmark.tests.tiny import CELLS, limits, tiny_cell

SERVE = [c for c in CELLS if "serve" in c]
TRAIN = [c for c in CELLS if "train" in c]


def _f32_cell(name):
    cell = tiny_cell(name)
    cell.config["cfg"]["DEVICE.DTYPE"] = "float32"
    cell.limits = limits(name)
    return cell


def _models():
    from frcnn_tpu_torch.models.fpn import FasterRCNNFPN
    from frcnn_tpu_torch.models.network import FasterRCNN

    return FasterRCNN, FasterRCNNFPN


@contextlib.contextmanager
def planted(fault, monkeypatch):
    """Plant ``fault`` in the port's classes for the ``with`` block."""
    for cls in _models():
        if fault in ("half_batch", "moved_boxes", "one_slot"):
            inner = cls.detect

            def detect(self, images, im_info, max_per_image=None, _inner=inner):
                dets, valid = _inner(self, images, im_info, max_per_image)
                if fault == "half_batch":
                    valid = valid.clone()
                    valid[(valid.shape[0] + 1) // 2:] = False
                elif fault == "one_slot":
                    dets = dets.clone()
                    dets[-1, :, :4] += 40.0
                else:
                    dets = dets.clone()
                    dets[..., :4] += 40.0
                return dets, valid

            monkeypatch.setattr(cls, "detect", detect)
        if fault in ("half_train_batch", "altered_loss"):
            inner = cls.train_forward

            def train_forward(self, images, im_info, gt_boxes, gt_labels, gt_valid, draws,
                              _inner=inner):
                if fault == "half_train_batch":
                    h = (images.shape[0] + 1) // 2
                    return _inner(self, images[:h], im_info[:h], gt_boxes[:h], gt_labels[:h],
                                  gt_valid[:h], draws)
                losses, aux = _inner(self, images, im_info, gt_boxes, gt_labels, gt_valid,
                                     draws)
                return {**losses, "total_loss": losses["total_loss"] * 1.5}, aux

            monkeypatch.setattr(cls, "train_forward", train_forward)
    if fault == "unchanged_state":
        monkeypatch.setattr(torch.optim.SGD, "step", lambda self, closure=None: None)
    yield


def _run(cell, tmp_path):
    return run_cell(cell, 2**31 + 77, 0.3, False, "cpu", time.perf_counter(),
                    workdir=str(tmp_path), log=lambda m: None)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_passes(name, tmp_path):
    assert _run(_f32_cell(name), tmp_path)["correct"] is True


@pytest.mark.parametrize("name,fault",
                         [(c, f) for c in SERVE for f in ("half_batch", "moved_boxes")]
                         + [(c, f) for c in TRAIN
                            for f in ("unchanged_state", "half_train_batch", "altered_loss")])
def test_a_fault_fails_the_check(name, fault, tmp_path, monkeypatch):
    cell = _f32_cell(name)
    with planted(fault, monkeypatch):
        result = _run(cell, tmp_path)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("name", SERVE)
def test_one_wrong_slot_in_eight_fails_the_check(name, tmp_path, monkeypatch):
    """The last row of every batch answers wrong: one image in eight of a
    blob request, one a bucket of a raw one; the pooled ``box_gap`` hardly
    moves, the cell's per-image or per-part number reads it."""
    cell = _f32_cell(name)
    with planted("one_slot", monkeypatch):
        result = _run(cell, tmp_path)
    assert result["correct"] is False, result["checks"]
    held = [k for k in ("box_gap_worst", "box_gap_part") if k in result["checks"]]
    assert held and all(result["checks"][k]["value"] > result["checks"][k]["limit"]
                        for k in held), result["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_check(name, tmp_path):
    """The reference in float8 (the precision below the configuration's
    bfloat16) in the program's place, on the run's own requests or steps."""
    cell = tiny_cell(name)
    runner = make_runner(cell, 2**31 + 91, "cpu", str(tmp_path))
    runner.setup()
    recs = runner.window(0.0, count=2)
    correct, checks = judge(runner.readings(recs, quant="fp8"), limits(name))
    assert correct is False, checks
