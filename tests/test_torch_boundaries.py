"""Boundaries of the PyTorch port, on the CPU: it imports no jax, its
config keeps the JAX package's keys and defaults, its kernel wrappers run
their plain twins (and count no launch) on CPU tensors, the ctypes
signatures match the CUDA and the host libraries' sources, the port reads
no file of the JAX package (its host libraries build from its own copies),
``chip_smoke.py`` (with or without
``--only kernels`` or ``--profile``) fails without a card, the entry points
(``Detector``, ``SolverWrapper``) raise without a card unless the caller asks
for the CPU, and the cv2-free resize stays within a stated bound of
``cv2.resize``."""

import dataclasses
import glob
import os
import pkgutil
import re
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

import frcnn_tpu_torch
from frcnn_tpu.config import default_config as jax_default_config
from frcnn_tpu.data.loader import prep_im_for_blob as jax_prep_im_for_blob
from frcnn_tpu_torch import cfg_from_file, cfg_from_list, default_config
from frcnn_tpu_torch.data.loader import prep_im_for_blob, resize_bilinear
from frcnn_tpu_torch.ops.cuda import build
from frcnn_tpu_torch.ops.cuda.fused_block import fused_bottleneck
from frcnn_tpu_torch.ops.cuda.nms_kernel import nms_mask_batched
from frcnn_tpu_torch.ops.cuda.overlap_kernel import anchor_overlap_stats
from frcnn_tpu_torch.ops.cuda.roi_align_kernel import roi_align_backward, roi_align_forward
from frcnn_tpu_torch.ops.cuda.select_kernel import topk_threshold

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    mods = [m.name for m in pkgutil.walk_packages(frcnn_tpu_torch.__path__, "frcnn_tpu_torch.")]
    assert len(mods) >= 15
    assert {"frcnn_tpu_torch.data.cache", "frcnn_tpu_torch.native.build",
            "frcnn_tpu_torch.native.host_ops", "frcnn_tpu_torch.native.data_prep",
            "frcnn_tpu_torch.tools.reval", "frcnn_tpu_torch.tools.demo"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'frcnn_tpu')]\n"
            "print(len(bad)); sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_reads_no_file_under_the_jax_package(tmp_path):
    """Importing every module of the port, building its two host libraries
    (into a fresh directory) and running them, and building an image cache,
    open no file under ``frcnn_tpu/`` and pass none to a subprocess: the
    builds compile ``frcnn_tpu_torch/native/*.cc`` (audit events ``open``,
    ``subprocess.Popen`` and ``ctypes.dlopen``)."""
    code = f"""
import importlib, json, os, pkgutil, sys
seen = []
def hook(event, args):
    if event == "open" and isinstance(args[0], (str, bytes)):
        seen.append(os.fsdecode(args[0]))
    elif event == "subprocess.Popen":
        seen.extend(os.fsdecode(a) for a in args[1])
    elif event == "ctypes.dlopen" and args[0]:
        seen.append(os.fsdecode(args[0]))
sys.addaudithook(hook)
import numpy as np
import frcnn_tpu_torch
for m in pkgutil.walk_packages(frcnn_tpu_torch.__path__, "frcnn_tpu_torch."):
    importlib.import_module(m.name)
from frcnn_tpu_torch.data.cache import ResizedImageCache
from frcnn_tpu_torch.native import build, data_prep, host_ops
build.BUILD_DIR = {str(tmp_path / "_build")!r}
dets = np.array([[0, 0, 10, 10, 0.9], [1, 1, 10, 10, 0.8]], np.float32)
assert list(host_ops.nms_cpu(dets, 0.5)) == [0]
assert host_ops.bbox_overlaps_cpu(dets[:, :4], dets[:, :4]).shape == (2, 2)
built = data_prep.have_native()
image = {str(tmp_path / "image.jpg")!r}
open(image, "wb").close()
ResizedImageCache.build([image], {str(tmp_path / "cache")!r}, (8,), 16, ((8, 16),),
                        reader=lambda p: np.zeros((4, 8, 3), np.uint8), verbose=False)
print(json.dumps({{"seen": seen, "data_prep": built}}))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    import json

    out = json.loads(proc.stdout.strip().splitlines()[-1])
    jax_dir = os.path.join(ROOT, "frcnn_tpu") + os.sep
    bad = [p for p in out["seen"] if os.path.abspath(os.path.join(ROOT, p)).startswith(jax_dir)]
    assert not bad
    sources = sorted({os.path.relpath(p, ROOT) for p in out["seen"] if p.endswith(".cc")})
    want = ["frcnn_tpu_torch/native/host_ops.cc"]
    if out["data_prep"]:
        want = ["frcnn_tpu_torch/native/data_prep.cc", *want]
    assert sources == want
    assert sum(p.startswith(str(tmp_path / "_build")) and p.endswith(".so")
               for p in out["seen"]) >= len(want)        # loaded from the fresh directory


def test_native_ctypes_signatures_match_sources():
    """The host libraries' extern "C" functions and their ctypes
    signatures: the same names and the same parameter counts."""
    from frcnn_tpu_torch.native import build as native_build
    from frcnn_tpu_torch.native import data_prep, host_ops

    for mod, name in ((host_ops, "host_ops.cc"), (data_prep, "data_prep.cc")):
        with open(os.path.join(native_build.NATIVE, name)) as f:
            text = f.read()
        text = text[text.index('extern "C" {'):]
        declared = {fn: len(params.split(",")) for fn, params in
                    re.findall(r"^(?:int|void) (frcnn_\w+)\(([^)]*)\)", text, re.M)}
        assert declared and set(declared) == set(mod._SIGNATURES), name
        for fn, count in declared.items():
            assert len(mod._SIGNATURES[fn][1]) == count, fn


@pytest.mark.parametrize("args", [[], ["--only", "kernels"], ["--profile"]])
def test_chip_smoke_fails_without_a_card(args):
    proc = subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no CUDA device" in proc.stderr          # the arguments parsed


def test_chip_smoke_rejects_unknown_only():
    proc = subprocess.run([sys.executable, "chip_smoke.py", "--only", "train"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2 and "invalid choice" in proc.stderr


def test_chip_smoke_roi_bound_counts_the_pixels_under_the_rois():
    """The RoIAlign bounds of ``chip_smoke.py`` read a level map's pixel only
    where some roi on that level samples it with weight: the same set that
    gets a gradient through the forward twin."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from frcnn_tpu_torch.ops.cuda.roi_align_kernel import roi_align_multilevel_reference

    rng = np.random.RandomState(0)
    hws, strides, c = [(32, 50), (16, 25), (8, 13), (4, 7)], (4, 8, 16, 32), 3
    rois = chip_smoke.random_boxes(rng, 2, 9, size=200.0)
    rois[:, 0] = rng.uniform(-300, 500, (2, 4))           # partly / wholly outside
    rois[:, 1] = 0.0                                       # a padding roi
    rois[:, 2, 2:] = rois[:, 2, :2]                        # zero size
    rois = torch.from_numpy(rois)
    levels = torch.from_numpy(rng.randint(0, 4, (2, 9)).astype(np.int32))
    levels[0, 3] = 7                                       # out of range: reads nothing
    feats = [torch.randn(2, h, w, c, dtype=torch.float64).requires_grad_(True) for h, w in hws]
    out = roi_align_multilevel_reference(feats, rois, levels, strides)
    (out * torch.rand_like(out).add(0.5)).sum().backward()
    want = sum(int((f.grad.abs().sum(-1) > 0).sum()) for f in feats)
    got = chip_smoke.roi_read_bytes(rois, levels, hws, [1.0 / s for s in strides], c, 2)
    assert 0 < want < sum(2 * h * w for h, w in hws) and got == want * c * 2


@pytest.mark.parametrize("net", ["res50", "res50_fpn", "vgg16", "mobile"])
def test_entry_points_default_to_the_card(net):
    """``Detector(model)`` and ``SolverWrapper(model, roidb)`` run on cuda:0
    unless told otherwise: with no card they raise instead of quietly serving
    or training on the CPU; ``device="cpu"`` is the explicit request."""
    from frcnn_tpu_torch.engine.serve import Detector
    from frcnn_tpu_torch.engine.train import SolverWrapper
    from frcnn_tpu_torch.models.network import build_model

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    cfg = cfg_from_list(default_config(), [
        "TEST.SCALES", "(64,)", "TEST.MAX_SIZE", "96", "TRAIN.SCALES", "(64,)",
        "TRAIN.MAX_SIZE", "96", "DEVICE.BUCKETS", "((64, 96),)", "TRAIN.IMS_PER_BATCH", "1",
        "TEST.RPN_POST_NMS_TOP_N", "16", "TRAIN.RPN_POST_NMS_TOP_N", "16",
        "TRAIN.BATCH_SIZE", "8", "TRAIN.RPN_BATCHSIZE", "16", "DEVICE.MAX_GT", "4",
        "ANCHOR_SCALES", "(1, 2)", "TEST.SCORE_THRESH", "0.0"])
    model = build_model(net, 5, cfg)
    im = np.random.RandomState(0).randint(0, 255, (64, 96, 3)).astype(np.uint8)
    roidb = [{"image": "im", "boxes": np.array([[8.0, 8.0, 60.0, 50.0]], np.float32),
              "gt_classes": np.array([2], np.int32), "flipped": False, "height": 64,
              "width": 96, "max_overlaps": np.ones(1, np.float32)}]
    with pytest.raises(RuntimeError, match="cuda:0"):
        Detector(model)
    with pytest.raises(RuntimeError, match="cuda:0"):
        SolverWrapper(model, roidb, cfg, reader=lambda name: im)
    det = Detector(model.eval(), device="cpu")
    assert det.device == torch.device("cpu") and det([im])[0].shape[1] == 6
    solver = SolverWrapper(model, roidb, cfg, reader=lambda name: im, device=torch.device("cpu"))
    losses = solver.train_step(solver.data_layer.forward())
    assert solver.device.type == "cpu" and np.isfinite(float(losses["total_loss"]))


def test_ctypes_signatures_match_sources():
    """Every extern "C" launcher's parameter count (the stream included)
    equals its ctypes signature: a missing pointer argument is passed as a
    32-bit int and crashes the process on the card."""
    declared = {}
    for src in glob.glob(os.path.join(build.CSRC, "*.cu")):
        with open(src) as f:
            text = f.read()
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
            declared[name] = len(params.split(","))
    assert set(declared) == set(build._SIGNATURES)
    for name, params in declared.items():
        assert len(build._SIGNATURES[name]) == params, name


def test_config_keys_and_defaults_match_jax():
    ours = dataclasses.asdict(default_config())
    theirs = dataclasses.asdict(jax_default_config())
    device = theirs.pop("TPU")
    device["USE_KERNELS"] = device.pop("USE_PALLAS")
    theirs["DEVICE"] = device
    assert ours == theirs
    # JAX-package key names still load: YAML TPU blocks and --set TPU.* pairs
    cfg = cfg_from_file(default_config(), os.path.join(ROOT, "experiments/cfgs/res101-lg.yml"))
    assert cfg.DEVICE.BUCKETS == ((800, 1344),) and cfg.TEST.SCALES == (800,)
    cfg = cfg_from_file(default_config(), os.path.join(ROOT, "experiments/cfgs/res101-fpn.yml"))
    assert cfg.TRAIN.IMS_PER_BATCH == 2 and cfg.DEVICE.BUCKETS == ((800, 1344),)
    cfg = cfg_from_list(default_config(), ["TPU.USE_PALLAS", "True", "TPU.MAX_GT", "32"])
    assert cfg.DEVICE.USE_KERNELS is True and cfg.DEVICE.MAX_GT == 32
    with pytest.raises(KeyError):
        cfg_from_list(default_config(), ["TPU.NO_SUCH_KEY", "1"])


@pytest.mark.parametrize("key", ["DEVICE.USE_KERNELS", "DEVICE.THRESHOLD_SELECT",
                                 "DEVICE.FUSED_RESNET_BLOCKS", "TPU.USE_PALLAS"])
def test_a_false_kernel_switch_is_refused(key, tmp_path):
    """The port has one path: each JAX switch of it loads as True and is
    refused, naming its key, as False, from --set pairs, from a YAML file
    and from the dataclass itself."""
    assert cfg_from_list(default_config(), [key, "True"]) == default_config()
    name = key.replace("TPU.USE_PALLAS", "DEVICE.USE_KERNELS").split(".")[1]
    with pytest.raises(ValueError, match=f"DEVICE.{name} .*only True is accepted"):
        cfg_from_list(default_config(), [key, "False"])
    section, field = key.split(".")
    path = tmp_path / "switch.yml"
    path.write_text(f"{section}:\n  {field}: False\n")
    with pytest.raises(ValueError, match=f"DEVICE.{name} "):
        cfg_from_file(default_config(), str(path))
    with pytest.raises(ValueError, match=f"DEVICE.{name} "):
        dataclasses.replace(default_config().DEVICE, **{name: False})


def test_wrappers_on_cpu_run_twins_and_count_nothing(rng):
    build.reset_launch_counts()
    boxes = torch.from_numpy(np.sort(rng.uniform(0, 100, (2, 70, 4)), axis=-1).astype(np.float32))
    keep = nms_mask_batched(boxes, 0.5, max_keep=3)
    assert keep.dtype == torch.bool and keep.shape == (2, 70)
    feat = torch.randn(1, 6, 8, 4)
    assert roi_align_forward(feat, torch.tensor([[[0.0, 0.0, 60.0, 40.0]]])).shape == (1, 1, 7, 7, 4)
    x = torch.randn(1, 5, 7, 16)
    w = [torch.randn(16, 4), torch.randn(4), torch.randn(36, 4), torch.randn(4),
         torch.randn(4, 16), torch.randn(16)]
    assert fused_bottleneck(x, *w).shape == (1, 5, 7, 16)
    assert roi_align_backward(torch.randn(1, 1, 7, 7, 4), torch.tensor([[[0.0, 0.0, 60.0, 40.0]]]),
                              (6, 8)).shape == (1, 6, 8, 4)
    stats = anchor_overlap_stats(boxes[0], boxes[:, :3], torch.ones(2, 3, dtype=torch.bool),
                                 torch.ones(2, 70, dtype=torch.bool))
    assert [t.shape for t in stats] == [(2, 70)] * 3
    vals, idx = topk_threshold(torch.randn(2, 50), 7)
    assert vals.shape == idx.shape == (2, 7) and idx.dtype == torch.int32
    assert sum(build.LAUNCH_COUNTS.values()) == 0
    with pytest.raises(ValueError):
        build.check_cuda("x", x)  # the kernels take CUDA tensors only


def test_resize_within_bound_of_cv2(rng):
    """f32: within 0.02 of cv2's f32 resize (pixel range 0..255); uint8:
    within 1 LSB of the JAX package's cv2 uint8 path."""
    buckets = ((800, 1216), (1216, 800))
    for h, w in ((600, 912), (375, 500), (480, 640), (1000, 700), (333, 517)):
        im = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        scale = 800.0 / min(h, w)
        ours = resize_bilinear(im, scale)
        theirs = cv2.resize(im.astype(np.float32), None, None, fx=scale, fy=scale,
                            interpolation=cv2.INTER_LINEAR)
        assert ours.shape == theirs.shape
        assert np.abs(ours - theirs).max() <= 0.02
        for keep_uint8 in (False, True):
            a, sa = prep_im_for_blob(im, 800, 1333, buckets, keep_uint8=keep_uint8)
            b, sb = jax_prep_im_for_blob(im, 800, 1333, buckets, keep_uint8=keep_uint8)
            assert sa == sb and a.shape == b.shape and a.dtype == b.dtype
            assert np.abs(a.astype(np.float32) - b.astype(np.float32)).max() <= (
                1.0 if keep_uint8 else 0.02)
