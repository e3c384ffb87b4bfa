"""Boundaries of the PyTorch port, on the CPU: it imports no jax, its
config keeps the JAX package's keys and defaults, its kernel wrappers run
their plain twins (and count no launch) on CPU tensors, ``chip_smoke.py``
fails without a card, and the cv2-free resize stays within a stated bound
of ``cv2.resize``."""

import dataclasses
import os
import pkgutil
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
from frcnn_tpu_torch.ops.cuda.roi_align_kernel import roi_align_forward

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    mods = [m.name for m in pkgutil.walk_packages(frcnn_tpu_torch.__path__, "frcnn_tpu_torch.")]
    assert len(mods) >= 15
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'frcnn_tpu')]\n"
            "print(len(bad)); sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_fails_without_a_card():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


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
    cfg = cfg_from_list(default_config(), ["TPU.USE_PALLAS", "False", "TPU.MAX_GT", "32"])
    assert cfg.DEVICE.USE_KERNELS is False and cfg.DEVICE.MAX_GT == 32
    with pytest.raises(KeyError):
        cfg_from_list(default_config(), ["TPU.NO_SUCH_KEY", "1"])


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
