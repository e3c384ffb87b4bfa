"""The port's native host libraries (``frcnn_tpu_torch/native``) against the
JAX package's, on the CPU:

  * ``nms_cpu``: the kept indices equal JAX's ``nms_cpu`` and the port's
    numpy fallback, on crowded boxes, on runs of tied scores, at N = 0 and 1;
  * ``bbox_overlaps_cpu`` within 1e-6 of JAX's (and of the fallback);
  * ``engine.test.apply_nms`` (over ``nms_cpu``) keeps JAX's rows exactly;
  * ``data_prep.prep_batch`` bit-equal to JAX's (the same source on the same
    system OpenCV), and an ``IOError`` naming an image that does not decode;
  * ``get_minibatch``'s native route (no reader, TRAIN.NATIVE_PREP, stored
    sizes) within rtol 1e-4, atol 0.05 of its Python route (cv2's decode,
    the port's numpy resize), flipped entries and mixed buckets included;
    ``im_info`` and the gt exact;
  * the builds: a library's name carries the hash of its source and flags
    (an edited source builds a new library), and without ``g++`` each
    binding falls back with one loud line on stderr.

Every test needs ``g++``; the ``data_prep`` ones also ``pkg-config opencv4``
(they skip only where that is missing).
"""

import os
import shutil
import subprocess

import numpy as np
import pytest

from frcnn_tpu.engine import test as jax_test
from frcnn_tpu.native import data_prep as jax_data_prep
from frcnn_tpu.native import host_ops as jax_host_ops
from frcnn_tpu_torch import cfg_from_list, default_config
from frcnn_tpu_torch.data.loader import RoIDataLayer
from frcnn_tpu_torch.data.pascal_voc import pascal_voc
from frcnn_tpu_torch.data.roidb import prepare_roidb
from frcnn_tpu_torch.engine import test as port_test
from frcnn_tpu_torch.native import build, data_prep, host_ops

HAVE_OPENCV = shutil.which("pkg-config") is not None and subprocess.run(
    ["pkg-config", "--exists", "opencv4"]).returncode == 0
needs_opencv = pytest.mark.skipif(not HAVE_OPENCV, reason="no opencv4 dev files (pkg-config)")


def _dets(rng, n, ties):
    """(n, 5) boxes crowded enough that some suppress each other; with
    ``ties`` the scores take 3 values."""
    xy = rng.uniform(0, 60, (n, 2))
    wh = rng.uniform(10, 80, (n, 2))
    scores = rng.randint(0, 3, n) / 3.0 + 0.1 if ties else rng.uniform(0, 1, n)
    return np.concatenate([xy, xy + wh, scores[:, None]], 1).astype(np.float32)


@pytest.mark.parametrize("n, thresh, ties", [(0, 0.5, False), (1, 0.5, False), (60, 0.3, False),
                                             (60, 0.7, False), (200, 0.5, True),
                                             (40, 0.0, True)])
def test_nms_cpu_equals_jax_and_the_fallback(n, thresh, ties):
    assert host_ops.have_native()
    dets = _dets(np.random.RandomState(n), n, ties)
    keep = host_ops.nms_cpu(dets, thresh)
    assert keep.dtype == np.int64
    np.testing.assert_array_equal(keep, jax_host_ops.nms_cpu(dets, thresh))
    np.testing.assert_array_equal(keep, host_ops.nms_numpy(dets, thresh))
    if n > 1:
        assert 0 < len(keep) < n or thresh == 0.0


def test_bbox_overlaps_cpu_within_1e6_of_jax():
    rng = np.random.RandomState(4)
    boxes, query = _dets(rng, 70, False)[:, :4], _dets(rng, 9, False)[:, :4]
    query[0] = boxes[3]                                   # an IoU of exactly 1
    query[1] = [500, 500, 510, 510]                       # no overlap
    got = host_ops.bbox_overlaps_cpu(boxes, query)
    want = jax_host_ops.bbox_overlaps_cpu(boxes, query)
    assert got.shape == (70, 9) and got.dtype == np.float32 and got[3, 0] == 1.0
    assert np.abs(got - want).max() <= 1e-6 and not got[:, 1].any()
    assert np.abs(host_ops.bbox_overlaps_numpy(boxes, query) - want).max() <= 1e-6


def test_apply_nms_equals_jax_with_ties():
    rng = np.random.RandomState(13)
    all_boxes = [[np.zeros((0, 5), np.float32) for _ in range(3)] for _ in range(3)]
    for cls in (1, 2):
        for im in range(3):
            all_boxes[cls][im] = _dets(rng, rng.randint(1, 40), ties=cls == 2)
    for thresh in (0.3, 0.7):
        ours, theirs = port_test.apply_nms(all_boxes, thresh), jax_test.apply_nms(all_boxes, thresh)
        for cls in range(3):
            for im in range(3):
                np.testing.assert_array_equal(ours[cls][im], theirs[cls][im])


@pytest.fixture(scope="module")
def roidb(voc_root, tmp_path_factory):
    root, _ = voc_root
    ds = pascal_voc("trainval", "2007", devkit_path=os.path.join(root, "VOCdevkit2007"),
                    data_dir=str(tmp_path_factory.mktemp("native_roidb")))
    prepare_roidb(ds)
    ds.append_flipped_images()
    return ds.roidb


@needs_opencv
def test_prep_batch_bit_equal_to_jax(roidb):
    assert data_prep.have_native()
    paths = [e["image"] for e in roidb[:4]] + [roidb[7]["image"]]
    flips, scales = [0, 1, 0, 1, 1], [0.5, 0.75, 1.0, 0.8333333, 0.625]
    ours = data_prep.prep_batch(paths, flips, scales, (320, 448), n_threads=2)
    theirs = jax_data_prep.prep_batch(paths, flips, scales, (320, 448), n_threads=2)
    assert ours[0].dtype == np.float32 and ours[0].shape == (5, 320, 448, 3)
    np.testing.assert_array_equal(ours[0], theirs[0])
    np.testing.assert_array_equal(ours[1], theirs[1])
    with pytest.raises(IOError, match="no_such_image.jpg"):
        data_prep.prep_batch([paths[0], "/nonexistent/no_such_image.jpg"], [0, 0], [1.0, 1.0],
                             (320, 448))


@needs_opencv
def test_native_route_of_get_minibatch_within_bound_of_the_python_route(roidb, monkeypatch):
    calls = []
    prep = data_prep.prep_batch
    monkeypatch.setattr(data_prep, "prep_batch", lambda *a, **k: calls.append(1) or prep(*a, **k))
    overrides = ["TPU.BUCKETS", "((256, 320), (320, 448))", "TRAIN.SCALES", "(200,)",
                 "TRAIN.MAX_SIZE", "400", "TRAIN.IMS_PER_BATCH", "2"]
    native = RoIDataLayer(roidb, cfg_from_list(default_config(), overrides))
    python = RoIDataLayer(roidb, cfg_from_list(default_config(),
                                               overrides + ["TRAIN.NATIVE_PREP", "False"]))
    assert any(roidb[i]["flipped"] for i in native._perm[:8])
    for _ in range(4):
        a, b = native.forward(), python.forward()
        assert a["data"].dtype == b["data"].dtype == np.float32
        assert a["data"].shape == b["data"].shape
        np.testing.assert_allclose(a["data"], b["data"], rtol=1e-4, atol=0.05)
        for key in ("im_info", "gt_boxes", "gt_labels", "gt_valid"):
            np.testing.assert_array_equal(a[key], b[key])
    assert len(calls) == 4                                 # the native route ran every batch


def test_library_names_carry_the_hash_of_source_and_flags(tmp_path, monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    shutil.copy(os.path.join(build.NATIVE, "host_ops.cc"), src)
    monkeypatch.setattr(build, "NATIVE", str(src))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    first = build.build_library("host_ops")
    assert build.build_library("host_ops") == first                  # reused, not rebuilt
    flagged = build.build_library("host_ops", ["-DNDEBUG"])
    assert flagged != first                                           # other flags
    with open(src / "host_ops.cc", "a") as f:
        f.write("\n// edited\n")
    edited = build.build_library("host_ops")
    assert edited != first and os.path.dirname(edited) == str(tmp_path / "_build")
    assert set(os.listdir(tmp_path / "_build")) == {os.path.basename(p)
                                                    for p in (first, flagged, edited)}


def test_without_gxx_the_bindings_fall_back_loudly(monkeypatch, capsys):
    def no_compiler(*args, **kwargs):
        raise FileNotFoundError("g++")

    for mod in (host_ops, data_prep):
        monkeypatch.setattr(mod, "build_library", no_compiler)
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_tried", False)
    dets = _dets(np.random.RandomState(2), 50, True)
    keep = host_ops.nms_cpu(dets, 0.5)
    assert not host_ops.have_native() and data_prep.prep_batch(["x"], [0], [1.0], (8, 8)) is None
    assert not data_prep.have_native()
    np.testing.assert_array_equal(keep, jax_host_ops.nms_cpu(dets, 0.5))
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 2                                   # one line each, once
    assert "host_ops" in err[0] and "numpy fallback" in err[0]
    assert "data_prep" in err[1] and "Python route" in err[1]
