"""The port's host drivers on the CPU: TRAIN.IMAGE_CACHE and DEVICE.REMAT in
training, the stored-size route of ``test_net``, ``serve.throughput`` and
the ``reval`` and ``demo`` CLIs, with MobileNet at DEPTH_MULTIPLIER 0.25
(seeded ``init_random_`` weights) at a 128x192 bucket:

  * DEVICE.REMAT, a key no module of the JAX package reads, is accepted and
    changes nothing: two steps with it equal two without, bit for bit;
  * ``train_net`` with TRAIN.IMAGE_CACHE over the ``voc_root`` devkit: the
    cache lands at the dataset level (``<cache_path>/<imdb>_resized``, as
    ``tests/test_engine.py::test_train_with_image_cache``), its entries
    within 1 LSB of a JAX-built cache of the same images with the same
    scales, the batches are uint8, the losses finite, a second run reuses
    the cache (no image read), and a run stopped at a snapshot and resumed
    equals the straight cached run bit for bit;
  * ``test_net``'s stored-size route (no reader, sizes in the roidb, the
    native prep) gives the reader route's detections and APs exactly, over
    a devkit whose images need no resize (PNG data, so both decoders agree);
  * ``throughput`` on the CPU: warmup + iters calls of ``detect_blobs`` on
    a device-resident synthetic batch, images/s > 0;
  * ``reval``: the mAP of ``test_net``'s detections.pkl, and with ``--nms``
    the APs of JAX's ``apply_nms`` + evaluation (within 1e-6);
  * ``demo``: PNGs of the input sizes, per-class rows equal to JAX's
    ``nms_cpu`` over ``im_detect``'s rows.
"""

import os
import os.path as osp
import pickle
import shutil
import subprocess

import numpy as np
import pytest
import torch

from frcnn_tpu.data import cache as jax_cache
from frcnn_tpu.data.pascal_voc import pascal_voc as JaxVoc
from frcnn_tpu.engine import test as jax_test
from frcnn_tpu.native import host_ops as jax_host_ops
from frcnn_tpu_torch import cfg_from_list, default_config
from frcnn_tpu_torch.data import loader
from frcnn_tpu_torch.data.pascal_voc import VOC_CLASSES, pascal_voc
from frcnn_tpu_torch.data.roidb import prepare_roidb
from frcnn_tpu_torch.engine import serve
from frcnn_tpu_torch.engine.checkpoint import save_params
from frcnn_tpu_torch.engine.test import im_detect
from frcnn_tpu_torch.engine.test import test_net as port_test_net
from frcnn_tpu_torch.engine.train import SolverWrapper, filter_roidb, get_training_roidb, train_net
from frcnn_tpu_torch.models.network import build_model, init_random_
from frcnn_tpu_torch.native import data_prep
from frcnn_tpu_torch.tools import demo, reval

BUCKET = ["TPU.BUCKETS", "((128, 192),)", "MOBILENET.DEPTH_MULTIPLIER", "0.25"]
TRAIN = BUCKET + ["TRAIN.SCALES", "(128,)", "TRAIN.MAX_SIZE", "192", "TRAIN.IMS_PER_BATCH", "2",
                  "TRAIN.RPN_PRE_NMS_TOP_N", "400", "TRAIN.RPN_POST_NMS_TOP_N", "64",
                  "TRAIN.BATCH_SIZE", "32", "TRAIN.RPN_BATCHSIZE", "64", "TPU.MAX_GT", "8",
                  "ANCHOR_SCALES", "(2, 4, 8)", "TRAIN.DISPLAY", "1", "TRAIN.SUMMARY_INTERVAL", "0",
                  "TRAIN.LEARNING_RATE", "0.01", "TRAIN.SNAPSHOT_KEPT", "3"]
SERVE = BUCKET + ["TEST.SCALES", "(128,)", "TEST.MAX_SIZE", "192", "TEST.RPN_PRE_NMS_TOP_N", "400",
                  "TEST.RPN_POST_NMS_TOP_N", "32", "TEST.SCORE_THRESH", "0.0",
                  "ANCHOR_SCALES", "(2, 4, 8)"]
HAVE_OPENCV = shutil.which("pkg-config") is not None and subprocess.run(
    ["pkg-config", "--exists", "opencv4"]).returncode == 0


def _model(cfg, seed=0):
    model = build_model("mobile", 21, cfg)
    init_random_(model, torch.Generator().manual_seed(seed))
    return model


def _voc(voc_root, data_dir):
    root, _ = voc_root
    return pascal_voc("trainval", "2007", devkit_path=osp.join(root, "VOCdevkit2007"),
                      data_dir=str(data_dir))


def _state(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def test_remat_is_accepted_and_changes_nothing(voc_root, tmp_path):
    runs = []
    for remat in ("False", "True"):
        cfg = cfg_from_list(default_config(), TRAIN + ["DEVICE.REMAT", remat])
        ds = _voc(voc_root, tmp_path / remat)
        roidb = filter_roidb(get_training_roidb(ds, cfg), cfg)
        solver = SolverWrapper(_model(cfg), roidb, cfg, device="cpu")
        losses = [solver.train_step(solver.data_layer.forward()) for _ in range(2)]
        runs.append((losses, _state(solver.model)))
    (losses, state), (remat_losses, remat_state) = runs
    for a, b in zip(losses, remat_losses):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(state[k], remat_state[k]) for k in state)


def test_train_net_with_image_cache(voc_root, tmp_path):
    cfg = cfg_from_list(default_config(), TRAIN + ["TRAIN.IMAGE_CACHE", "True"])
    ds = _voc(voc_root, tmp_path / "data")
    roidb = filter_roidb(get_training_roidb(ds, cfg), cfg)
    paths = list(dict.fromkeys(e["image"] for e in roidb))
    reads = []

    def reader(path):
        reads.append(path)
        return loader.read_image(path)

    def run(out, iters, snapshot_iters):
        run_cfg = cfg_from_list(cfg, ["TRAIN.SNAPSHOT_ITERS", str(snapshot_iters)])
        return train_net(_model(run_cfg), ds, roidb, None, str(tmp_path / out), cfg=run_cfg,
                         max_iters=iters, reader=reader, device="cpu")

    straight = run("a", 4, 100)
    prefix = osp.join(ds.cache_path, f"{ds.name}_resized")
    assert osp.exists(prefix + ".dat") and osp.exists(prefix + ".idx")
    assert prefix.startswith(str(tmp_path / "data" / "cache"))      # the dataset's level
    assert sorted(reads) == sorted(paths)                           # each image read once
    assert straight.data_layer.forward()["data"].dtype == np.uint8
    with open(tmp_path / "a" / "train_log.jsonl") as f:
        logged = [eval(line.replace("true", "True")) for line in f]
    assert [r["iter"] for r in logged] == [1, 2, 3, 4]
    assert all(np.isfinite(r["total_loss"]) for r in logged)

    run("b", 2, 2)                                   # stops at its snapshot at 2
    resumed = run("b", 4, 2)                         # resumes at 2
    assert sorted(reads) == sorted(paths)            # both reused the cache: no read
    want, got = straight.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(want[k], got[k]) for k in want)
    with open(tmp_path / "b" / "train_log.jsonl") as f:
        resumed_log = [eval(line.replace("true", "True")) for line in f]
    assert [r["total_loss"] for r in resumed_log] == [r["total_loss"] for r in logged]

    theirs = jax_cache.ResizedImageCache.build(paths, str(tmp_path / "jax"), targets=(128,),
                                               max_size=192, buckets=cfg.DEVICE.BUCKETS,
                                               verbose=False)
    ours = straight.data_layer._reader
    for p in paths:
        a, sa = ours.get(p, 128, 192, cfg.DEVICE.BUCKETS)
        b, sb = theirs.get(p, 128, 192, cfg.DEVICE.BUCKETS)
        assert sa == sb and a.shape == b.shape
        assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= 1


@pytest.fixture(scope="module")
def devkit(tmp_path_factory):
    """VOCdevkit2007 whose test split has three images with a short side of
    128 that fit the 128x192 bucket (nothing resizes), stored as PNG data."""
    import cv2

    root = tmp_path_factory.mktemp("host_drivers_voc")
    d = root / "VOCdevkit2007" / "VOC2007"
    for sub in ("Annotations", "ImageSets/Main", "JPEGImages"):
        (d / sub).mkdir(parents=True)
    rng = np.random.RandomState(5)
    names = []
    for i, (h, w) in enumerate(((128, 192), (128, 160), (128, 176))):
        base = rng.randint(0, 255, (h // 16 + 1, w // 16 + 1, 3)).astype(np.uint8)
        im = cv2.resize(base, (w, h), interpolation=cv2.INTER_LINEAR)
        objs = []
        for _ in range(3):
            x1, y1 = rng.randint(0, w - 70), rng.randint(0, 40)
            x2, y2 = x1 + rng.randint(40, 70), rng.randint(90, h)
            im[y1:y2, x1:x2] = rng.randint(0, 255, 3)
            objs.append(f"<object><name>{VOC_CLASSES[rng.randint(1, 5)]}</name><difficult>0"
                        f"</difficult><bndbox><xmin>{x1 + 1}</xmin><ymin>{y1 + 1}</ymin>"
                        f"<xmax>{x2 + 1}</xmax><ymax>{y2 + 1}</ymax></bndbox></object>")
        name = f"{i:06d}"
        names.append(name)
        cv2.imencode(".png", im)[1].tofile(str(d / "JPEGImages" / f"{name}.jpg"))
        (d / "Annotations" / f"{name}.xml").write_text(
            f"<annotation><size><width>{w}</width><height>{h}</height></size>"
            + "".join(objs) + "</annotation>")
    (d / "ImageSets" / "Main" / "test.txt").write_text("\n".join(names) + "\n")
    return root


@pytest.fixture(scope="module")
def evaluated(devkit, tmp_path_factory):
    """``test_net`` over the test split by the stored-size route and by the
    reader route: {route: (output dir, results, detections)}."""
    cfg = cfg_from_list(default_config(), SERVE)
    model = _model(cfg, seed=1).eval()
    out = tmp_path_factory.mktemp("host_drivers_eval")
    imdb = pascal_voc("test", "2007", data_dir=str(devkit))
    prepare_roidb(imdb)                                  # the entries carry their sizes
    calls = []
    prep = data_prep.prep_batch

    def counted(*args, **kwargs):
        calls.append(len(args[0]))
        return prep(*args, **kwargs)

    data_prep.prep_batch = counted
    try:
        runs = {}
        for route, reader in (("stored", None), ("reader", loader.read_image)):
            results = port_test_net(model, imdb, cfg, str(out / route), batch=2, reader=reader,
                                    device="cpu")
            with open(out / route / "detections.pkl", "rb") as f:
                runs[route] = (str(out / route), results, pickle.load(f))
    finally:
        data_prep.prep_batch = prep
    runs["prep_calls"] = calls
    return runs


@pytest.mark.skipif(not HAVE_OPENCV, reason="no opencv4 dev files (pkg-config)")
def test_stored_size_route_of_test_net_equals_the_reader_route(evaluated):
    assert evaluated["prep_calls"] == [2, 1]             # two native batches, then none
    _, results, dets = evaluated["stored"]
    _, want_results, want = evaluated["reader"]
    assert results == want_results and 0.0 <= results["mAP"] <= 1.0
    total = 0
    for cls in range(21):
        for im in range(3):
            np.testing.assert_array_equal(dets[cls][im], want[cls][im])
            total += len(dets[cls][im])
    assert total > 10


def test_throughput_on_the_cpu():
    cfg = cfg_from_list(default_config(), SERVE)
    detector = serve.Detector(_model(cfg).eval(), device="cpu")
    seen = []
    detect_blobs = detector.detect_blobs

    def counted(data, im_info):
        seen.append((tuple(data.shape), data.dtype, data.device.type))
        return detect_blobs(data, im_info)

    detector.detect_blobs = counted
    rate = serve.throughput(detector, 2, iters=2, warmup=1)
    assert np.isfinite(rate) and rate > 0
    assert seen == [((2, 128, 192, 3), torch.float32, "cpu")] * 3


def test_reval_gives_test_nets_map_and_jaxs_after_nms(devkit, evaluated):
    out, results, dets = evaluated["reader"]
    common = [out, "--imdb", "voc_2007_test", "--data-dir", str(devkit)]
    assert reval.main(common) == results
    # test_net's rows passed a per-class NMS at TEST.NMS 0.3 already: 0.1 removes more
    got = reval.main(common + ["--nms", "--nms-thresh", "0.1"])
    jax_out = osp.join(out, "jax")
    os.makedirs(jax_out)
    want = JaxVoc("test", "2007", devkit_path=str(devkit / "VOCdevkit2007"),
                  data_dir=str(devkit)).evaluate_detections(jax_test.apply_nms(dets, 0.1), jax_out)
    assert got.keys() == want.keys()
    assert all(abs(got[k] - want[k]) <= 1e-6 for k in want)
    kept = sum(len(b) for c in jax_test.apply_nms(dets, 0.1) for b in c)
    assert 0 < kept < sum(len(b) for c in dets for b in c)       # the NMS removed rows


def test_demo_main_on_a_tiny_cpu_model(devkit, tmp_path):
    from PIL import Image

    cfg = cfg_from_list(default_config(), SERVE)
    model = _model(cfg, seed=2).eval()
    weights = str(tmp_path / "mobile.pth")
    save_params(weights, model)
    images = [str(devkit / "VOCdevkit2007" / "VOC2007" / "JPEGImages" / f"00000{i}.jpg")
              for i in range(2)]
    written = demo.main(["--cpu", "--net", "mobile", "--model", weights, "--images", *images,
                         "--out-dir", str(tmp_path / "demo"), "--conf", "0.05", "--set", *SERVE])
    assert [osp.basename(p) for p, _ in written] == ["000000.png", "000001.png"]
    for path, (png, dets) in zip(images, written):
        im = loader.read_image(path)
        assert np.asarray(Image.open(png)).shape == im.shape
        scores, boxes, valid = im_detect(model, im, cfg, device="cpu")
        rows = []
        for cls in range(1, 21):
            d = np.concatenate([boxes[valid, 4 * cls:4 * cls + 4], scores[valid, cls:cls + 1]], 1)
            d = d[d[:, 4] >= 0.05]
            d = d[jax_host_ops.nms_cpu(d, demo.NMS_THRESH)]
            rows.append(np.concatenate([d, np.full((len(d), 1), float(cls))], 1))
        want = np.concatenate(rows).astype(np.float32)
        assert dets.shape == want.shape and dets.shape[1] == 6 and len(dets) > 0
        np.testing.assert_array_equal(dets, want)
