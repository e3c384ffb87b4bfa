"""The slice end to end on the CPU: res50 C4 with one set of weights on both
sides (the lineage state_dict loaded by the port, converted for JAX by
``convert_detector``), f32, a tiny bucket.  ``predict`` rois are the same
set, ``detect`` gives the same detections (``_assert_det_sets_match``:
score atol 1e-3, box atol 5e-2), and the port's ``Detector`` serves what
the JAX ``Detector`` serves."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from frcnn_tpu import cfg_from_list as jax_cfg_from_list
from frcnn_tpu import default_config as jax_default_config
from frcnn_tpu.engine.serve import Detector as JaxDetector
from frcnn_tpu.models import build_model as jax_build_model
from frcnn_tpu.utils.weight_convert import convert_detector
from frcnn_tpu_torch import cfg_from_list, default_config
from frcnn_tpu_torch.engine.serve import Detector, iter_bucket_batches
from frcnn_tpu_torch.models.network import build_model
from frcnn_tpu_torch.ops.cuda import build
from tests.test_pipeline_parity import (NUM_CLASSES, _assert_det_sets_match,
                                        _detector_state_dict)

OVERRIDES = ["TEST.SCALES", "(128,)", "TEST.MAX_SIZE", "192",
             "TEST.RPN_PRE_NMS_TOP_N", "400", "TEST.RPN_POST_NMS_TOP_N", "32",
             "TPU.BUCKETS", "((128, 192),)"]
MAX_PER_IMAGE = NUM_CLASSES * 32  # every per-class survivor


def _images():
    """Low-frequency noise with flat rectangles (no runs of exactly tied
    scores), sized so the resize scale is 1 and both sides see the same
    pixels: one image fills the bucket, one leaves padding."""
    rng = np.random.RandomState(11)
    ims = []
    for h, w in ((128, 192), (128, 160)):
        base = rng.randint(0, 255, (h // 16 + 1, w // 16 + 1, 3)).astype(np.float32)
        t = torch.from_numpy(base).permute(2, 0, 1)[None]
        im = torch.nn.functional.interpolate(t, size=(h, w), mode="bilinear",
                                             align_corners=False)[0].permute(1, 2, 0).numpy()
        for _ in range(4):
            y, x = rng.randint(0, h - 40), rng.randint(0, w - 40)
            bh, bw = rng.randint(16, 40, 2)
            im[y:y + bh, x:x + bw] = rng.randint(0, 255, 3)
        ims.append(np.clip(im, 0, 255).astype(np.uint8))
    return ims


@pytest.fixture(scope="module")
def both():
    sd = _detector_state_dict(np.random.RandomState(0))
    jcfg = jax_cfg_from_list(jax_default_config(), OVERRIDES)
    jmodel = jax_build_model("res50", NUM_CLASSES, jcfg)
    params = convert_detector({k: v.numpy() for k, v in sd.items()}, "res50")
    jdet = JaxDetector(jmodel, {"params": params}, max_per_image=MAX_PER_IMAGE)

    model = build_model("res50", NUM_CLASSES, cfg_from_list(default_config(), OVERRIDES))
    model.load_state_dict(sd)
    det = Detector(model.eval(), max_per_image=MAX_PER_IMAGE, device="cpu")
    (_, data, im_info), = iter_bucket_batches(_images(), det.cfg)
    assert data.shape[1:3] == (128, 192)
    return jdet, det, data, im_info


def test_predict_rois_same_set(both):
    jdet, det, data, im_info = both
    want = jax.jit(lambda v, x, i: jdet.model.apply(v, x, i, method="predict"))(
        jdet.variables, jnp.asarray(data), jnp.asarray(im_info))
    with torch.no_grad():
        got = det.model.predict(torch.from_numpy(data), torch.from_numpy(im_info))
    for i in range(len(data)):
        wv = np.asarray(want["roi_valid"][i])
        gv = got["roi_valid"][i].numpy()
        assert wv.sum() == gv.sum() > 10
        w_rois = np.asarray(want["rois"][i])[wv]
        g_rois = got["rois"][i].numpy()[gv]
        w_rows = np.concatenate([w_rois, np.asarray(want["roi_scores"][i])[wv, None]], 1)
        g_rows = np.concatenate([g_rois, got["roi_scores"][i].numpy()[gv, None]], 1)
        _assert_det_sets_match(w_rows, g_rows, f"image {i} rois", score_atol=1e-5,
                               box_atol=1e-3)


def test_detect_same_detections(both):
    jdet, det, data, im_info = both
    want_d, want_v = jdet.detect_blobs(data, im_info)
    build.reset_launch_counts()
    got_d, got_v = det.detect_blobs(data, im_info)
    assert sum(build.LAUNCH_COUNTS.values()) == 0  # CPU tensors: the twins
    total = 0
    for i in range(len(data)):
        w = np.asarray(want_d[i])[np.asarray(want_v[i])]
        g = got_d[i].numpy()[got_v[i].numpy()]
        total += len(w)
        for j in range(1, NUM_CLASSES):
            _assert_det_sets_match(w[w[:, 5] == j][:, :5], g[g[:, 5] == j][:, :5],
                                   f"image {i} class {j}")
    assert total > 3


def test_detector_serves_same_results(both):
    jdet, det, _, _ = both
    ims = _images()
    for i, (w, g) in enumerate(zip(jdet(ims), det(ims))):
        assert g.shape[1] == 6 and np.isfinite(g).all()
        for j in range(1, NUM_CLASSES):
            _assert_det_sets_match(w[w[:, 5] == j][:, :5], g[g[:, 5] == j][:, :5],
                                   f"Detector image {i} class {j}")


def test_detector_dispatches_every_group_before_reading_back():
    """A request that mixes landscape and portrait images under the default
    two buckets: ``Detector.__call__`` calls ``_detect`` for both bucket
    groups before its first device-to-host read, and serves what the
    per-group form (detect, read back, next group) serves."""
    cfg = cfg_from_list(default_config(), [
        "TEST.RPN_PRE_NMS_TOP_N", "200", "TEST.RPN_POST_NMS_TOP_N", "8",
        "TEST.SCORE_THRESH", "0.0"])
    assert cfg.DEVICE.BUCKETS == ((608, 1024), (1024, 608))   # the default two
    torch.manual_seed(0)
    det = Detector(build_model("res50", 3, cfg).eval(), device="cpu")
    rng = np.random.RandomState(7)
    ims = [rng.randint(0, 255, hw + (3,)).astype(np.uint8) for hw in ((60, 96), (96, 60))]
    groups = list(iter_bucket_batches(ims, det.cfg))
    assert sorted(data.shape[1:3] for _, data, _ in groups) == [(608, 1024), (1024, 608)]

    # the per-group form
    want = [None] * len(ims)
    for indices, data, info in groups:
        dets, valid = det.detect_blobs(data, info)
        dets, valid = dets.cpu().numpy(), valid.cpu().numpy()
        for bi, i in enumerate(indices):
            want[i] = dets[bi][valid[bi]]

    calls = []
    plain_detect, plain_cpu = det._detect, torch.Tensor.cpu

    def detect(data, im_info):
        calls.append("detect")
        return plain_detect(data, im_info)

    def cpu(tensor, *args, **kwargs):
        calls.append("read")
        return plain_cpu(tensor, *args, **kwargs)

    det._detect = detect
    torch.Tensor.cpu = cpu
    try:
        got = det(ims)
    finally:
        torch.Tensor.cpu = plain_cpu
        del det._detect
    assert calls[:2] == ["detect"] * 2 and calls.count("detect") == 2
    assert calls[2:] and set(calls[2:]) == {"read"}
    assert sum(len(g) for g in got) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
