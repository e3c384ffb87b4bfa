"""POOLING_MODE "pool" and "crop", and TEST.MODE "top", in the port against
the JAX package, on the CPU, f32.

  * ``roi_pool`` against the JAX ``roi_pool``: outputs equal (an exact
    max), ``jax.vjp`` gradients within 1e-6 of max (the adds into a cell come
    in another order), with a plateau of tied maxima (the
    gradient splits over ties as ``jnp.max``'s), rois partly and wholly off
    the map, zero-size and inverted rois, and corners on a half cell (round
    half to even);
  * ``crop_and_resize_pool`` against the JAX ``crop_and_resize_pool``:
    outputs and gradients within 1e-5 of max, with border rois whose samples
    fall below -1 or past the map (empty) and in between (clamped: exact ties
    in the 2x2 max), and the plateau; not the tied columns, whose
    interpolated samples tie or not by the last bit of each package's
    rounding (2e-2 of max|dF| apart where they split differently); from a
    bf16 map the port's bf16 output is the JAX package's f32 output rounded,
    within one bf16 ulp (the sample grid in f32 on both: XLA keeps the JAX
    function's bf16 step unrounded under jit);
  * ``proposal_top_layer`` against the JAX layer per image: the order,
    scores and validity equal (ties at the cut take the lowest index), the
    boxes within 1e-4 px; anchors centred on padding never taken;
  * ``detect`` of MobileNet (width 0.25) under "pool", "crop" and "top",
    matched per class by ``_assert_det_sets_match``;
  * the FPN under TEST.MODE "top": the JAX ``FasterRCNNFPN`` never reads it,
    and the port's FPN serves the same detections under "top" as under "nms",
    and the JAX package's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from frcnn_tpu import cfg_from_list as jax_cfg_from_list
from frcnn_tpu import default_config as jax_default_config
from frcnn_tpu.engine.serve import Detector as JaxDetector
from frcnn_tpu.models import build_model as jax_build_model
from frcnn_tpu.models.proposals import proposal_top_layer as jax_proposal_top_layer
from frcnn_tpu.ops.roi_align import crop_and_resize_pool as jax_crop_and_resize_pool
from frcnn_tpu.ops.roi_align import roi_pool as jax_roi_pool
from frcnn_tpu_torch import cfg_from_list, default_config
from frcnn_tpu_torch.engine.serve import Detector, iter_bucket_batches
from frcnn_tpu_torch.models.network import build_model
from frcnn_tpu_torch.models.proposals import proposal_top_layer
from frcnn_tpu_torch.ops.anchors import generate_anchors_pre
from frcnn_tpu_torch.ops.roi_align import (crop_and_resize_pool, extract_roi_features,
                                           roi_pool)
from frcnn_tpu_torch.utils.weight_convert import convert_fpn_from_jax
from tests.test_pipeline_parity import _assert_det_sets_match
from tests.test_torch_detect import _images
from tests.test_torch_fpn import MAX_PER_IMAGE as FPN_MAX_PER_IMAGE
from tests.test_torch_fpn import OVERRIDES as FPN_OVERRIDES
from tests.test_torch_fpn import _images as _fpn_images
from tests.test_torch_fpn import _numpy_params as _fpn_numpy_params
from tests.test_torch_vgg_mobile import MAX_PER_IMAGE, NUM_CLASSES, SERVE, both_models

B, H, W, C = 2, 9, 13, 6


def _pool_inputs():
    """Maps of 9x13 cells (144x208 px at stride 16) with a plateau of tied
    maxima, and rois at the borders: the whole map, partly and wholly off it,
    zero size, inverted, corners on half cells (24 px = 1.5 cells)."""
    rng = np.random.RandomState(0)
    feat = rng.randn(B, H, W, C).astype(np.float32)
    feat[0, 2:6, 3:7] = 2.5                                  # ties inside a bin and across bins
    feat[1, :, 5] = feat[1, :, 4]                            # tied columns
    rois = rng.uniform(-40, 240, (B, 16, 4)).astype(np.float32)
    rois[..., 2:] = np.maximum(rois[..., 2:], rois[..., :2])
    rois[:, 0] = [0.0, 0.0, 207.0, 143.0]                     # the whole map
    rois[:, 1] = [24.0, 40.0, 88.0, 104.0]                   # corners on half cells
    rois[:, 2] = [-300.0, -200.0, -100.0, -50.0]             # wholly off the map
    rois[:, 3] = [150.0, 100.0, 400.0, 300.0]                # partly off
    rois[:, 4, 2:] = rois[:, 4, :2]                          # zero size
    rois[:, 5] = [120.0, 90.0, 60.0, 30.0]                   # inverted
    rois[:, 6] = [-40.0, -30.0, 20.0, 10.0]                  # samples below -1 and between
    rois[:, 7] = [180.0, 120.0, 240.0, 170.0]                # samples past the map
    return feat, rois, rng.randn(B, 16, 7, 7, C).astype(np.float32)


@pytest.mark.parametrize("mode", ["pool", "crop"])
def test_pool_modes_and_gradients_match_jax(mode):
    feat, rois, g = _pool_inputs()
    if mode == "crop":
        feat[1] = np.random.RandomState(9).randn(H, W, C)   # no tied columns (see above)
    ours, theirs = {"pool": (roi_pool, jax_roi_pool),
                    "crop": (crop_and_resize_pool, jax_crop_and_resize_pool)}[mode]
    tol, grad_tol = (0.0, 1e-6) if mode == "pool" else (1e-5, 1e-5)
    ft = torch.from_numpy(feat).requires_grad_(True)
    out = extract_roi_features(ft, torch.from_numpy(rois), mode=mode)
    out.backward(torch.from_numpy(g))
    assert out.shape == (B, 16, 7, 7, C)
    direct = ours(torch.from_numpy(feat), torch.from_numpy(rois))
    assert torch.equal(direct, out.detach())
    for i in range(B):
        want, vjp = jax.vjp(lambda f: theirs(f, jnp.asarray(rois[i])), jnp.asarray(feat[i]))
        want_g = np.asarray(vjp(jnp.asarray(g[i]))[0])
        want = np.asarray(want)
        assert np.abs(out[i].detach().numpy() - want).max() <= tol * np.abs(want).max()
        assert np.abs(ft.grad[i].numpy() - want_g).max() <= grad_tol * np.abs(want_g).max()
    assert not out.detach()[:, 2].any()                      # off the map: every bin empty
    if mode == "pool":
        # the plateau's ties: its cells share the gradient of the bins that take them
        assert (ft.grad[0, 2:6, 3:7] != 0).sum() > 1


def test_crop_bf16_is_the_f32_result_rounded():
    feat, rois, _ = _pool_inputs()
    for i in range(B):
        f16 = jnp.asarray(feat[i], jnp.bfloat16)
        want = np.asarray(jax_crop_and_resize_pool(f16, jnp.asarray(rois[i])), np.float32)
        got = crop_and_resize_pool(torch.from_numpy(np.asarray(f16, np.float32))
                                   .to(torch.bfloat16)[None], torch.from_numpy(rois[i:i + 1]))
        assert got.dtype == torch.bfloat16
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        assert np.abs(got[0].float().numpy() - want).max() <= ulp


def test_proposal_top_layer_matches_jax():
    rng = np.random.RandomState(1)
    h, w, top_n = 6, 9, 200
    anchors, _ = generate_anchors_pre(h, w, 16)
    k = len(anchors)
    scores = np.round(rng.uniform(0, 1, (B, k)), 1).astype(np.float32)   # runs of ties
    deltas = (rng.randn(B, k, 4) * 0.2).astype(np.float32)
    im_info = np.array([[96.0, 144.0, 1.0], [70.0, 100.0, 1.0]], np.float32)  # image 1: padding
    rois, sc, valid = proposal_top_layer(torch.from_numpy(scores), torch.from_numpy(deltas),
                                         torch.from_numpy(anchors), torch.from_numpy(im_info),
                                         rpn_top_n=top_n)
    assert rois.shape == (B, top_n, 4)
    for i in range(B):
        wr, ws, wv = (np.asarray(a) for a in jax_proposal_top_layer(
            jnp.asarray(scores[i]), jnp.asarray(deltas[i]), jnp.asarray(anchors),
            jnp.asarray(im_info[i]), rpn_top_n=top_n))
        np.testing.assert_array_equal(valid[i].numpy(), wv)
        np.testing.assert_array_equal(sc[i].numpy(), ws)
        np.testing.assert_allclose(rois[i].numpy(), wr, rtol=0, atol=1e-4)
    # fewer valid anchors than RPN_TOP_N in a padded image: the rest are zero rows
    small = proposal_top_layer(torch.from_numpy(scores), torch.from_numpy(deltas),
                               torch.from_numpy(anchors), torch.from_numpy(im_info),
                               rpn_top_n=k)
    assert 0 < int(small[2][1].sum()) < k and not small[0][1][~small[2][1]].any()


@pytest.mark.parametrize("extra", [["POOLING_MODE", "pool"], ["POOLING_MODE", "crop"],
                                   ["TEST.MODE", "top"]])
def test_mobile_detect_under_the_modes_matches_jax(extra):
    jmodel, params, model = both_models("mobile", SERVE + extra)
    jdet = JaxDetector(jmodel, {"params": params}, max_per_image=MAX_PER_IMAGE)
    det = Detector(model.eval(), max_per_image=MAX_PER_IMAGE, device="cpu")
    (_, data, im_info), = iter_bucket_batches(_images(), det.cfg)
    want_d, want_v = jdet.detect_blobs(data, im_info)
    got_d, got_v = det.detect_blobs(data, im_info)
    total = 0
    for i in range(len(data)):
        w = np.asarray(want_d[i])[np.asarray(want_v[i])]
        g = got_d[i].numpy()[got_v[i].numpy()]
        total += len(w)
        for j in range(1, NUM_CLASSES):
            _assert_det_sets_match(w[w[:, 5] == j][:, :5], g[g[:, 5] == j][:, :5],
                                   f"{extra} image {i} class {j}")
    assert total > 3
    if extra[0] == "TEST.MODE":
        with torch.no_grad():
            out = model.predict(torch.from_numpy(data), torch.from_numpy(im_info))
        assert out["rois"].shape[1] == (128 // 16) * (192 // 16) * 9    # every anchor: < 5000


def test_fpn_serves_nms_proposals_under_top():
    """The JAX FPN never reads TEST.MODE; the port's FPN under "top" serves
    what it serves under "nms", and what the JAX FPN serves."""
    jcfg = jax_cfg_from_list(jax_default_config(), FPN_OVERRIDES + ["TEST.MODE", "top"])
    jmodel = jax_build_model("res50_fpn", NUM_CLASSES, jcfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((2, 128, 200, 3)),
                            jnp.zeros((2, 3)))
    params = _fpn_numpy_params(shapes["params"])
    sd = convert_fpn_from_jax(params, "res50_fpn")
    dets = {}
    for mode in ("nms", "top"):
        model = build_model("res50_fpn", NUM_CLASSES,
                            cfg_from_list(default_config(), FPN_OVERRIDES + ["TEST.MODE", mode]))
        model.load_state_dict(sd, strict=True)
        det = Detector(model.eval(), max_per_image=FPN_MAX_PER_IMAGE, device="cpu")
        (_, data, im_info), = iter_bucket_batches(_fpn_images(), det.cfg)
        dets[mode] = [t.numpy() for t in det.detect_blobs(data, im_info)]
    want_d, want_v = jax.jit(lambda v, x, i: jmodel.apply(v, x, i, FPN_MAX_PER_IMAGE,
                                                          method="detect"))(
        {"params": params}, jnp.asarray(data), jnp.asarray(im_info))
    for a, b in zip(dets["top"], dets["nms"]):
        np.testing.assert_array_equal(a, b)
    (got_d, got_v), total = dets["top"], 0
    for i in range(len(data)):
        w = np.asarray(want_d[i])[np.asarray(want_v[i])]
        g = got_d[i][got_v[i]]
        total += len(w)
        for j in range(1, NUM_CLASSES):
            _assert_det_sets_match(w[w[:, 5] == j][:, :5], g[g[:, 5] == j][:, :5],
                                   f"FPN top image {i} class {j}")
    assert total > 3
