"""The FPN serving path of the port against the JAX ``FasterRCNNFPN``, on the
CPU, f32: res50_fpn with one set of seeded weights on both sides (numpy, at
fan-in scale, in the JAX tree's shapes, carried to the port by
``convert_fpn_from_jax``), a 128x200 bucket whose C4 (8x13) and C5 (4x7)
are odd, so the neck's upsample crop runs; one image fills the bucket and
one leaves padding.

  * the pyramid P2-P6 within 1e-4 of max|level|; the RPN's A-major fg
    probability within 1e-4 and its box cells within 1e-4 of max|cells|;
  * ``select_pre_nms`` on the same numpy inputs: indices and scores equal
    (with the K5 route's re-rank too), deltas within 1e-6;
  * ``_propose`` on the same RPN outputs: rois within 1.3e-4 px, scores
    within 1e-5, valid equal;
  * ``_assign_levels`` equal on seeded rois and on level-boundary rois;
  * the multilevel RoIAlign twin against JAX ``roi_align_multilevel`` and
    against the Pallas level kernels in interpret mode (per-level and
    merged launches), one level empty, a roi count off the roi tile;
  * the box head within 1e-4 of max|output|; ``predict`` rois the same set;
    ``detect`` and ``Detector`` matched per class, with no kernel launch on
    CPU tensors;
  * single-problem NMS (``nms_fixed``, ``proposal_layer``: the TPU
    package's K1b path) with indices and valid equal;
  * the GroupNorm variant raises; the converted state_dict loads with
    ``strict=True``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from frcnn_tpu import cfg_from_list as jax_cfg_from_list
from frcnn_tpu import default_config as jax_default_config
from frcnn_tpu.models import build_model as jax_build_model
from frcnn_tpu.models.fpn import FasterRCNNFPN as JaxFPN
from frcnn_tpu.models.fpn import select_pre_nms as jax_select_pre_nms
from frcnn_tpu.models.proposals import proposal_layer as jax_proposal_layer
from frcnn_tpu.ops.nms import nms_fixed as jax_nms_fixed
from frcnn_tpu.ops.roi_align import roi_align_multilevel as jax_roi_align_multilevel
from frcnn_tpu_torch import cfg_from_list, default_config
from frcnn_tpu_torch.engine.serve import Detector, iter_bucket_batches
from frcnn_tpu_torch.models.fpn import fg_logit_diff, select_pre_nms
from frcnn_tpu_torch.models.network import build_model
from frcnn_tpu_torch.models.proposals import proposal_layer
from frcnn_tpu_torch.ops.cuda import build
from frcnn_tpu_torch.ops.nms import nms_fixed
from frcnn_tpu_torch.ops.roi_align import roi_align_multilevel
from frcnn_tpu_torch.utils.weight_convert import convert_fpn_from_jax
from tests.conftest import random_boxes
from tests.test_pipeline_parity import _assert_det_sets_match
from tests.test_torch_detect import _images as _c4_images

NUM_CLASSES = 21
H, W = 128, 200
POST = 64
OVERRIDES = ["TEST.SCALES", "(128,)", "TEST.MAX_SIZE", "200",
             "TEST.RPN_POST_NMS_TOP_N", str(POST), "TPU.BUCKETS", f"(({H}, {W}),)"]
MAX_PER_IMAGE = NUM_CLASSES * POST  # every per-class survivor
STRIDES = [4, 8, 16, 32]


def _images():
    """One image that fills the 128x200 bucket and one (128x160) that leaves
    padding; both at resize scale 1."""
    ims = _c4_images()
    rng = np.random.RandomState(12)
    wide = np.concatenate([ims[0], ims[0][:, :8]], axis=1)            # 128 x 200
    wide[:, 192:] = rng.randint(0, 255, 3)
    return [wide, ims[1]]


def _numpy_params(shapes, seed=0):
    """Seeded weights in the JAX tree's shapes: kernels N(0, 1/fan_in) (the
    stem's 64x smaller: raw pixels are O(100)), biases small, frozen BN near
    identity; RPN class weights N(0, 0.03), so that the fg probabilities
    spread without saturating at 1.0 (a saturated run is a run of exact
    ties), box weights N(0, 0.01)."""
    rng = np.random.RandomState(seed)

    def make(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            stem = 64.0 if path[-2].key == "conv1" and path[0].key == "stages" else 1.0
            return (rng.randn(*s.shape) / np.sqrt(fan_in) / stem).astype(np.float32)
        if name in ("rpn_cls_w", "rpn_box_w"):
            return (rng.randn(*s.shape) * (0.03 if name == "rpn_cls_w" else 0.01)
                    ).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.0, s.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.randn(*s.shape) * 0.05).astype(np.float32)    # bias, mean, head biases

    return jax.tree_util.tree_map_with_path(make, shapes)


def _jax_all(mdl, images, im_info):
    pyr = mdl._pyramid(images)
    _, prob, _, cells, _ = mdl._rpn_all_levels(pyr)
    anchors = mdl._anchors(pyr)
    props = mdl._propose(pyr, prob, cells, anchors, im_info, train=False)
    out = mdl.predict(images, im_info)
    det = mdl.detect(images, im_info, MAX_PER_IMAGE)
    return pyr, prob, cells, props, out, det


@pytest.fixture(scope="module")
def both():
    jcfg = jax_cfg_from_list(jax_default_config(), OVERRIDES)
    jmodel = jax_build_model("res50_fpn", NUM_CLASSES, jcfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((2, H, W, 3)),
                            jnp.zeros((2, 3)))
    params = _numpy_params(shapes["params"])
    sd = convert_fpn_from_jax(params, "res50_fpn")
    model = build_model("res50_fpn", NUM_CLASSES, cfg_from_list(default_config(), OVERRIDES))
    model.load_state_dict(sd, strict=True)
    det = Detector(model.eval(), max_per_image=MAX_PER_IMAGE, device="cpu")
    (_, data, im_info), = iter_bucket_batches(_images(), det.cfg)
    assert data.shape[1:3] == (H, W)
    assert im_info[1, 1] < W                                           # padding
    run = jax.jit(lambda v, x, i: jmodel.apply(v, x, i, method=_jax_all))
    want = jax.tree.map(np.asarray, run({"params": params}, jnp.asarray(data),
                                        jnp.asarray(im_info)))
    return {"jmodel": jmodel, "params": params, "sd": sd, "model": model, "det": det,
            "data": data, "im_info": im_info, "want": want}


def _port(both, fn):
    with torch.no_grad():
        return fn(both["model"], torch.from_numpy(both["data"]), torch.from_numpy(both["im_info"]))


def test_convert_fpn_loads_strict(both):
    sd, model = both["sd"], both["model"]
    assert set(sd) == set(model.state_dict())
    n_leaves = len(jax.tree.leaves(both["params"]))
    assert len(sd) == n_leaves                          # one tensor per JAX leaf
    got = model.box_head.fc1.weight.detach().numpy()
    kernel = both["params"]["box_head"]["fc1"]["kernel"]
    np.testing.assert_array_equal(got[:, 5 * 7 * 256 + 3 * 256 + 17], kernel[5, 3, 17])


@pytest.mark.parametrize("level", range(5))
def test_pyramid_level_matches_jax(both, level):
    got = _port(both, lambda m, x, i: m._pyramid(x))[level]
    want = both["want"][0][level]
    got = got.permute(0, 2, 3, 1).numpy()
    hw = [(32, 50), (16, 25), (8, 13), (4, 7), (2, 4)][level]     # odd C4 and C5
    assert got.shape == want.shape == (2, *hw, 256)
    scale = np.abs(want).max()
    assert scale > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


def test_rpn_matches_jax(both):
    prob, cells, _ = _port(both, lambda m, x, i: m._rpn_all_levels(m._pyramid(x)))
    # probabilities in (0, 1): the pyramid's 1e-4 of max, after the 3x3 RPN conv
    np.testing.assert_allclose(prob.numpy(), both["want"][1], rtol=0, atol=1e-4)
    for g, w in zip(cells, both["want"][2]):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fg_logit_diff_is_the_f32_product(dtype):
    """The RPN's logit difference is the f32 product of the compute-dtype
    operands, (B, HW, A) in cell order, in both compute dtypes (the card's
    bf16 route is held to the same in tests/test_torch_cuda.py and
    chip_smoke.py)."""
    rng = np.random.RandomState(13)
    tokens = torch.from_numpy(rng.randn(2, 35, 256).astype(np.float32)).to(dtype)
    dw = torch.from_numpy(rng.randn(256, 3).astype(np.float32) * 0.05)
    db = torch.from_numpy(rng.randn(3).astype(np.float32))
    got = fg_logit_diff(tokens, dw, db)
    want = np.einsum("bnc,ca->bna", tokens.float().numpy().astype(np.float64),
                     dw.to(dtype).float().numpy().astype(np.float64)) + db.numpy()
    assert got.dtype == torch.float32 and got.shape == (2, 35, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def _select_inputs(seed):
    """A-major fg probabilities with runs of exact ties, box cells and the
    per-level sizes of the 128x200 bucket."""
    rng = np.random.RandomState(seed)
    hws = [(32, 50), (16, 25), (8, 13), (4, 7), (2, 4)]
    sizes = [h * w * 3 for h, w in hws]
    prob = np.round(rng.uniform(0, 1, (2, sum(sizes))) * 300) / 300   # many ties
    prob[1, :2000] = 0.5                                              # a padded-looking run
    cells = [rng.randn(2, h * w, 12).astype(np.float32) for h, w in hws]
    return prob.astype(np.float32), cells, sizes


@pytest.mark.parametrize("use_threshold", [False, True])
def test_select_pre_nms_equal(use_threshold):
    prob, cells, sizes = _select_inputs(4)
    per = 1000 if not use_threshold else 100           # 100: the K5 gate passes at P2
    want = jax_select_pre_nms(jnp.asarray(prob), [jnp.asarray(c) for c in cells], sizes,
                              per, 3)
    got = select_pre_nms(torch.from_numpy(prob), [torch.from_numpy(c) for c in cells], sizes,
                         per, 3, use_threshold=use_threshold)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0, atol=1e-6)


def test_propose_matches_jax(both):
    """The same RPN outputs (the JAX ones) into both ``_propose``s."""
    _, prob, cells, (w_rois, w_scores, w_valid), _, _ = both["want"]
    model = both["model"]
    pyr = [torch.zeros(2, 1, p.shape[1], p.shape[2]) for p in both["want"][0]]
    with torch.no_grad():
        rois, scores, valid = model._propose(
            pyr, torch.tensor(prob), [torch.tensor(c) for c in cells],
            model._anchors(pyr), torch.from_numpy(both["im_info"]))
    np.testing.assert_array_equal(valid.numpy(), w_valid)
    assert w_valid.sum(1).min() > 10
    np.testing.assert_allclose(rois.numpy(), w_rois, rtol=0, atol=1.3e-4)
    np.testing.assert_allclose(scores.numpy(), w_scores, rtol=0, atol=1e-5)


def test_assign_levels_equal(both):
    """Seeded rois and the boundary rois of the JAX package's FPN tests.  A
    roi within an ulp of a level boundary would show here as a different
    level: the comparison is exact."""
    rng = np.random.RandomState(5)
    rois = random_boxes(rng, 400, width=1200, height=800, min_size=1)
    rois[:6] = [[0, 0, 31, 31], [0, 0, 111, 111], [0, 0, 223, 223], [0, 0, 447, 447],
                [0, 0, 1000, 1000], [0, 0, 7, 7]]
    rois[6:10] = [[0, 0, 0, 0], [5, 5, 4, 4], [0, 0, 55, 55], [10, 10, 10 + 447.5, 10 + 447.5]]
    want = np.asarray(both["jmodel"].apply({"params": both["params"]}, jnp.asarray(rois),
                                           method=JaxFPN._assign_levels))
    got = both["model"]._assign_levels(torch.from_numpy(rois)).numpy()
    np.testing.assert_array_equal(got[:6], [2, 3, 4, 5, 5, 2])
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) == {2, 3, 4, 5}


def _ml_inputs(rng, c, r, hw):
    feats = [rng.randn(2, h, w, c).astype(np.float32) for h, w in hw]
    rois = np.stack([random_boxes(rng, r, width=190, height=120, min_size=4) for _ in range(2)])
    rois[:, :3] = [[-30, -20, 40, 50], [0, 0, 0, 0], [60, 40, 55, 35]]   # outside, zero, inverted
    levels = rng.randint(0, 4, (2, r)).astype(np.int32)
    levels[levels == 2] = 1                                              # level 2 empty
    return feats, rois, levels


def test_roi_align_multilevel_twin_matches_jax():
    rng = np.random.RandomState(6)
    feats, rois, levels = _ml_inputs(rng, 16, 37, [(32, 50), (16, 25), (8, 13), (4, 7)])
    got = roi_align_multilevel([torch.from_numpy(f) for f in feats], torch.from_numpy(rois),
                               torch.from_numpy(levels), STRIDES).numpy()
    for i in range(2):
        want = np.asarray(jax_roi_align_multilevel([jnp.asarray(f[i]) for f in feats],
                                                   jnp.asarray(rois[i]),
                                                   jnp.asarray(levels[i]), STRIDES))
        np.testing.assert_allclose(got[i], want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("merged", [False, True])
def test_roi_align_multilevel_twin_matches_pallas_interpret(monkeypatch, merged):
    """The TPU kernels K6 (per-level launches) and K6c (merged tail levels)
    through the Pallas interpreter, against the port's twin: one empty
    level, 19 rois (off the roi tile)."""
    import sys

    from frcnn_tpu.ops.roi_align import roi_align_multilevel_pallas

    monkeypatch.setattr(sys.modules["frcnn_tpu.ops.roi_align"], "MERGED_LEVEL_FWD", merged)
    rng = np.random.RandomState(7)
    feats, rois, levels = _ml_inputs(rng, 128, 19, [(32, 48), (16, 24), (8, 12), (4, 6)])
    got = roi_align_multilevel([torch.from_numpy(f[:1]) for f in feats],
                               torch.from_numpy(rois[:1]), torch.from_numpy(levels[:1]),
                               STRIDES).numpy()[0]
    want = np.asarray(roi_align_multilevel_pallas([jnp.asarray(f[0]) for f in feats],
                                                  jnp.asarray(rois[0]), jnp.asarray(levels[0]),
                                                  STRIDES, interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_box_head_matches_jax(both):
    rng = np.random.RandomState(8)
    pooled = rng.randn(2, 11, 7, 7, 256).astype(np.float32)
    want = both["jmodel"].apply({"params": both["params"]}, jnp.asarray(pooled), False,
                                method=JaxFPN._classify)
    with torch.no_grad():
        got = both["model"]._classify(torch.from_numpy(pooled))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())


def test_predict_rois_same_set(both):
    want = both["want"][4]
    got = _port(both, lambda m, x, i: m.predict(x, i))
    for i in range(2):
        wv = want["roi_valid"][i]
        gv = got["roi_valid"][i].numpy()
        assert wv.sum() == gv.sum() > 10
        w_rows = np.concatenate([want["rois"][i][wv], want["roi_scores"][i][wv, None]], 1)
        g_rows = np.concatenate([got["rois"][i].numpy()[gv],
                                 got["roi_scores"][i].numpy()[gv, None]], 1)
        _assert_det_sets_match(w_rows, g_rows, f"image {i} rois", score_atol=1e-5,
                               box_atol=1e-3)


def _match_per_class(want_dets, got_dets, label):
    total = 0
    for i, (w, g) in enumerate(zip(want_dets, got_dets)):
        assert g.shape[1] == 6 and np.isfinite(g).all()
        total += len(w)
        for j in range(1, NUM_CLASSES):
            _assert_det_sets_match(w[w[:, 5] == j][:, :5], g[g[:, 5] == j][:, :5],
                                   f"{label} image {i} class {j}")
    assert total > 3


def test_detect_same_detections(both):
    det_d, det_v = both["want"][5]
    want = [det_d[i][det_v[i]] for i in range(2)]
    build.reset_launch_counts()
    got_d, got_v = both["det"].detect_blobs(both["data"], both["im_info"])
    assert sum(build.LAUNCH_COUNTS.values()) == 0          # CPU tensors: the twins
    _match_per_class(want, [got_d[i].numpy()[got_v[i].numpy()] for i in range(2)], "detect")


def test_detector_serves_same_results(both):
    det_d, det_v = both["want"][5]
    want = [det_d[i][det_v[i]] for i in range(2)]
    _match_per_class(want, both["det"](_images()), "Detector")


def test_fpn_gn_raises():
    cfg = cfg_from_list(default_config(), OVERRIDES)
    with pytest.raises(ValueError, match="GroupNorm"):
        build_model("res50_fpn_gn", NUM_CLASSES, cfg)
    with pytest.raises(ValueError, match="not ported"):
        build_model("res18_fpn", NUM_CLASSES, cfg)


@pytest.mark.parametrize("thresh", [0.5, 0.7])
def test_nms_fixed_matches_jax(thresh):
    """K1b's path: one problem of unsorted scores with invalid entries."""
    rng = np.random.RandomState(9)
    boxes = random_boxes(rng, 600, width=300, height=300, min_size=8)
    boxes[1::9] = boxes[::9][:len(boxes[1::9])]                        # duplicates
    scores = rng.uniform(0, 1, 600).astype(np.float32)
    valid = rng.uniform(0, 1, 600) > 0.15
    want = jax_nms_fixed(jnp.asarray(boxes), jnp.asarray(scores), thresh, 100,
                         valid=jnp.asarray(valid))
    got = nms_fixed(torch.from_numpy(boxes), torch.from_numpy(scores), thresh, 100,
                    valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_proposal_layer_matches_jax():
    from frcnn_tpu_torch.ops.anchors import generate_anchors_pre

    rng = np.random.RandomState(10)
    anchors, k = generate_anchors_pre(8, 12, 16)
    scores = rng.uniform(0, 1, k).astype(np.float32)
    deltas = (rng.randn(k, 4) * 0.2).astype(np.float32)
    im_info = np.asarray([120.0, 150.0, 1.0], np.float32)
    kw = dict(pre_nms_top_n=400, post_nms_top_n=50, nms_thresh=0.7)
    want = jax_proposal_layer(jnp.asarray(scores), jnp.asarray(deltas), jnp.asarray(anchors),
                              jnp.asarray(im_info), **kw)
    got = proposal_layer(torch.from_numpy(scores), torch.from_numpy(deltas),
                         torch.from_numpy(anchors), torch.from_numpy(im_info), **kw)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert np.asarray(want[2]).sum() > 10
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1.3e-4)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
