"""The port's training targets and losses against the JAX package, on the
CPU, f32.

The same seeded numpy inputs go to both sides; the port's sampling draws
are the uniforms ``jax.random`` gives along the JAX package's key splits,
so the sampled slots are identical:

  * K4's twin against the dense form of ``_anchor_pre_labels`` and the
    Pallas ``anchor_overlap_stats`` in interpret mode: argmax and tie
    membership equal, max overlaps within 2e-7;
  * K5's twin against ``topk_threshold`` in interpret mode and
    ``topk_threshold_ref``: indices and values equal, with ties, NaN, +-inf;
  * ``anchor_target_compact`` and ``proposal_target_layer``: selections and
    labels equal, targets within 1e-5, weights equal;
  * the four losses within 1e-6 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from frcnn_tpu import cfg_from_list as jax_cfg_from_list
from frcnn_tpu import default_config as jax_default_config
from frcnn_tpu.models import losses as jax_losses
from frcnn_tpu.models import targets as jax_targets
from frcnn_tpu.ops.boxes import bbox_overlaps as jax_bbox_overlaps
from frcnn_tpu.ops.pallas.overlap_kernel import anchor_overlap_stats as jax_overlap_stats
from frcnn_tpu.ops.pallas.select_kernel import topk_threshold as jax_topk_threshold
from frcnn_tpu.ops.pallas.select_kernel import topk_threshold_ref as jax_topk_threshold_ref
from frcnn_tpu_torch import cfg_from_list, default_config
from frcnn_tpu_torch.models import losses, targets
from frcnn_tpu_torch.ops.anchors import generate_anchors_pre
from frcnn_tpu_torch.ops.cuda import build
from frcnn_tpu_torch.ops.cuda.overlap_kernel import anchor_overlap_stats
from frcnn_tpu_torch.ops.cuda.select_kernel import topk_threshold, topk_threshold_reference
from tests.conftest import random_boxes

NUM_CLASSES = 5
# the C4 geometry of a 128x192 bucket, with anchors small enough (32-128 px)
# that some lie inside the image
OVERRIDES = ["TRAIN.RPN_BATCHSIZE", "64", "TRAIN.BATCH_SIZE", "32", "TPU.MAX_GT", "8",
             "ANCHOR_SCALES", "(2, 4, 8)"]


def _cfgs(extra=()):
    return (jax_cfg_from_list(jax_default_config(), OVERRIDES + list(extra)),
            cfg_from_list(default_config(), OVERRIDES + list(extra)))


def _t(a):
    return torch.from_numpy(np.array(a))


def _gt(rng, b, g, width, height):
    """Padded gt (B, G, 4), labels, validity: image 0 full, image 1 partly
    padded, with a duplicated gt (an argmax tie)."""
    gt = np.stack([random_boxes(rng, g, width, height, min_size=12) for _ in range(b)])
    gt[1, 1] = gt[1, 0]
    labels = rng.randint(1, NUM_CLASSES, (b, g)).astype(np.int32)
    valid = np.ones((b, g), bool)
    valid[1, g // 2:] = False
    return gt, labels, valid


def test_overlap_twin_matches_jax_dense_and_pallas(rng):
    k, g = 4096 + 300, 64  # two TPU tiles, the second ragged
    x1, y1 = rng.uniform(0, 600, k), rng.uniform(0, 900, k)
    anchors = np.stack([x1, y1, x1 + rng.uniform(1, 300, k), y1 + rng.uniform(1, 300, k)],
                       1).astype(np.float32)
    gt, _, gtv = _gt(rng, 2, g, 700, 1000)
    inside = rng.rand(2, k) > 0.2
    anchors[100] = anchors[101] = gt[0, 0]          # exact ties on a gt
    inside[:, 100:102] = True
    build.reset_launch_counts()
    mx, am, is_ga = anchor_overlap_stats(_t(anchors), _t(gt), _t(gtv), _t(inside))
    assert build.LAUNCH_COUNTS["overlap"] == 0  # CPU tensors run the twin
    assert am.dtype == torch.int32 and is_ga.dtype == torch.bool
    for i in range(2):
        ov = np.asarray(jax_bbox_overlaps(jnp.asarray(anchors), jnp.asarray(gt[i])))
        ov = np.where(gtv[i][None, :], ov, -1.0)
        ov = np.where(inside[i][:, None], ov, -1.0)
        gm = ov.max(0)
        want_ga = ((ov == gm[None, :]) & (gm[None, :] > 0) & gtv[i][None, :]).any(1)
        np.testing.assert_array_equal(am[i].numpy(), ov.argmax(1))
        np.testing.assert_array_equal(is_ga[i].numpy(), want_ga)
        np.testing.assert_allclose(mx[i].numpy(), ov.max(1), atol=2e-7, rtol=0)
        pmx, pam, pga = jax_overlap_stats(jnp.asarray(anchors), jnp.asarray(gt[i]),
                                          jnp.asarray(gtv[i]), jnp.asarray(inside[i]),
                                          interpret=True)
        np.testing.assert_array_equal(am[i].numpy(), np.asarray(pam))
        np.testing.assert_array_equal(is_ga[i].numpy(), np.asarray(pga))
        np.testing.assert_allclose(mx[i].numpy(), np.asarray(pmx), atol=2e-7, rtol=0)
    assert is_ga[0, 100] and is_ga[0, 101]


def _select_rows(case):
    rng = np.random.RandomState(5)
    if case == "unique":
        return rng.permutation(2 * 3001).reshape(2, 3001).astype(np.float32), 77
    if case == "ties":
        return np.floor(rng.rand(3, 2048) * 8).astype(np.float32), 500
    if case == "all_equal":
        return np.ones((2, 1536), np.float32), 1536  # k = S
    if case == "infs":
        x = rng.randn(2, 2048).astype(np.float32) * 100
        x[0, :50], x[0, 50:60], x[1, ::7] = -np.inf, np.inf, -np.inf
        return x, 300
    x = rng.randn(2, 1024).astype(np.float32)          # NaN, incl. a negative NaN
    x[0, 100] = np.nan
    x[0, 7] = np.frombuffer(np.uint32(0xFFC00000).tobytes(), np.float32)[0]
    x[1, 5] = np.nan
    return x, 50


@pytest.mark.parametrize("case", ["unique", "ties", "all_equal", "infs", "nan"])
def test_select_twin_matches_jax(case):
    x, k = _select_rows(case)
    build.reset_launch_counts()
    vals, idx = topk_threshold(_t(x), k)
    assert build.LAUNCH_COUNTS["select"] == 0
    assert idx.dtype == torch.int32
    pv, pi = jax_topk_threshold(jnp.asarray(x), k, interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(pi))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(pv))  # NaN == NaN here
    if case != "nan":  # the argsort oracle orders NaN differently from the contract
        rv, ri = jax_topk_threshold_ref(jnp.asarray(x), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    tv, ti = topk_threshold_reference(_t(x), k)
    assert torch.equal(ti, idx)


def _anchor_setup(rng, extra=()):
    jcfg, cfg = _cfgs(extra)
    anchors, k = generate_anchors_pre(8, 12, 16, scales=cfg.ANCHOR_SCALES)
    gt, _, gtv = _gt(rng, 2, 8, 191, 127)
    im_info = np.array([[128.0, 192.0, 1.0], [100.0, 150.0, 1.0]], np.float32)
    return jcfg, cfg, anchors, k, gt, gtv, im_info


@pytest.mark.parametrize("extra", [[], ["TRAIN.RPN_CLOBBER_POSITIVES", "True",
                                         "TRAIN.RPN_POSITIVE_WEIGHT", "0.3"]])
def test_anchor_target_compact_matches_jax(rng, extra):
    jcfg, cfg, anchors, k, gt, gtv, im_info = _anchor_setup(rng, extra)
    keys = jax.random.split(jax.random.PRNGKey(4), 2)
    want = [jax_targets.anchor_target_compact(jnp.asarray(anchors), jnp.asarray(gt[i]),
                                              jnp.asarray(gtv[i]), jnp.asarray(im_info[i]),
                                              keys[i], jcfg) for i in range(2)]
    u = [[np.asarray(jax.random.uniform(kk, (k,))) for kk in jax.random.split(keys[i])]
         for i in range(2)]
    got = targets.anchor_target_compact(_t(anchors), _t(gt), _t(gtv), _t(im_info),
                                        _t([u[0][0], u[1][0]]), _t([u[0][1], u[1][1]]), cfg)
    for i in range(2):
        live = got.labels[i].numpy() >= 0
        assert (got.labels[i].numpy() == 1).sum() > 0 and live.sum() > 10
        np.testing.assert_array_equal(got.labels[i].numpy(), np.asarray(want[i].labels))
        np.testing.assert_array_equal(got.sel[i].numpy(), np.asarray(want[i].sel))
        np.testing.assert_allclose(got.bbox_targets[i].numpy(),
                                   np.asarray(want[i].bbox_targets), atol=1e-5, rtol=0)
        for name in ("bbox_inside_weights", "bbox_outside_weights"):
            np.testing.assert_array_equal(getattr(got, name)[i].numpy(),
                                          np.asarray(getattr(want[i], name)))


def test_threshold_subsample_matches_top_k():
    """The K5 route of ``_subsample_idx`` (here its twin: top-k set, then the
    stable re-rank) gives lax.top_k's slots on a row long enough for the
    gate."""
    rng = np.random.RandomState(7)
    n, quota = 20000, 256
    key = jax.random.PRNGKey(9)
    for frac in (0.005, 0.5):
        mask = rng.rand(2, n) < frac
        u = np.stack([np.asarray(jax.random.uniform(kk, (n,))) for kk in jax.random.split(key)])
        want = [jax_targets._subsample_idx(jnp.asarray(mask[i]), quota, quota - 3 * i, kk)
                for i, kk in enumerate(jax.random.split(key))]
        for use_threshold in (True, False):
            idx, take = targets._subsample_idx(_t(mask), quota, _t([quota, quota - 3]), _t(u),
                                               use_threshold=use_threshold)
            for i in range(2):
                np.testing.assert_array_equal(take[i].numpy(), np.asarray(want[i][1]))
                np.testing.assert_array_equal(idx[i].numpy(), np.asarray(want[i][0]))


def test_proposal_target_layer_matches_jax(rng):
    jcfg, cfg = _cfgs()
    b, r, g = 3, 64, 8
    rois = np.stack([random_boxes(rng, r, 191, 127, min_size=8) for _ in range(b)])
    gt, labels, gtv = _gt(rng, b, g, 191, 127)
    rois[0, :10] = gt[0, :10 // 2].repeat(2, axis=0) + rng.uniform(-3, 3, (10, 4))  # fg rois
    rv = np.ones((b, r), bool)
    rv[1, 20:] = False                     # few rois: the slots repeat cyclically
    gtv[2] = False                         # no gt: the all-bg fallback
    keys = jax.random.split(jax.random.PRNGKey(6), b)
    want = [jax_targets.proposal_target_layer(
        jnp.asarray(rois[i]), jnp.asarray(rv[i]), jnp.asarray(gt[i]), jnp.asarray(labels[i]),
        jnp.asarray(gtv[i]), keys[i], jcfg, NUM_CLASSES) for i in range(b)]
    u = [[np.asarray(jax.random.uniform(kk, (r + g,))) for kk in jax.random.split(keys[i])]
         for i in range(b)]
    got = targets.proposal_target_layer(_t(rois), _t(rv), _t(gt), _t(labels), _t(gtv),
                                        _t([x[0] for x in u]), _t([x[1] for x in u]), cfg,
                                        NUM_CLASSES)
    assert (got.labels[0] > 0).sum() > 0
    for i in range(b):
        np.testing.assert_array_equal(got.rois[i].numpy(), np.asarray(want[i].rois))
        np.testing.assert_array_equal(got.labels[i].numpy(), np.asarray(want[i].labels))
        np.testing.assert_allclose(got.bbox_targets[i].numpy(),
                                   np.asarray(want[i].bbox_targets), atol=1e-5, rtol=0)
        for name in ("bbox_inside_weights", "bbox_outside_weights"):
            np.testing.assert_array_equal(getattr(got, name)[i].numpy(),
                                          np.asarray(getattr(want[i], name)))


def test_losses_match_jax(rng):
    b, s, n, c = 2, 96, 32, NUM_CLASSES

    def f(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    labels = rng.randint(-1, 2, (b, s)).astype(np.int32)
    fg = (labels == 1)[..., None].astype(np.float32)
    at = (labels, labels, f(b, s, 4) * fg, np.repeat(fg, 4, -1),
          np.where(labels[..., None] >= 0, 1.0 / 64, 0.0).repeat(4, -1).astype(np.float32))
    roi_labels = rng.randint(0, c, (b, n)).astype(np.int32)
    onehot = np.eye(c, dtype=np.float32)[roi_labels] * (roi_labels > 0)[..., None]
    w = np.repeat(onehot, 4, -1)
    pt = (f(b, n, 4), roi_labels, f(b, n, 4 * c) * w, w, w)
    args = (f(b, s, 2, scale=2.0), f(b, s, 4, scale=0.5), at, f(b, n, c, scale=2.0),
            f(b, n, 4 * c, scale=0.5), pt)
    want = jax.vmap(jax_losses.detection_losses_compact)(
        jnp.asarray(args[0]), jnp.asarray(args[1]),
        jax_targets.CompactAnchorTargets(*[jnp.asarray(a) for a in at]),
        jnp.asarray(args[3]), jnp.asarray(args[4]),
        jax_targets.ProposalTargets(*[jnp.asarray(a) for a in pt]))
    got = losses.detection_losses_compact(
        _t(args[0]), _t(args[1]), targets.CompactAnchorTargets(*[_t(a) for a in at]),
        _t(args[3]), _t(args[4]), targets.ProposalTargets(*[_t(a) for a in pt]))
    assert set(got) == set(want)
    for name in want:
        ours, theirs = got[name].numpy(), np.asarray(want[name])
        assert np.all(theirs > 0)
        np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=0, err_msg=name)
