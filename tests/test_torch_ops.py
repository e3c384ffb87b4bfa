"""The PyTorch port's ops against the JAX package, on the CPU.

The same numpy inputs (seeded) go through the JAX function and its port:
anchors and IoU are equal, box decode/clip equal to an ulp at image
scale; NMS keep masks and the
fixed-shape NMS outputs are equal (also to the Pallas kernel in interpret
mode); the proposal layer's scores and validity are equal and its rois
equal to the decode's ulp; RoIAlign is
within 1e-5 of the jnp version and of the interpret-mode Pallas kernel.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from frcnn_tpu.models.proposals import proposal_layer_batch as jax_proposal_layer_batch
import frcnn_tpu.ops.anchors as jax_anchors
import frcnn_tpu.ops.boxes as jax_boxes
import frcnn_tpu.ops.nms as jax_nms
from frcnn_tpu.ops.roi_align import roi_align as jax_roi_align
from frcnn_tpu.ops.pallas.nms_kernel import nms_mask_pallas_batched
from frcnn_tpu.ops.pallas.roi_align_kernel import roi_align_pallas
from frcnn_tpu_torch.models.proposals import proposal_layer_batch
from frcnn_tpu_torch.ops import anchors, boxes, nms, roi_align
from frcnn_tpu_torch.ops.cuda import build
from tests.conftest import random_boxes


def _t(a):
    return torch.from_numpy(np.array(a))


def _clustered(rng, b, n):
    """(B, N, 4) boxes around a few centres, so that many overlap."""
    out = []
    for _ in range(b):
        centres = random_boxes(rng, max(n // 20, 2))
        bx = centres[rng.randint(0, len(centres), n)] + rng.randn(n, 4).astype(np.float32) * 8
        bx[:, 2] = np.maximum(bx[:, 2], bx[:, 0] + 1)
        bx[:, 3] = np.maximum(bx[:, 3], bx[:, 1] + 1)
        out.append(bx)
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("hw", [(4, 6), (13, 21), (50, 76)])
def test_anchors_equal(hw):
    np.testing.assert_array_equal(anchors.generate_anchors(),
                                  jax_anchors.generate_anchors())
    got, n = anchors.generate_anchors_pre(*hw, 16)
    want, n_want = jax_anchors.generate_anchors_pre(*hw, 16)
    assert n == n_want
    np.testing.assert_array_equal(got, np.asarray(want))


def test_bbox_transform_inv_clip_overlaps_equal(rng):
    b, k, c = 2, 500, 3
    base = random_boxes(rng, k)
    deltas = rng.randn(b, k, 4 * c).astype(np.float32)
    deltas[:, :50, 2:4] = 9.0  # above the BBOX_XFORM_CLIP clamp
    im_shape = np.array([[600.0, 800.0], [480.0, 640.0]], np.float32)
    want = jax_boxes.clip_boxes(
        jax_boxes.bbox_transform_inv(jnp.asarray(base), jnp.asarray(deltas)),
        jnp.asarray(im_shape))
    got = boxes.clip_boxes(boxes.bbox_transform_inv(_t(base), _t(deltas)), _t(im_shape))
    # XLA on the CPU fuses dx * w + cx into one FMA and its exp is not
    # correctly rounded: coordinates differ by at most an ulp at the image
    # scale (6.1e-5 at 512..1023 px), never more
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1.3e-4)

    q = random_boxes(rng, 60)
    np.testing.assert_array_equal(
        boxes.bbox_overlaps(_t(base), _t(q)).numpy(),
        np.asarray(jax_boxes.bbox_overlaps(jnp.asarray(base), jnp.asarray(q))))


@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.7])
def test_nms_mask_equal_to_jax_and_pallas(rng, thresh):
    bx = _clustered(rng, 3, 300)
    bx[1, 1::5] = bx[1, 0:-1:5]                       # exact duplicates
    bx[2] = np.round(bx[2] / 8) * 8                   # IoUs exactly on a threshold
    valid = rng.uniform(0, 1, (3, 300)) > 0.15
    valid[2, 200:] = False
    got = nms.nms_mask(_t(bx), thresh, _t(valid)).numpy()
    for i in range(3):
        want = np.asarray(jax_nms.nms_mask(jnp.asarray(bx[i]), thresh, jnp.asarray(valid[i])))
        np.testing.assert_array_equal(got[i], want)
    pallas = np.asarray(nms_mask_pallas_batched(jnp.asarray(bx), thresh,
                                                jnp.asarray(valid), interpret=True))
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("presorted", [True, False])
def test_nms_fixed_batched_equal(rng, presorted):
    b, n, cap = 4, 400, 50
    bx = _clustered(rng, b, n)
    scores = rng.uniform(0, 1, (b, n)).astype(np.float32)
    if presorted:
        order = np.argsort(-scores, axis=1, kind="stable")
        scores = np.take_along_axis(scores, order, 1)
        bx = np.take_along_axis(bx, order[..., None], 1)
        valid = np.arange(n)[None, :] < np.array([[n], [300], [0], [17]])
    else:
        valid = scores > 0.3
        valid[2] = False
    want_i, want_v = jax_nms.nms_fixed_batched(
        jnp.asarray(bx), jnp.asarray(scores), 0.5, cap, valid=jnp.asarray(valid),
        presorted=presorted)
    build.reset_launch_counts()
    got_i, got_v = nms.nms_fixed_batched(_t(bx), _t(scores), 0.5, cap, valid=_t(valid),
                                         presorted=presorted)
    assert build.LAUNCH_COUNTS["nms"] == 0  # CPU tensors run the twin
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_proposal_layer_batch_equal(rng):
    h, w, a = 12, 18, 9
    anc, k = jax_anchors.generate_anchors_pre(h, w, 16)
    anc = np.asarray(anc)
    b = 2
    scores = rng.uniform(0, 1, (b, k)).astype(np.float32)
    scores[0, :40] = scores[0, 40]                    # tied scores
    deltas = (rng.randn(b, k, 4) * 0.2).astype(np.float32)
    im_info = np.array([[h * 16.0, w * 16.0, 1.0], [150.0, 200.0, 0.8]], np.float32)
    kw = dict(pre_nms_top_n=600, post_nms_top_n=100, nms_thresh=0.7)
    want = jax_proposal_layer_batch(jnp.asarray(scores), jnp.asarray(deltas),
                                    jnp.asarray(anc), jnp.asarray(im_info), **kw)
    got = proposal_layer_batch(_t(scores), _t(deltas), _t(anc), _t(im_info), **kw)
    # same kept anchors in the same order: scores and validity equal; the
    # decoded boxes carry the decode's ulp (see the decode test above)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1.3e-4)
    assert got[2].sum() > 20


def test_roi_align_matches_jax_and_pallas(rng):
    b, h, w, c, r = 2, 12, 20, 16, 24
    feat = rng.randn(b, h, w, c).astype(np.float32)
    rois = np.stack([random_boxes(rng, r, width=w * 16 - 1, height=h * 16 - 1,
                                  min_size=4) for _ in range(b)])
    rois[:, :3] = rng.uniform(-200, 500, (b, 3, 4))    # partly / wholly outside
    rois[:, 3, 2:] = rois[:, 3, :2]                     # zero-size roi
    rois[:, 4] = 0.0                                    # padding roi
    build.reset_launch_counts()
    got = roi_align.extract_roi_features(_t(feat), _t(rois)).numpy()
    assert build.LAUNCH_COUNTS["roi_align"] == 0
    assert got.shape == (b, r, 7, 7, c)
    for i in range(b):
        want = np.asarray(jax_roi_align(jnp.asarray(feat[i]), jnp.asarray(rois[i])))
        np.testing.assert_allclose(got[i], want, rtol=1e-5, atol=1e-5)
        pallas = np.asarray(roi_align_pallas(jnp.asarray(feat[i]), jnp.asarray(rois[i]),
                                             7, 1.0 / 16, 2, True))
        np.testing.assert_allclose(got[i], pallas, rtol=1e-5, atol=1e-5)
