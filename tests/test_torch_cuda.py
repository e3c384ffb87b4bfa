"""The CUDA kernels against their plain twins on a card (marker ``cuda``),
gradients through the autograd Functions of K2, K3 and K6 (backward K6b),
K6 (the multilevel RoIAlign) bit-equal to K2 on one level, K2b / K6b
bit-deterministic, whatever their plan, ``test_net`` on the card
matched to a CPU copy, a two-rank mesh step on one card against the
unsharded step, the launcher's refusal of a tensor of another card, and
graphed serving: a ``Detector`` replaying its captured graphs bit-equal to
eager ``detect``, new weights copied in reaching the replay, rebound ones
recaptured, a failed capture raised, a pageable batch staged into the static
inputs bit for bit (a pinned or device batch not staged), two calls queued
with no readback each served its own batch, no pageable copy; the BN epilogue bit-equal to its twin,
``detect`` and the validation losses with it against the module-by-module
path, and frozen-BN statistics copied in reaching a replay.

Run on a machine with an NVIDIA H100 (which has no jax, so without the
suite's conftest):  pytest --noconftest -m cuda tests/test_torch_cuda.py
Here, without a card, every test skips.  ``chip_smoke.py`` runs the same
comparisons at the main path's full shapes."""

import numpy as np
import pytest
import torch

import chip_smoke
from frcnn_tpu_torch.models.backbones import Bottleneck
from frcnn_tpu_torch.models.fpn import fg_logit_diff
from frcnn_tpu_torch.ops.cuda import build
from frcnn_tpu_torch.ops.cuda.bn_epilogue import bn_epilogue, bn_epilogue_reference
from frcnn_tpu_torch.ops.cuda.fpn_epilogue import fpn_epilogue, fpn_epilogue_reference
from frcnn_tpu_torch.ops.cuda.fused_block import bottleneck_reference, fused_bottleneck
from frcnn_tpu_torch.ops.cuda.nms_kernel import (nms_mask_batched, nms_mask_reference,
                                                 nms_plan)
from frcnn_tpu_torch.ops.cuda.overlap_kernel import (anchor_overlap_stats,
                                                     anchor_overlap_stats_reference, overlap_plan)
from frcnn_tpu_torch.ops.cuda.roi_align_kernel import (roi_align_backward,
                                                       roi_align_backward_reference,
                                                       roi_align_forward,
                                                       roi_align_multilevel_backward,
                                                       roi_align_multilevel_backward_reference,
                                                       roi_align_multilevel_forward,
                                                       roi_align_multilevel_reference,
                                                       roi_align_reference, roi_bwd_plan,
                                                       roi_plan)
from frcnn_tpu_torch.ops.cuda.select_kernel import topk_threshold, topk_threshold_reference
from frcnn_tpu_torch.ops.roi_align import extract_multilevel_features, extract_roi_features

pytestmark = pytest.mark.cuda


def random_boxes(rng, n, width=800, height=600):
    x1 = rng.uniform(0, width - 3, n)
    y1 = rng.uniform(0, height - 3, n)
    x2 = np.minimum(x1 + rng.uniform(2, width / 2, n), width - 1)
    y2 = np.minimum(y1 + rng.uniform(2, height / 2, n), height - 1)
    return np.stack([x1, y1, x2, y2], axis=1).astype(np.float32)


@pytest.fixture
def rng():
    return np.random.RandomState(3)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_nms_kernel_bit_equal(dev, rng):
    boxes = np.stack([random_boxes(rng, 700) for _ in range(3)])
    boxes[1, 1::3] = boxes[1, 0:-1:3]
    valid = rng.uniform(0, 1, (3, 700)) > 0.2
    bx, vd = torch.from_numpy(boxes).to(dev), torch.from_numpy(valid).to(dev)
    build.reset_launch_counts()
    for thresh in (0.3, 0.7):
        assert torch.equal(nms_mask_batched(bx, thresh, vd), nms_mask_reference(bx, thresh, vd))
    assert build.LAUNCH_COUNTS["nms"] == 2


def _nms_problems(rng, case):
    """(boxes (B, N, 4), valid (B, N)): the chunked kernel's boundary cases."""
    if case == "ragged_n":                       # N no multiple of 64; problem 1 has no valid box
        boxes = np.stack([random_boxes(rng, 333) for _ in range(3)])
        valid = rng.uniform(0, 1, (3, 333)) > 0.2
        valid[1] = False
    elif case == "below_one_chunk":
        boxes = np.stack([random_boxes(rng, 37) for _ in range(2)])
        valid = rng.uniform(0, 1, (2, 37)) > 0.1
    elif case == "duplicates_and_grid":          # IoU 1, and IoUs exactly on the threshold
        boxes = np.stack([random_boxes(rng, 700) for _ in range(2)])
        boxes[0, 1::3] = boxes[0, 0:-1:3]
        boxes[1] = np.round(boxes[1] / 8) * 8
        boxes[1, :4] = [[0, 0, 9, 9], [0, 0, 9, 4], [0, 5, 9, 9], [0, 0, 4, 9]]
        valid = np.ones((2, 700), bool)
    elif case == "few_distinct":                 # heavy suppression: a cap of 300 is never reached
        boxes = np.tile(np.stack([random_boxes(rng, 40) for _ in range(2)]), (1, 50, 1))
        valid = np.ones((2, 2000), bool)
    elif case == "invalid_chunk":                # a whole chunk of invalid boxes
        boxes = np.stack([random_boxes(rng, 256) for _ in range(2)])
        valid = np.ones((2, 256), bool)
        valid[:, 64:128] = False
    else:
        raise KeyError(case)
    return boxes.astype(np.float32), valid


@pytest.mark.parametrize("case", ["ragged_n", "below_one_chunk", "duplicates_and_grid",
                                  "few_distinct", "invalid_chunk"])
def test_nms_kernel_capped_masks_over_plans(dev, rng, case):
    """With ``max_keep`` the mask is the twin's cut after its first cap kept
    boxes, for every cluster size and thread count the launcher takes: cap 1,
    a cap inside the first chunk, one in mid walk, one never reached, none."""
    boxes, valid = _nms_problems(rng, case)
    b, n = valid.shape
    bx, vd = torch.from_numpy(boxes).to(dev), torch.from_numpy(valid).to(dev)
    for thresh in (0.5, 0.7):
        full = nms_mask_reference(bx, thresh, vd)
        order = torch.cumsum(full, 1)
        for cap in (None, 1, 9, 100, 300, n + 5):
            want = full if cap is None else full & (order <= cap)
            build.reset_launch_counts()
            assert torch.equal(nms_mask_batched(bx, thresh, vd, max_keep=cap), want)
            assert build.LAUNCH_COUNTS["nms"] == 1
            for cluster in (1, 2, 8, 16):
                for threads in (64, 1024):
                    plan = nms_plan(b, n, cap, cluster=cluster, threads=threads)
                    got = nms_mask_batched(bx, thresh, vd, max_keep=cap, plan=plan)
                    assert torch.equal(got, want), (case, thresh, cap, plan)


def test_nms_launcher_refuses_a_list_too_small(dev, rng):
    bx = torch.from_numpy(np.stack([random_boxes(rng, 200)])).to(dev)
    plan = dict(nms_plan(1, 200, 50), slots=10)          # 10 slots for 50 kept boxes
    with pytest.raises(RuntimeError):
        nms_mask_batched(bx, 0.7, max_keep=50, plan=plan)
    plan = dict(nms_plan(1, 200, 50), threads=96)        # not a power of two
    with pytest.raises(RuntimeError):
        nms_mask_batched(bx, 0.7, max_keep=50, plan=plan)


def _edge_rois(rng, b, r, width, height):
    rois = np.stack([random_boxes(rng, r, width=width, height=height) for _ in range(b)])
    rois[:, :4] = rng.uniform(-300, width + 300, (b, 4, 4))      # partly / wholly outside
    rois[:, 4] = [-900.0, -900.0, -700.0, -800.0]                # wholly outside
    rois[:, 5, 2:] = rois[:, 5, :2]                              # degenerate
    rois[:, 6] = 0.0                                             # padding
    rois[:, 7, 2:] = rois[:, 7, :2] - 30.0                       # inverted corners
    rois[:, 8] = [8.0, 40.0, width - 8.0, 120.0]                 # wider than 28 columns
    rois[:, 9, 2:] = rois[:, 9, :2] + 1.0                        # one pixel
    rois[:, 10] = [0.0, 0.0, width, height]                      # the whole map
    return rois


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1024, 512, 256, 128, 96, 33, 1023])
def test_roi_align_staged_kernel_over_plans(dev, rng, c, dtype):
    """The staged forward at 16 bytes of channels a thread and (odd C) one
    channel, over channel chunks, threads and staging sizes; a small buffer
    makes the wide rois take their chunk in several passes."""
    b, h, w, r = 2, 24, 50, 32
    feat = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32)).to(dev, dtype)
    rois = torch.from_numpy(_edge_rois(rng, b, r, w * 16 - 1.0, h * 16 - 1.0)).to(dev)
    want = roi_align_reference(feat, rois)
    scale = want.float().abs().max().item()
    tol = 1e-5 * scale if dtype == torch.float32 else 2.0 ** (np.floor(np.log2(scale)) - 7)
    base = roi_plan(c, feat.element_size())
    least = 28 * 28 * base["vec"] * feat.element_size()
    first = roi_align_forward(feat, rois)
    assert (first.float() - want.float()).abs().max().item() <= tol
    assert not first[:, 4].any()
    for chunk in (base["vec"], 4 * base["vec"], c // base["vec"] * base["vec"]):
        for threads in (32, 128, 512):
            for smem in (least, base["smem_bytes"], 100 * 1024):
                plan = {**base, "chunk": chunk, "threads": threads, "smem_bytes": smem}
                got = roi_align_forward(feat, rois, plan=plan)
                assert torch.equal(got, first), plan      # the geometry changes no bit


def test_roi_align_launcher_refuses_a_buffer_too_small(dev, rng):
    feat = torch.from_numpy(rng.randn(1, 8, 8, 64).astype(np.float32)).to(dev)
    rois = torch.zeros(1, 4, 4, device=dev)
    plan = dict(roi_plan(64, 4), smem_bytes=4096)        # under 28 x 28 pixels x 16 bytes
    with pytest.raises(RuntimeError):
        roi_align_forward(feat, rois, plan=plan)


def test_roi_align_kernel_matches_twin(dev, rng):
    feat = torch.from_numpy(rng.randn(2, 20, 30, 96).astype(np.float32)).to(dev)
    rois = np.stack([random_boxes(rng, 40, width=479, height=319) for _ in range(2)])
    rois[:, :4] = rng.uniform(-100, 600, (2, 4, 4))
    rois = torch.from_numpy(rois).to(dev)
    got, want = roi_align_forward(feat, rois), roi_align_reference(feat, rois)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def _pyramid(rng, dev, c, dtype):
    feats = [torch.from_numpy(rng.randn(2, h, w, c).astype(np.float32)).to(dev, dtype)
             for h, w in ((40, 60), (20, 30), (10, 15), (5, 8))]
    rois = np.stack([random_boxes(rng, 50, width=239, height=159) for _ in range(2)])
    rois[:, :4] = rng.uniform(-100, 300, (2, 4, 4))
    return feats, torch.from_numpy(rois).to(dev)


@pytest.mark.parametrize("dtype,c", [(torch.float32, 96), (torch.bfloat16, 96),
                                     (torch.float32, 33), (torch.bfloat16, 33)])
def test_roi_align_multilevel_kernel_matches_twin(dev, rng, dtype, c):
    """C = 96 takes 16 bytes of channels a thread, C = 33 one; a level outside [0, 4)
    pools zeros; level 2 is empty."""
    feats, rois = _pyramid(rng, dev, c, dtype)
    levels = torch.from_numpy(rng.choice([0, 1, 3, 4, -1], (2, 50), p=[.3, .3, .3, .05, .05])
                              .astype(np.int32)).to(dev)
    build.reset_launch_counts()
    got = roi_align_multilevel_forward(feats, rois, levels, [4, 8, 16, 32])
    want = roi_align_multilevel_reference(feats, rois, levels, [4, 8, 16, 32])
    assert build.LAUNCH_COUNTS["roi_align_ml"] == 1 and got.dtype == dtype
    scale = want.float().abs().max().item()
    tol = 1e-5 * scale if dtype == torch.float32 else 2.0 ** (np.floor(np.log2(scale)) - 7)
    assert (got.float() - want.float()).abs().max().item() <= tol
    off = (levels < 0) | (levels > 3)
    assert off.any() and not got[off].any()


@pytest.mark.parametrize("c", [96, 33])
def test_roi_align_multilevel_on_one_level_equals_k2(dev, rng, c):
    feats, rois = _pyramid(rng, dev, c, torch.bfloat16)
    levels = torch.full((2, 50), 1, dtype=torch.int32, device=dev)
    got = roi_align_multilevel_forward(feats, rois, levels, [4, 8, 16, 32])
    assert torch.equal(got, roi_align_forward(feats[1], rois, 7, 1.0 / 8, 2))


@pytest.mark.parametrize("dtype,c", [(torch.float32, 96), (torch.bfloat16, 96),
                                     (torch.float32, 33), (torch.bfloat16, 33)])
def test_roi_align_multilevel_backward_kernel_matches_twin(dev, rng, dtype, c):
    """K6b: C = 96 reads 16 bytes of dOut a thread, C = 33 one channel;
    level 2 is empty (dense zeros); a level outside [0, 4) adds nothing."""
    feats, rois = _pyramid(rng, dev, c, dtype)
    hws = [tuple(f.shape[1:3]) for f in feats]
    levels = torch.from_numpy(rng.choice([0, 1, 3, 4, -1], (2, 50), p=[.3, .3, .3, .05, .05])
                              .astype(np.int32)).to(dev)
    dout = torch.from_numpy(rng.randn(2, 50, 7, 7, c).astype(np.float32)).to(dev, dtype)
    build.reset_launch_counts()
    got = roi_align_multilevel_backward(dout, rois, levels, hws, [4, 8, 16, 32])
    want = roi_align_multilevel_backward_reference(dout, rois, levels, hws, [4, 8, 16, 32])
    assert build.LAUNCH_COUNTS["roi_align_ml_bwd"] == 1 and len(got) == 4
    again = roi_align_multilevel_backward(dout, rois, levels, hws, [4, 8, 16, 32])
    assert all(_same_bits(a, g) for a, g in zip(again, got))
    scale = max(w.float().abs().max().item() for w in want)
    tol = 1e-5 * scale if dtype == torch.float32 else 2.0 ** (np.floor(np.log2(scale)) - 7)
    for g, w, f in zip(got, want, feats):
        assert g.dtype == dtype and g.shape == f.shape
        assert (g.float() - w.float()).abs().max().item() <= tol
    assert not got[2].any() and got[0].any()


def test_gradients_reach_every_level_map(dev, rng):
    """Level maps that require grad, handed over as channels-last views as
    the FPN model's ``_pool`` does: K6's result carries a grad_fn and K6b's
    gradient reaches every map, dense, equal to the twin's."""
    c = 64
    nchw = [torch.randn(2, c, h, w, device=dev).contiguous(memory_format=torch.channels_last)
            .requires_grad_(True) for h, w in ((40, 60), (20, 30), (10, 15), (5, 8))]
    rois = torch.from_numpy(np.stack([random_boxes(rng, 50, width=239, height=159)
                                      for _ in range(2)])).to(dev)
    levels = torch.from_numpy(rng.randint(0, 3, (2, 50)).astype(np.int32)).to(dev)  # P5 empty
    g = torch.randn(2, 50, 7, 7, c, device=dev)
    build.reset_launch_counts()
    out = extract_multilevel_features([m.permute(0, 2, 3, 1) for m in nchw], rois, levels,
                                      [4, 8, 16, 32])
    assert out.grad_fn is not None
    out.backward(g)
    assert build.LAUNCH_COUNTS["roi_align_ml"] == 1
    assert build.LAUNCH_COUNTS["roi_align_ml_bwd"] == 1
    want = roi_align_multilevel_backward_reference(g, rois, levels,
                                                   [tuple(m.shape[2:]) for m in nchw],
                                                   [4, 8, 16, 32])
    scale = max(w.abs().max().item() for w in want)
    for m, w in zip(nchw, want):
        assert m.grad is not None and m.grad.shape == m.shape
        assert (m.grad.permute(0, 2, 3, 1) - w).abs().max().item() <= 1e-5 * scale
    assert not nchw[3].grad.any() and nchw[0].grad.any()


def test_rpn_logit_product_bf16_matches_f32(dev, rng):
    """The FPN RPN's bf16 mm with an f32 result against the f32 product of
    the same bf16 operands."""
    tokens = torch.from_numpy(rng.randn(2, 1000, 256).astype(np.float32)).to(dev, torch.bfloat16)
    dw = torch.from_numpy(rng.randn(256, 3).astype(np.float32) * 0.05).to(dev)
    db = torch.from_numpy(rng.randn(3).astype(np.float32)).to(dev)
    got = fg_logit_diff(tokens, dw, db)
    want = tokens.float() @ dw.to(torch.bfloat16).float() + db
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 1000, 3)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("cin,mid,proj", [(64, 64, True), (256, 64, False), (512, 128, False),
                                          (256, 128, True), (48, 64, True)])
@pytest.mark.parametrize("b,h,w", [(2, 21, 37),    # odd, ragged in both directions
                                   (1, 3, 5),      # smaller than one 8 x 30 tile
                                   (1, 8, 30),     # exactly one tile
                                   (3, 9, 61)])    # one row and one column into the next tiles
def test_fused_block_kernel_matches_twin(dev, b, h, w, cin, mid, proj):
    g = torch.Generator().manual_seed(0)
    cout = 4 * mid

    def r(*s, std=1.0):
        return (torch.randn(s, generator=g) * std).to(dev, torch.bfloat16)

    x = torch.relu(r(b, h, w, cin))
    wts = [r(cin, mid, std=(2 / cin) ** 0.5), r(mid, std=0.1),
           r(9 * mid, mid, std=(2 / (9 * mid)) ** 0.5), r(mid, std=0.1),
           r(mid, cout, std=mid ** -0.5), r(cout, std=0.1)]
    ds = [r(cin, cout, std=cin ** -0.5), r(cout, std=0.1)] if proj else [None, None]
    build.reset_launch_counts()
    got = fused_bottleneck(x, *wts, *ds).float()
    assert build.LAUNCH_COUNTS["fused_block"] == 1
    want = bottleneck_reference(x, wts[0], wts[1], wts[2].reshape(3, 3, mid, mid), *wts[3:],
                                *ds).float()
    scale = want.abs().max().item()
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 4 * ulp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [96, 512, 128])      # and VGG-16's / MobileNet's widths
def test_roi_align_backward_kernel_matches_twin(dev, rng, dtype, c):
    dout = torch.from_numpy(rng.randn(2, 40, 7, 7, c).astype(np.float32)).to(dev, dtype)
    rois = np.stack([random_boxes(rng, 40, width=479, height=319) for _ in range(2)])
    rois[:, :4] = rng.uniform(-100, 600, (2, 4, 4))
    rois = torch.from_numpy(rois).to(dev)
    build.reset_launch_counts()
    got = roi_align_backward(dout, rois, (20, 30))
    want = roi_align_backward_reference(dout, rois, (20, 30))
    assert build.LAUNCH_COUNTS["roi_align_bwd"] == 1 and got.dtype == dtype
    scale = want.float().abs().max().item()
    tol = 1e-5 * scale if dtype == torch.float32 else 2.0 ** (np.floor(np.log2(scale)) - 7)
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert _same_bits(got, roi_align_backward(dout, rois, (20, 30)))


def _same_bits(a, b):
    return a.dtype == b.dtype and torch.equal(a.view(torch.int8), b.view(torch.int8))


@pytest.mark.parametrize("dtype,c", [(torch.float32, 96), (torch.bfloat16, 96),
                                     (torch.bfloat16, 33)])
def test_roi_align_backward_bits_do_not_depend_on_the_plan(dev, rng, dtype, c):
    """K2b's sums run in a fixed order (roi, bin row, bin column) that no
    tile, chunk or round size changes: every plan, ragged tiles, one-roi
    rounds and a stage that holds one roi's bins included, gives the same
    bits, and K6b with every roi on one level gives K2b's bits there."""
    feats, rois = _pyramid(rng, dev, c, dtype)
    hws = [tuple(f.shape[1:3]) for f in feats]
    dout = torch.from_numpy(rng.randn(2, 50, 7, 7, c).astype(np.float32)).to(dev, dtype)
    rois[:, :3] = torch.tensor([[-900.0, -900.0, -700.0, -800.0], [5.0, 5.0, 5.0, 5.0],
                                [0.0, 0.0, 0.0, 0.0]], device=dev)   # outside, zero size, padding
    want = roi_align_backward(dout, rois, hws[1], 7, 1.0 / 8, 2)
    for tile, chunk, batch, bins in (((16, 16), 32, 16, 56), ((3, 5), 8, 1, 49),
                                     ((1, 1), 128, 32, 200), ((8, 8), 16, 3, 49)):
        plan = roi_bwd_plan(c, dout.element_size(), tile=tile, chunk=chunk, batch=batch,
                            stage_bins=bins)
        assert _same_bits(roi_align_backward(dout, rois, hws[1], 7, 1.0 / 8, 2, plan=plan), want)
    on_one = roi_align_multilevel_backward(dout, rois, torch.ones(2, 50, dtype=torch.int32,
                                                                  device=dev), hws, [4, 8, 16, 32])
    assert _same_bits(on_one[1], want)
    assert not any(on_one[i].any() for i in (0, 2, 3))


def test_roi_align_backward_launcher_refuses_a_plan_not_its_own(dev, rng):
    dout = torch.zeros(1, 2, 7, 7, 64, device=dev)
    rois = torch.zeros(1, 2, 4, device=dev)
    plan = roi_bwd_plan(64, 4)
    with pytest.raises(RuntimeError):              # shared memory not the layout's
        roi_align_backward(dout, rois, (8, 8), plan={**plan, "smem_bytes": plan["smem_bytes"] + 16})
    with pytest.raises(RuntimeError):              # 48 threads: not whole warps
        roi_align_backward(dout, rois, (8, 8), plan={**plan, "threads": 48})
    with pytest.raises(RuntimeError):              # 33 kept rois: over one warp's prefix
        roi_align_backward(dout, rois, (8, 8), plan=roi_bwd_plan(64, 4, batch=33))


def _overlap_args(rng, case):
    """(anchors, gt, valid, inside) of one K4 case: C4 anchors of a 320x480
    bucket, 3 images of 20 gt slots (image 2 with no valid gt), anchor
    copies and a duplicated gt, and per case the cull's boundaries."""
    from frcnn_tpu_torch.ops.anchors import generate_anchors_pre

    anchors, k = generate_anchors_pre(20, 30, 16)
    gt = np.stack([random_boxes(rng, 20, width=479, height=319) for _ in range(3)])
    gt[0, :2] = anchors[[100, 2000]]
    gt[1, 1] = gt[1, 0]
    valid = np.arange(20)[None, :] < np.array([[20], [7], [0]])
    inside = rng.uniform(0, 1, (3, k)) > 0.3
    if case == "touching":           # iw = 0 / ih = 0 exactly against chunk 40's box, iw = 1
        box = anchors[1280:1312][inside[0, 1280:1312]]
        x1, y1 = box[:, :2].min(0)
        x2, y2 = box[:, 2:].max(0)
        gt[0, 2:5] = [[x2 + 1, y1, x2 + 50, y2], [x1, y2 + 1, x2, y2 + 50], [x2, y1, x2 + 50, y2]]
    elif case == "all_outside":      # image 0 has valid gts and no inside anchor
        inside[0] = False
    elif case == "ragged":           # K no multiple of 32, a gt covering everything
        anchors, inside = anchors[:5003], inside[:, :5003]
        gt[1, 3] = [-50.0, -50.0, 600.0, 400.0]
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in (anchors, gt, valid, inside)]


@pytest.mark.parametrize("case", ["mixed", "touching", "all_outside", "ragged"])
def test_overlap_kernel_bit_equal(dev, rng, case):
    args = [a.to(dev) for a in _overlap_args(rng, case)]
    want = anchor_overlap_stats_reference(*args)
    b, k = args[1].shape[0], args[0].shape[0]
    for plan in (None, overlap_plan(b, k, cluster=1, threads=32),
                 overlap_plan(b, k, cluster=4, threads=256), overlap_plan(b, k, cluster=16)):
        build.reset_launch_counts()
        got = anchor_overlap_stats(*args, plan=plan)
        assert build.LAUNCH_COUNTS["overlap"] == 1
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), plan


def test_overlap_launcher_refuses_a_plan_not_its_own(dev, rng):
    args = [a.to(dev) for a in _overlap_args(rng, "mixed")]
    plan = overlap_plan(3, args[0].shape[0], cluster=4)
    for bad in ({**plan, "smem_bytes": plan["smem_bytes"] + 8},     # not the masks' size
                {**plan, "segment": plan["segment"] - 32,           # does not cover K
                 "smem_bytes": plan["smem_bytes"] - 8},
                {**plan, "threads": 48}):                           # not whole warps
        with pytest.raises(RuntimeError):
            anchor_overlap_stats(*args, plan=bad)


def _select_rows(rng, case):
    """(rows, the k to try): the cluster kernel's boundary cases."""
    if case == "mixed":                                  # S = 4000: ties, +-inf, NaN
        x = rng.randn(3, 4000).astype(np.float32)
        x[1] = np.floor(x[1] * 2)
        x[2, ::9], x[2, 1::9], x[2, 2::31] = np.inf, -np.inf, np.nan
        return x, (1, 100, 1999, 4000)
    if case == "runs_across_segments":                   # each run of ties spans several blocks
        x = np.sort(rng.randint(0, 3, (2, 182400)), axis=1)[:, ::-1].astype(np.float32)
        return np.ascontiguousarray(x), (1, 1000, 91200, 182399, 182400)
    if case == "three_values_one_row":                   # B = 1, ties in every block
        return rng.randint(0, 3, (1, 182400)).astype(np.float32), (1000, 100000)
    if case == "ragged":                                 # S no multiple of 4
        x = rng.randint(-3, 4, (3, 21891)).astype(np.float32)
        x[0, ::97] = np.nan
        x[0, 5] = np.frombuffer(np.uint32(0xFFC00000).tobytes(), np.float32)[0]
        x[1, ::2] = -0.0
        return x, (1, 256, 21891)
    if case == "shorter_than_cluster":
        return rng.randint(0, 3, (4, 5)).astype(np.float32), (1, 3, 5)
    if case == "one_value":
        return np.full((2, 50000), 7.0, np.float32), (1, 777, 50000)
    if case == "longer_than_shared_memory":              # the segment's tail stays in device memory
        return np.round(rng.rand(1, 500001) * 512).astype(np.float32), (1, 5000, 500001)
    raise KeyError(case)


@pytest.mark.parametrize("case", ["mixed", "runs_across_segments", "three_values_one_row",
                                  "ragged", "shorter_than_cluster", "one_value",
                                  "longer_than_shared_memory"])
def test_select_kernel_matches_twin(dev, rng, case):
    x, ks = _select_rows(rng, case)
    scores = torch.from_numpy(x).to(dev)
    for k in ks:
        build.reset_launch_counts()
        vals, idx = topk_threshold(scores, k)
        tv, ti = topk_threshold_reference(scores, k)
        assert build.LAUNCH_COUNTS["select"] == 1
        assert torch.equal(idx, ti), (case, k)
        assert torch.equal(vals.view(torch.int32), tv.view(torch.int32)), (case, k)


def test_gradients_flow_through_roi_align_and_fused_block(dev, rng):
    """The kernels' outputs carry a grad_fn and their gradients equal the
    twins' (the K2b kernel against its twin; K3's backward is autograd of
    its twin by construction)."""
    feat = torch.from_numpy(rng.randn(2, 20, 30, 64).astype(np.float32)).to(dev)
    rois = torch.from_numpy(np.stack([random_boxes(rng, 16, width=479, height=319)
                                      for _ in range(2)])).to(dev)
    g = torch.randn(2, 16, 7, 7, 64, device=dev)
    feat.requires_grad_(True)
    out = extract_roi_features(feat, rois)
    assert out.grad_fn is not None
    out.backward(g)
    want = roi_align_backward_reference(g, rois, (20, 30))
    assert (feat.grad - want).abs().max().item() <= 1e-5 * want.abs().max().item()

    block = Bottleneck(256, 64, 1, fused=True).to(dev)
    x = torch.relu(torch.randn(2, 256, 12, 20, device=dev)).bfloat16()
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_(True)
    build.reset_launch_counts()
    y = block(x)
    assert build.LAUNCH_COUNTS["fused_block"] == 1 and y.grad_fn is not None
    gy = torch.randn_like(y)
    y.backward(gy)
    got = [x.grad.float()] + [block.get_parameter(n).grad.float() for n in
                              ("conv1.weight", "conv2.weight", "conv3.weight")]
    block.fused = False
    x2 = x.detach().requires_grad_(True)
    for p in block.parameters():
        p.grad = None
    block(x2).backward(gy)
    want = [x2.grad.float()] + [block.get_parameter(n).grad.float() for n in
                                ("conv1.weight", "conv2.weight", "conv3.weight")]
    for a, b in zip(got, want):
        scale = b.abs().max().item()
        assert scale > 0 and (a - b).abs().max().item() <= 0.05 * scale


def test_wrappers_raise_instead_of_falling_back(dev):
    x = torch.randn(1, 8, 8, 64, device=dev)
    w = [torch.randn(64, 16, device=dev), torch.randn(16, device=dev),
         torch.randn(144, 16, device=dev), torch.randn(16, device=dev),
         torch.randn(16, 64, device=dev), torch.randn(64, device=dev)]
    with pytest.raises(ValueError):
        fused_bottleneck(x.bfloat16(), *w)          # mid 16 has no kernel
    with pytest.raises(ValueError):
        roi_align_forward(torch.randn(1, 4, 4, 8, device=dev, dtype=torch.float16),
                          torch.zeros(1, 1, 4, device=dev))
    with pytest.raises(ValueError):
        roi_align_backward(torch.randn(1, 1, 7, 7, 8, device=dev, dtype=torch.float16),
                           torch.zeros(1, 1, 4, device=dev), (4, 4))
    with pytest.raises(ValueError):                 # 65 gt boxes: over the kernel's 64
        anchor_overlap_stats(torch.zeros(10, 4, device=dev), torch.zeros(1, 65, 4, device=dev),
                             torch.ones(1, 65, dtype=torch.bool, device=dev),
                             torch.ones(1, 10, dtype=torch.bool, device=dev))
    with pytest.raises(ValueError):                 # f64 scores: the kernel takes f32
        topk_threshold(torch.zeros(1, 10, dtype=torch.float64, device=dev), 3)
    feats = [torch.randn(1, 8, 8, 16, device=dev), torch.randn(1, 4, 4, 16, device=dev)]
    rois, levels = torch.zeros(1, 1, 4, device=dev), torch.zeros(1, 1, dtype=torch.int32,
                                                                 device=dev)
    with pytest.raises(ValueError):                 # f16 maps: the kernel takes f32 or bf16
        roi_align_multilevel_forward([f.half() for f in feats], rois, levels, [4, 8])
    with pytest.raises(ValueError):                 # f16 gradient: K6b takes f32 or bf16
        roi_align_multilevel_backward(torch.randn(1, 1, 7, 7, 16, device=dev).half(), rois,
                                      levels, [(8, 8), (4, 4)], [4, 8])
    with pytest.raises(ValueError):                 # 3 x 3 bins against output_size 7
        roi_align_multilevel_backward(torch.randn(1, 1, 3, 3, 16, device=dev), rois, levels,
                                      [(8, 8), (4, 4)], [4, 8])


def _mesh_rank(mesh, jobs):
    """A rank on the card: TF32 off and cuDNN deterministic, as the parent."""
    from frcnn_tpu_torch.parallel.dryrun import run_jobs

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    return run_jobs(mesh, jobs)


def test_two_rank_step_on_one_card_matches_the_unsharded_step(dev, monkeypatch):
    """Two gloo ranks sharing the card (NCCL refuses two ranks on one GPU)
    take ``dryrun_multichip``'s mobile train step on a global batch of 2 and
    serve its detect batch: the replicas bit-equal, the step within rtol
    2e-4 / atol 2e-5 of the unsharded step on the card, the detections
    within 1e-4, the kernels launched in the ranks."""
    from frcnn_tpu_torch.parallel.dryrun import _arm_inputs, run_jobs
    from frcnn_tpu_torch.parallel.mesh import spawn

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    spec, blobs, data, im_info = _arm_inputs("mobile", [], 2)
    jobs = [("train_step", {**spec, "blobs": blobs}),
            ("detect", {**spec, "data": data, "im_info": im_info})]
    ranks = spawn(_mesh_rank, 2, "gloo", jobs, device="cuda", timeout_s=300)
    single = run_jobs(None, jobs, dev)
    (step0, det0), (step1, det1) = ranks
    assert step0["digest"] == step1["digest"] and step0["losses"] == step1["losses"]
    for name, want in single[0]["losses"].items():
        assert abs(step0["losses"][name] - want) <= 2e-4 * max(abs(want), 1.0), name
    for name, want in single[0]["state"].items():
        np.testing.assert_allclose(step0["state"][name], want, rtol=2e-4, atol=2e-5,
                                   err_msg=name)
    valid = np.concatenate([det0["valid"], det1["valid"]])
    np.testing.assert_array_equal(valid, single[1]["valid"])
    np.testing.assert_allclose(np.concatenate([det0["dets"], det1["dets"]]), single[1]["dets"],
                               rtol=1e-5, atol=1e-4)


def test_kernels_refuse_a_tensor_of_another_card(dev, monkeypatch):
    """The launcher runs on the current card's stream: a tensor of another
    card raises before the launch.  With one card, the current device is
    made to read 1."""
    boxes = torch.rand(1, 64, 4, device=dev) * 100
    boxes[..., 2:] += boxes[..., :2]
    valid = torch.ones(1, 64, dtype=torch.bool, device=dev)
    if torch.cuda.device_count() > 1:
        boxes, valid = boxes.to("cuda:1"), valid.to("cuda:1")
        torch.cuda.set_device(0)
    else:
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    build.reset_launch_counts()
    with pytest.raises(ValueError, match="the current card is cuda:"):
        nms_mask_batched(boxes, 0.7, valid)
    assert build.LAUNCH_COUNTS["nms"] == 0


def test_test_net_on_the_card_matches_the_cpu(dev, tmp_path):
    """``test_net`` over a 2-image synthetic devkit (no image codec: the
    pixels come from a reader) in f32 on the card (graphed: K1 twice, K2 once
    a replay, counted by the wrappers at the warm-up and the capture) and on
    a CPU copy of the same model: detections.pkl matched per image and
    class, the per-class APs in [0, 1]."""
    import pickle

    from frcnn_tpu_torch.data.pascal_voc import pascal_voc
    from frcnn_tpu_torch.engine.test import test_net as run_test_net

    reader = chip_smoke.write_voc_devkit(str(tmp_path), {"test": [(320, 480), (320, 440)]},
                                         np.random.RandomState(7))
    cfg = chip_smoke.smoke_config(["TEST.SCALES", "(320,)", "TEST.MAX_SIZE", "480",
                                   "DEVICE.BUCKETS", "((320, 480),)", "TEST.SCORE_THRESH", "0.05"])
    dets = []
    for device in (None, "cpu"):
        imdb = pascal_voc("test", "2007", data_dir=str(tmp_path))
        out = tmp_path / f"out_{device}"
        build.reset_launch_counts()
        aps = run_test_net(chip_smoke.build_seeded(cfg, torch.float32, seed=1), imdb, cfg,
                           str(out), batch=2, reader=reader, device=device)
        assert all(0.0 <= v <= 1.0 for v in aps.values())
        # on the card one batch: its graph's eager warm-up and capture (K1 x2, K2 x1 each)
        assert dict(build.LAUNCH_COUNTS) == ({"nms": 4, "roi_align": 2} if device is None else {})
        with open(out / "detections.pkl", "rb") as f:
            all_boxes = pickle.load(f)
        dets.append([np.concatenate([np.concatenate([c[i], np.full((len(c[i]), 1), float(k))], 1)
                                     for k, c in enumerate(all_boxes)]) for i in range(2)])
    for i, (got, want) in enumerate(zip(*dets)):
        assert len(want) > 0
        chip_smoke.match_dets(want, got, f"image {i}")


def test_im_detect_on_the_card_matches_the_cpu(dev):
    """``im_detect`` with no ``device`` moves the model to the card and runs
    its proposal NMS (K1) and RoIAlign (K2) there; its valid rois, rows of
    per-class scores and boxes, match a CPU copy's one to one."""
    from frcnn_tpu_torch.engine.test import im_detect

    cfg = chip_smoke.smoke_config(["TEST.SCALES", "(320,)", "TEST.MAX_SIZE", "480",
                                   "DEVICE.BUCKETS", "((320, 480),)"])
    im = chip_smoke.synthetic_images(np.random.RandomState(5), [(300, 450)])[0]
    card_model = chip_smoke.build_seeded(cfg, torch.float32, seed=1)
    build.reset_launch_counts()
    got = im_detect(card_model, im, cfg)
    assert dict(build.LAUNCH_COUNTS) == {"nms": 1, "roi_align": 1}
    assert next(card_model.parameters()).device == torch.device("cuda", 0)
    want = im_detect(chip_smoke.build_seeded(cfg, torch.float32, seed=1), im, cfg, device="cpu")
    assert chip_smoke.match_im_detect(want, got, "im_detect, card vs CPU") > 10


def test_clis_run_on_the_card(dev, tmp_path, monkeypatch):
    """``trainval_net`` (2 iterations) and ``test_net --model`` on its
    snapshot, without ``--cpu``: both run on cuda:0.  The default reader
    (cv2) is replaced by the devkit's, so that no image codec is needed, and
    TRAIN.NATIVE_PREP is off: the native prep decodes the files itself, and
    the devkit's are empty placeholders."""
    import pickle

    from frcnn_tpu_torch.data import loader
    from frcnn_tpu_torch.tools import test_net as test_net_cli
    from frcnn_tpu_torch.tools import trainval_net as trainval_net_cli

    monkeypatch.setattr(loader, "read_image", chip_smoke.write_voc_devkit(
        str(tmp_path), {"trainval": [(320, 480)] * 2, "test": [(320, 480)] * 2},
        np.random.RandomState(8)))
    common = ["DATA_DIR", str(tmp_path), "ROOT_DIR", str(tmp_path), "TRAIN.SCALES", "(320,)",
              "TRAIN.MAX_SIZE", "480", "TEST.SCALES", "(320,)", "TEST.MAX_SIZE", "480",
              "DEVICE.BUCKETS", "((320, 480),)", "TRAIN.IMS_PER_BATCH", "2",
              "TRAIN.SNAPSHOT_ITERS", "2", "TEST.SCORE_THRESH", "0.0", "TRAIN.NATIVE_PREP", "False"]
    build.reset_launch_counts()
    solver = trainval_net_cli.main(["--net", "res50", "--imdb", "voc_2007_trainval",
                                    "--imdbval", "", "--iters", "2", "--set", *common])
    assert solver.device == torch.device("cuda", 0)
    assert solver.model.dtype == torch.bfloat16                     # the bf16 trunk
    assert build.LAUNCH_COUNTS["roi_align_bwd"] == 2
    snapshot = tmp_path / "output" / "default" / "voc_2007_trainval" / "default" / "default_iter_2.pth"
    build.reset_launch_counts()
    results = test_net_cli.main(["--net", "res50", "--imdb", "voc_2007_test", "--model",
                                 str(snapshot), "--batch", "2", "--set", *common])
    # one batch of 2: K1 x2 at its graph's eager warm-up and again at the capture
    assert 0.0 <= results["mAP"] <= 1.0 and build.LAUNCH_COUNTS["nms"] == 4
    out = tmp_path / "output" / "default" / "voc_2007_test" / "default"
    with open(out / "detections.pkl", "rb") as f:
        assert sum(len(b) for c in pickle.load(f) for b in c) > 0


def test_nms_kernel_at_the_top_mode_shape(dev, rng):
    """TEST.MODE top's per-class NMS: 168 problems of 5000 rois, unsorted,
    score-threshold validity, cap 100: indices and valid masks equal."""
    from frcnn_tpu_torch.ops.nms import nms_fixed_batched

    boxes = torch.from_numpy(np.stack([random_boxes(rng, 5000, 1216, 800)
                                       for _ in range(168)])).to(dev)
    scores = torch.from_numpy(rng.uniform(0, 1, (168, 5000)).astype(np.float32)).to(dev)
    valid = scores > 0.05
    valid[::21] = False
    build.reset_launch_counts()
    ki, kv = nms_fixed_batched(boxes, scores, 0.3, 100, valid=valid)
    assert build.LAUNCH_COUNTS["nms"] == 1
    with chip_smoke.nms_twin():
        ti, tv = nms_fixed_batched(boxes, scores, 0.3, 100, valid=valid)
    assert torch.equal(ki, ti) and torch.equal(kv, tv) and kv.sum(1).max().item() == 100


# (net, config, launches of the card's detect): VGG-16, MobileNet and the other modes
NEW_PATHS = [("vgg16", (), chip_smoke.E2E_LAUNCHES),
             ("mobile", (), chip_smoke.E2E_LAUNCHES),
             ("mobile", ("POOLING_MODE", "pool"), chip_smoke.E2E_PLAIN_POOL_LAUNCHES),
             ("mobile", ("POOLING_MODE", "crop"), chip_smoke.E2E_PLAIN_POOL_LAUNCHES),
             ("vgg16", ("TEST.MODE", "top", "TEST.RPN_TOP_N", "300"),
              chip_smoke.TOP_SERVE_LAUNCHES)]


@pytest.mark.parametrize("net,extra,launches", NEW_PATHS)
def test_new_nets_and_modes_detect_on_the_card_match_the_cpu(dev, net, extra, launches):
    """``chip_smoke.end_to_end``: f32 ``detect`` at 320x480 on the card and on
    a CPU copy, detections matched one to one, the card's launches counted."""
    chip_smoke.end_to_end(dev, net, extra, launches)


@pytest.mark.parametrize("net,pooling", [("vgg16", "align"), ("mobile", "align"),
                                         ("mobile", "pool"), ("mobile", "crop")])
def test_new_nets_and_modes_train_step_on_the_card_matches_the_cpu(dev, net, pooling):
    """``chip_smoke.train_card_vs_cpu``: one f32 train step at 320x480 on the
    card and on a CPU copy from the same weights and draws (VGG-16's dropout
    uniforms too): losses and the compared updates matched."""
    chip_smoke.train_card_vs_cpu(torch.device("cuda", 0), net, pooling)


def test_proposal_threshold_route_on_the_card(dev, rng):
    """The C4 proposal layer's K5 route (``use_threshold``) on the card at the
    COCO serving shape (45600 anchors, pre-NMS 1000, a NEG_INF tail): K5 once,
    and the rois, scores and valid masks bit-equal to the sorted route's."""
    from frcnn_tpu_torch.models.proposals import proposal_layer_batch
    from frcnn_tpu_torch.ops.anchors import generate_anchors_pre

    anchors = generate_anchors_pre(50, 76, 16, scales=(4, 8, 16, 32))[0]
    k = len(anchors)
    scores = np.round(rng.uniform(0, 1, (8, k)) * 256) / 256               # ties
    deltas = rng.randn(8, k, 4) * 0.1
    im_info = np.array([[800.0, 1216.0, 1.0], [600.0, 912.0, 1.0]] * 4)    # NEG_INF tails
    args = [torch.from_numpy(a.astype(np.float32)).to(dev)
            for a in (scores, deltas, anchors, im_info)]
    kw = dict(pre_nms_top_n=1000, post_nms_top_n=300, nms_thresh=0.7)
    build.reset_launch_counts()
    on = proposal_layer_batch(*args, use_threshold=True, **kw)
    assert build.LAUNCH_COUNTS["select"] == 1 and build.LAUNCH_COUNTS["nms"] == 1
    off = proposal_layer_batch(*args, use_threshold=False, **kw)
    assert build.LAUNCH_COUNTS["select"] == 1
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def test_coco_model_detects_and_trains_on_the_card_matching_the_cpu(dev):
    """``chip_smoke``'s COCO model (res101, 81 classes, four anchor scales):
    f32 ``detect`` at 320x480 matched to a CPU copy, and one f32 train step
    on the card and on a CPU copy (losses and compared updates)."""
    chip_smoke.end_to_end(dev, "res101", chip_smoke.COCO_CONFIG, classes=chip_smoke.COCO_CLASSES)
    chip_smoke.train_card_vs_cpu(torch.device("cuda", 0), "res101",
                                 classes=chip_smoke.COCO_CLASSES)


# ---------------------------------------------------------------------------
# Graphed serving (frcnn_tpu_torch/engine/graphs.py): Detector on the card
# replays one captured CUDA graph per batch shape
# ---------------------------------------------------------------------------

# (net, config, the kernels one replay launches) at 320x480, bf16: the served
# families' launches, where of the FPN's levels only P2's row (28800 anchors)
# is long enough for K5's gate (at 800x1216 P3's too)
GRAPHED = [("res50", (), chip_smoke.SERVE_LAUNCHES),
           ("res50_fpn", (), {**chip_smoke.FPN_LAUNCHES, "select": 1}),
           ("res50_fpn_gn", chip_smoke.GN_CONFIG, {**chip_smoke.FPN_GN_LAUNCHES, "select": 1})]


def _graphed_setup(net, extra, seed=1):
    cfg = chip_smoke.smoke_config(["TEST.SCALES", "(320,)", "TEST.MAX_SIZE", "480",
                                   "DEVICE.BUCKETS", "((320, 480),)", *extra])
    model = chip_smoke.build_seeded(cfg, torch.bfloat16, seed=seed, net=net)
    images = chip_smoke.synthetic_images(np.random.RandomState(5), [(320, 480), (240, 360)] * 2)
    return cfg, model, images


@pytest.mark.parametrize("net,extra,launches", GRAPHED)
def test_graphed_detector_is_bit_equal_to_eager_detect(dev, net, extra, launches):
    """bf16, 4 images at 320x480: ``Detector`` captures one graph, replays it
    for two requests; every image's detections equal eager ``model.detect``'s
    on the same batch bit for bit, and a profiled replay runs the kernels the
    capture counted, as many times."""
    from frcnn_tpu_torch.engine.serve import Detector

    cfg, model, images = _graphed_setup(net, extra)
    det = Detector(model, uint8_input=True)
    build.reset_launch_counts()
    got = [det(images), det(images[::-1])]
    chip_smoke.check_graphed(f"graphed {net}", det, launches, 2,
                             {k: v for k, v in build.LAUNCH_COUNTS.items() if v})
    want = [chip_smoke.eager_detections(model, request, cfg, det.max_per_image, dev)[0]
            for request in (images, images[::-1])]
    for g_req, w_req in zip(got, want):
        for g, w in zip(g_req, w_req):
            np.testing.assert_array_equal(g, w)
    _, groups = chip_smoke.eager_detections(model, images, cfg, det.max_per_image, dev)
    data, info = groups[0][:2]
    ran = chip_smoke.profiled_kernels(lambda: det.detect_blobs(data, info))
    assert ran == launches


def test_copied_weights_reach_the_replay_and_rebound_ones_recapture(dev):
    """A new state copied into the served model in place (``load_state_dict``)
    changes the replayed detections exactly as it changes eager ones, with no
    new capture; a parameter rebound (``.data =``) drops the graphs, and the
    new capture serves what eager detect serves."""
    from frcnn_tpu_torch.engine.serve import Detector

    cfg, model, images = _graphed_setup("res50", ())
    det = Detector(model, uint8_input=True)
    before = det(images)
    model.load_state_dict(chip_smoke.build_seeded(cfg, torch.bfloat16, seed=2).state_dict())
    after = det(images)
    want = chip_smoke.eager_detections(model, images, cfg, det.max_per_image, dev)[0]
    assert sum(det.graphs.captures.values()) == 1
    assert any(b.shape != a.shape or not np.array_equal(b, a) for b, a in zip(before, after))
    for a, w in zip(after, want):
        np.testing.assert_array_equal(a, w)
    weight = model.cls_score.weight
    weight.data = weight.data * 2.0
    rebound = det(images)
    assert sum(det.graphs.captures.values()) == 2
    want = chip_smoke.eager_detections(model, images, cfg, det.max_per_image, dev)[0]
    for r, w in zip(rebound, want):
        np.testing.assert_array_equal(r, w)


def test_a_failed_capture_raises_and_is_not_retried(dev):
    """A host read under capture raises ``RuntimeError`` naming the key and
    the line; the executor keeps and replays nothing, and the card serves on."""
    from frcnn_tpu_torch.engine.graphs import DetectGraphs

    toy = chip_smoke.HostRead(dev)
    graphs = DetectGraphs(toy, 1, dev)
    with pytest.raises(RuntimeError, match=r"key \(2, 4, 6, torch.float32, 1\).*\.item\(\)"):
        graphs(torch.ones(2, 4, 6, 3, device=dev), torch.ones(2, 3, device=dev))
    assert not graphs.captures and not graphs.replays
    x = torch.arange(6.0, device=dev)
    assert (x * 2).sum().item() == 30.0


class _Echo(torch.nn.Module):
    """A ``detect`` that returns copies of its inputs: a replay's outputs
    are then the static inputs as the copy-in left them."""

    def __init__(self):
        super().__init__()
        self.config = None

    def detect(self, data, im_info, max_per_image):
        return data.clone(), im_info.clone()


# the FPN cell's two buckets, and odd shapes whose bytes divide neither the
# chunk nor the alignment of im_info
STAGED = [(8, 800, 1344, np.uint8), (8, 1344, 800, np.uint8), (3, 517, 771, np.uint8),
          (2, 333, 501, np.float32)]


@pytest.mark.parametrize("shape_dtype", STAGED, ids=lambda s: "x".join(map(str, s[:3])))
def test_a_staged_static_input_is_bit_equal_to_its_source(dev, shape_dtype):
    """Pageable numpy batches of one key, two in turn (the capture's copy-in
    and a replay's, the block reused): the static inputs a replay reads
    equal each source and its im_info bit for bit, and both calls were
    staged with no wait."""
    from frcnn_tpu_torch.engine.graphs import DetectGraphs

    *shape, dtype = shape_dtype
    graphs = DetectGraphs(_Echo(), 1, dev)
    rng = np.random.RandomState(7)
    for _ in range(2):
        data = (rng.randint(0, 256, (*shape, 3)) if dtype == np.uint8
                else rng.standard_normal((*shape, 3))).astype(dtype)
        info = rng.uniform(1, 1400, (shape[0], 3)).astype(np.float32)
        got_data, got_info = graphs(data, info)
        assert torch.equal(got_data.cpu(), torch.from_numpy(data))
        assert torch.equal(got_info.cpu(), torch.from_numpy(info))
    key = (*shape, torch.from_numpy(data).dtype, 1)
    assert graphs.staged == {key: 2} and graphs.stage_waits == {}


def test_a_pinned_or_device_batch_is_not_staged(dev):
    from frcnn_tpu_torch.engine.graphs import DetectGraphs

    graphs = DetectGraphs(_Echo(), 1, dev)
    data = torch.randint(0, 256, (2, 40, 60, 3), dtype=torch.uint8)
    info = torch.rand(2, 3)
    for d, i in ((data.pin_memory(), info.pin_memory()), (data.to(dev), info.to(dev)),
                 (data.pin_memory(), info)):
        got_data, got_info = graphs(d, i)
        assert torch.equal(got_data.cpu(), data) and torch.equal(got_info.cpu(), info)
    assert graphs.staged == {} and graphs.replays == {(2, 40, 60, torch.uint8, 1): 3}


def test_two_staged_calls_with_no_readback_return_their_own_detections(dev):
    """Two ``detect_blobs`` calls of one key from numpy, queued behind a
    long kernel with no readback between them: the second call's fill waits
    on the first's event (``stage_waits``), so neither overwrites the other's
    block before its copy to the card; each call's detections equal eager
    detect's on its own batch, and no served call copies from pageable
    memory (a profiled call)."""
    from frcnn_tpu_torch.engine.serve import Detector, iter_bucket_batches

    cfg, model, images = _graphed_setup("res50", ())
    det = Detector(model, uint8_input=True)
    (_, a, a_info), = iter_bucket_batches(images, cfg, keep_uint8=True)
    (_, b, b_info), = iter_bucket_batches(images[::-1], cfg, keep_uint8=True)
    key = (*a.shape[:3], torch.uint8, det.max_per_image)
    for data, info in ((a, a_info), (b, b_info)):            # the capture, a replay
        [t.cpu() for t in det.detect_blobs(data, info)]
    with torch.inference_mode():
        want = [[t.cpu() for t in model.detect(torch.from_numpy(d).to(dev),
                                               torch.from_numpy(i).to(dev), det.max_per_image)]
                for d, i in ((a, a_info), (b, b_info))]
    torch.cuda.synchronize()
    torch.cuda._sleep(500_000_000)                   # the copies queue behind ~0.25 s
    got = [det.detect_blobs(a, a_info), det.detect_blobs(b, b_info)]
    got = [[t.cpu() for t in pair] for pair in got]
    assert det.graphs.stage_waits == {key: 1} and det.graphs.staged == {key: 4}
    for g, w in zip(got, want):
        assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])
    assert not torch.equal(want[0][0], want[1][0])

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        [t.cpu() for t in det.detect_blobs(a, a_info)]
    copies = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and "Memcpy HtoD" in e.name]
    assert copies and not any("Pageable" in name for name in copies), copies


# ---------------------------------------------------------------------------
# The BN epilogue (frcnn_tpu_torch/ops/cuda/bn_epilogue.py): frozen BN, the
# residual and the relu after every unfused bottleneck convolution
# ---------------------------------------------------------------------------

def _frozen_bn(c, dev, g):
    from frcnn_tpu_torch.models.backbones import FrozenBatchNorm

    bn = FrozenBatchNorm(c)
    with torch.no_grad():
        bn.weight.copy_(torch.randn(c, generator=g) * 0.5)
        bn.bias.copy_(torch.randn(c, generator=g) * 0.5)
        bn.running_mean.copy_(torch.randn(c, generator=g) * 0.5)
        bn.running_var.copy_(torch.rand(c, generator=g) * 4 + 1e-3)
    return bn.to(dev)


@pytest.mark.parametrize("c", [64, 256, 1024, 2048])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("form", [None, "residual", "shortcut"])
def test_bn_epilogue_kernel_bit_equal_to_twin(dev, form, relu, c):
    """One launch a call, bit-equal to the twin computed on the card, at a
    ragged small shape (one partial loop step) and one whose threads walk
    several grid steps and a tail."""
    g = torch.Generator().manual_seed(c + 2 * relu + (form is not None))
    bn, bn_ds = _frozen_bn(c, dev, g), _frozen_bn(c, dev, g)
    for b, h, w in ((3, 13, 21), (5, 37, 61)):
        x, other = ((torch.randn(b, c, h, w, generator=g) * 2).to(dev, torch.bfloat16)
                    .contiguous(memory_format=torch.channels_last) for _ in range(2))
        kw = {} if form is None else ({"residual": other} if form == "residual"
                                      else {"shortcut": other, "shortcut_bn": bn_ds})
        build.reset_launch_counts()
        with torch.inference_mode():
            got = bn_epilogue(x, bn, relu, **kw)
            want = bn_epilogue_reference(x, bn, relu, **kw)
        torch.cuda.synchronize()
        assert build.LAUNCH_COUNTS["bn_epilogue"] == 1
        assert got.is_contiguous(memory_format=torch.channels_last) and got.dtype == torch.bfloat16
        assert torch.equal(got, want), float((got.float() - want.float()).abs().max())


def test_bn_epilogue_refuses_what_it_cannot_take(dev):
    """C not a multiple of 8 (the gate admits none: every ResNet width is a
    multiple of 64), f32, a residual of another shape: refused, nothing
    launched."""
    g = torch.Generator().manual_seed(0)
    bn = _frozen_bn(60, dev, g)
    x = torch.randn(2, 60, 5, 7, generator=g).to(dev, torch.bfloat16)
    build.reset_launch_counts()
    with pytest.raises(ValueError):
        bn_epilogue(x.contiguous(memory_format=torch.channels_last), bn)
    bn = _frozen_bn(64, dev, g)
    x = torch.randn(2, 64, 5, 7, generator=g).to(dev).contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError):
        bn_epilogue(x, bn)
    with pytest.raises(ValueError):
        bn_epilogue(x.to(torch.bfloat16), bn, residual=x[:1].to(torch.bfloat16))
    assert build.LAUNCH_COUNTS["bn_epilogue"] == 0


def _drawn_frozen_bn_(model, seed):
    """Every frozen BN of ``model`` given drawn statistics around its own
    (``init_random_`` leaves them the identity, and its scales powers of two,
    where every rounding of the affine is exact): the scale times U(0.8,
    1.2), bias and mean N(0, 0.1), variance U(0.8, 1.25)."""
    from frcnn_tpu_torch.models.backbones import FrozenBatchNorm

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FrozenBatchNorm):
                c = m.weight.numel()
                m.weight.mul_((0.8 + 0.4 * torch.rand(c, generator=g)).to(m.weight.device))
                for t, draw in ((m.bias, torch.randn(c, generator=g) * 0.1),
                                (m.running_mean, torch.randn(c, generator=g) * 0.1),
                                (m.running_var, 0.8 + 0.45 * torch.rand(c, generator=g))):
                    t.copy_(draw)
    return model


def _trunk_and_tail_gaps(model, cfg, images, dev):
    """Eager ``detect`` on ``images``' bucket groups with the epilogue and
    with the module-by-module path (the gate closed): per group, each path's
    relative distance (Frobenius) from the f32 computation of the same
    input, for the C4 features ``detect`` computed (layer3's output) and for
    layer4 on the module path's own crops; and the epilogue's launches."""
    from frcnn_tpu_torch.models.network import preprocess_images
    from frcnn_tpu_torch.ops.cuda import epilogue_grid

    trunk = model.backbone
    seen = []
    hooks = [trunk.layer3.register_forward_hook(lambda m, i, o: seen.append(("c4", o))),
             trunk.layer4.register_forward_hook(lambda m, i, o: seen.append(("tail", i[0], o)))]
    gate, runs, launches = epilogue_grid.gate, {}, {}
    try:
        for way in ("epilogue", "plain"):
            if way == "plain":
                epilogue_grid.gate = lambda x: False
            seen.clear()
            build.reset_launch_counts()
            groups = chip_smoke.eager_detections(model, images, cfg, cfg.TEST.MAX_PER_IMAGE,
                                                 dev)[1]
            launches[way] = build.LAUNCH_COUNTS["bn_epilogue"]
            runs[way] = (groups, list(seen))
            epilogue_grid.gate = gate
    finally:
        epilogue_grid.gate = gate
        for h in hooks:
            h.remove()

    def gap(v, ref):
        return float((v.float() - ref).norm() / ref.norm())

    gaps = []
    with torch.inference_mode():
        for g, (data, *_) in enumerate(runs["plain"][0]):
            c4_e = runs["epilogue"][1][2 * g][1]
            (_, c4_p), (_, crops, tail_p) = runs["plain"][1][2 * g:2 * g + 2]
            x = preprocess_images(data, cfg, torch.bfloat16).permute(0, 3, 1, 2)
            c4_ref = trunk.extract_features(x.float())
            tail_ref = trunk.layer4(crops.float())
            tail_e = trunk.layer4(crops)
            gaps.append({"c4": (gap(c4_e, c4_ref), gap(c4_p, c4_ref)),
                         "tail": (gap(tail_e, tail_ref), gap(tail_p, tail_ref))})
    return gaps, launches


# The epilogue rounds once where the module path rounds three to five times,
# so its result is no farther from the f32 computation than the module
# path's; the margin covers what two bf16 paths through 26 blocks scatter
# about each other.  (Detection rows are not compared: with random heads the
# RPN's scores tie so closely that any rounding moves the proposal NMS.)
EPILOGUE_GAP_RATIO = 1.1


def test_detect_with_the_bn_epilogue_matches_the_plain_path(dev, monkeypatch):
    """res101 C4 at 81 classes and four anchor scales (``chip_smoke``'s COCO
    model, seeded weights, drawn BN statistics, bf16), 4 images in each
    bucket (608x1024 and 1024x608): eager ``detect`` with the epilogue (82
    launches a batch) and with the module-by-module path (none); in each
    bucket the C4 features ``detect`` computed, and layer4 on the same crops,
    at most ``EPILOGUE_GAP_RATIO`` times as far from f32 as the module
    path's (TF32 off)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = chip_smoke.smoke_config([*chip_smoke.COCO_CONFIG, "TEST.SCALES", "(600,)",
                                   "TEST.MAX_SIZE", "1000",
                                   "DEVICE.BUCKETS", "((608, 1024), (1024, 608))"])
    model = _drawn_frozen_bn_(chip_smoke.build_seeded(cfg, torch.bfloat16, seed=7,
                                                      net="res101",
                                                      classes=chip_smoke.COCO_CLASSES), 8).to(dev)
    images = chip_smoke.synthetic_images(np.random.RandomState(9),
                                         [(600, 1000)] * 4 + [(1000, 600)] * 4)
    gaps, launches = _trunk_and_tail_gaps(model, cfg, images, dev)
    assert launches == {"epilogue": 2 * 82, "plain": 0} and len(gaps) == 2
    for bucket in gaps:
        for name, (epilogue, plain) in bucket.items():
            assert 0 < epilogue <= EPILOGUE_GAP_RATIO * plain, (name, epilogue, plain)


# the validation losses under the epilogue against the module path: the RPN's
# anchors are sampled from the step's seeded draws alike, the head's rois come
# through the proposal NMS, where a rounding can flip a near tie
VAL_RPN_RTOL, VAL_HEAD_RTOL = 1e-2, 5e-2


def test_val_losses_take_the_bn_epilogue_within_bf16_rounding(dev, monkeypatch):
    """``SolverWrapper.val_losses`` runs ``train_forward`` under no_grad, so
    on the card in bf16 it takes the epilogue (31 launches for res50 at one
    608x1024 batch of 8, drawn BN statistics), and its losses are the
    module-by-module path's within bf16 rounding; a training step (autograd
    on) launches none."""
    from frcnn_tpu_torch.engine.train import SolverWrapper, filter_roidb
    from frcnn_tpu_torch.ops.cuda import epilogue_grid

    cfg = chip_smoke.train_config()
    model = _drawn_frozen_bn_(chip_smoke.build_seeded(cfg, torch.bfloat16), 3)
    roidb, reader = chip_smoke.synthetic_roidb(np.random.RandomState(4), [(480, 720)] * 8)
    solver = SolverWrapper(model, filter_roidb(roidb, cfg), cfg, reader=reader)
    blobs = solver.data_layer.forward()
    plain_gate = epilogue_grid.gate
    losses = {}
    for way in ("epilogue", "plain"):
        if way == "plain":
            monkeypatch.setattr(epilogue_grid, "gate", lambda x: False)
        build.reset_launch_counts()
        losses[way] = solver.val_losses(blobs)
        assert build.LAUNCH_COUNTS["bn_epilogue"] == (31 if way == "epilogue" else 0)
        monkeypatch.setattr(epilogue_grid, "gate", plain_gate)
    for name, want in losses["plain"].items():
        got = losses["epilogue"][name]
        rtol = VAL_RPN_RTOL if name.startswith("rpn") else VAL_HEAD_RTOL
        assert np.isfinite(got) and abs(got - want) <= rtol * abs(want), (name, got, want)
    build.reset_launch_counts()
    solver.train_step(blobs)
    assert build.LAUNCH_COUNTS["bn_epilogue"] == 0


def test_bn_statistics_copied_in_reach_the_replay(dev):
    """New frozen-BN statistics (the epilogue's norms: the stem, layer2.0,
    layer3, layer4) copied into the served model in place: the next replay,
    with no new capture, serves what eager detect serves with them, and
    not what it served before (nothing folded was kept)."""
    from frcnn_tpu_torch.engine.serve import Detector

    cfg, model, images = _graphed_setup("res50", ())
    det = Detector(model, uint8_input=True)
    before = det(images)
    g = torch.Generator().manual_seed(4)
    state = model.state_dict()
    for name, t in state.items():
        if (name.startswith(("bn1.", "layer2.0.", "layer3.", "layer4."))
                and ("bn" in name or "downsample.1" in name)):
            state[name] = t * (1 + 0.2 * torch.rand(t.shape, generator=g)).to(t.device)
    model.load_state_dict(state)
    after = det(images)
    assert sum(det.graphs.captures.values()) == 1
    want = chip_smoke.eager_detections(model, images, cfg, det.max_per_image, dev)[0]
    assert any(b.shape != a.shape or not np.array_equal(b, a) for b, a in zip(before, after))
    for a, w in zip(after, want):
        np.testing.assert_array_equal(a, w)


# ---------------------------------------------------------------------------
# The FPN epilogue (frcnn_tpu_torch/ops/cuda/fpn_epilogue.py): the bias of the
# FPN's convolutions with the top-down add or the RPN conv's relu
# ---------------------------------------------------------------------------

def _fpn_module_path(x, bias, top, relu):
    """The passes the FPN epilogue replaces, as they ran on the card: cuDNN's
    convolution leaves its bias to a broadcast ``add_``, then the nearest
    upsample cropped and the top-down add, or the relu."""
    import torch.nn.functional as F

    y = x.clone()
    y.add_(bias.to(x.dtype).reshape(1, -1, 1, 1))
    if top is not None:
        y = y + F.interpolate(top, scale_factor=2, mode="nearest")[:, :, :y.shape[2], :y.shape[3]]
    return F.relu(y) if relu else y


def _bf16_cl(shape, dev, g, scale=2.0):
    return ((torch.randn(*shape, generator=g) * scale).to(dev, torch.bfloat16)
            .contiguous(memory_format=torch.channels_last))


def _assert_fpn_epilogue_bits(dev, x, bias, top, relu):
    build.reset_launch_counts()
    with torch.inference_mode():
        got = fpn_epilogue(x, bias, top, relu)
        twin = fpn_epilogue_reference(x, bias, top, relu)
        module = _fpn_module_path(x, bias, top, relu)
    torch.cuda.synchronize()
    assert build.LAUNCH_COUNTS["fpn_epilogue"] == 1
    assert got.is_contiguous(memory_format=torch.channels_last) and got.dtype == torch.bfloat16
    for want in (twin, module):
        assert torch.equal(got.view(torch.int16), want.view(torch.int16)), float(
            (got.float() - want.float()).abs().max())


@pytest.mark.parametrize("bucket", [(800, 1344), (1344, 800)])
def test_fpn_epilogue_bit_equal_at_the_fpn_cell_shapes(dev, bucket):
    """The 13 launches of a res50 FPN serving batch of 8 in each bucket of the
    FPN cell, each in its mode: bit-equal to the twin and to the module
    path (the bias add_, the upsample and top-down add, the relu)."""
    g = torch.Generator().manual_seed(sum(bucket))
    shapes = chip_smoke.fpn_epilogue_shapes(*bucket)
    assert len(shapes) == 13
    for name, mode, xs, ts in shapes:
        bias = (torch.randn(xs[1], generator=g) * 0.5).to(dev)
        x = _bf16_cl(xs, dev, g)
        top = None if ts is None else _bf16_cl(ts, dev, g)
        _assert_fpn_epilogue_bits(dev, x, bias, top, mode == "relu")


@pytest.mark.parametrize("c", [8, 64, 256, 264])
@pytest.mark.parametrize("mode", ["bias", "relu", "merge"])
def test_fpn_epilogue_kernel_bit_equal_at_ragged_shapes(dev, mode, c):
    """Small ragged shapes (a partial grid step; odd levels, where the merge
    crops the upsampled coarser level; a top wider than it needs to be) and
    widths that are not a power of two: bit-equal to the twin and to the
    module path."""
    g = torch.Generator().manual_seed(c + len(mode))
    for b, h, w, th, tw in ((1, 1, 1, 1, 1), (3, 13, 21, 7, 11), (2, 37, 60, 19, 30),
                            (5, 50, 84, 25, 42), (2, 9, 9, 6, 5)):
        bias = (torch.randn(c, generator=g) * 4).to(dev)
        x = _bf16_cl((b, c, h, w), dev, g)
        top = _bf16_cl((b, c, th, tw), dev, g) if mode == "merge" else None
        _assert_fpn_epilogue_bits(dev, x, bias, top, mode == "relu")


def test_fpn_epilogue_refuses_what_it_cannot_take(dev):
    """The top-down add with the relu, C not a multiple of 8, f32, a top not
    half the size of x or of another batch, a bias of another width:
    refused, nothing launched."""
    g = torch.Generator().manual_seed(1)
    bias = torch.randn(64, generator=g).to(dev)
    x, top = _bf16_cl((2, 64, 10, 14), dev, g), _bf16_cl((2, 64, 5, 7), dev, g)
    build.reset_launch_counts()
    with pytest.raises(ValueError):
        fpn_epilogue(x, bias, top, relu=True)
    with pytest.raises(ValueError):
        fpn_epilogue(_bf16_cl((2, 60, 10, 14), dev, g), bias[:60])
    with pytest.raises(ValueError):
        fpn_epilogue(x.float(), bias)
    with pytest.raises(ValueError):
        fpn_epilogue(x, bias, _bf16_cl((2, 64, 4, 7), dev, g))
    with pytest.raises(ValueError):
        fpn_epilogue(x, bias, top[:1])
    with pytest.raises(ValueError):
        fpn_epilogue(x, bias[:32])
    assert build.LAUNCH_COUNTS["fpn_epilogue"] == 0


def test_fpn_biases_copied_in_reach_the_replay(dev):
    """New biases of the neck's convolutions and of the RPN conv (the FPN
    epilogue's) copied into the served model in place: the next replay, with
    no new capture, serves what eager detect serves with them, and not what
    it served before (nothing was folded or kept at capture)."""
    from frcnn_tpu_torch.engine.serve import Detector

    cfg, model, images = _graphed_setup("res50_fpn", ())
    det = Detector(model, uint8_input=True)
    before = det(images)
    g = torch.Generator().manual_seed(6)
    state = model.state_dict()
    for name, t in state.items():
        if name.startswith(("neck.", "rpn_net.")) and name.endswith(".bias"):
            state[name] = (torch.randn(t.shape, generator=g) * 0.5).to(t.device)
    model.load_state_dict(state)
    after = det(images)
    assert sum(det.graphs.captures.values()) == 1
    want = chip_smoke.eager_detections(model, images, cfg, det.max_per_image, dev)[0]
    assert any(b.shape != a.shape or not np.array_equal(b, a) for b, a in zip(before, after))
    for a, w in zip(after, want):
        np.testing.assert_array_equal(a, w)
