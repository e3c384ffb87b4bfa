"""The CUDA kernels against their plain twins on a card (marker ``cuda``),
and gradients through the autograd Functions of K2 and K3.

Run on a machine with an NVIDIA H100 (which has no jax, so without the
suite's conftest):  pytest --noconftest -m cuda tests/test_torch_cuda.py
Here, without a card, every test skips.  ``chip_smoke.py`` runs the same
comparisons at the main path's full shapes."""

import numpy as np
import pytest
import torch

from frcnn_tpu_torch.models.backbones import Bottleneck
from frcnn_tpu_torch.ops.cuda import build
from frcnn_tpu_torch.ops.cuda.fused_block import bottleneck_reference, fused_bottleneck
from frcnn_tpu_torch.ops.cuda.nms_kernel import nms_mask_batched, nms_mask_reference
from frcnn_tpu_torch.ops.cuda.overlap_kernel import (anchor_overlap_stats,
                                                     anchor_overlap_stats_reference)
from frcnn_tpu_torch.ops.cuda.roi_align_kernel import (roi_align_backward,
                                                       roi_align_backward_reference,
                                                       roi_align_forward, roi_align_reference)
from frcnn_tpu_torch.ops.cuda.select_kernel import topk_threshold, topk_threshold_reference
from frcnn_tpu_torch.ops.roi_align import extract_roi_features
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


def test_roi_align_kernel_matches_twin(dev, rng):
    feat = torch.from_numpy(rng.randn(2, 20, 30, 96).astype(np.float32)).to(dev)
    rois = np.stack([random_boxes(rng, 40, width=479, height=319) for _ in range(2)])
    rois[:, :4] = rng.uniform(-100, 600, (2, 4, 4))
    rois = torch.from_numpy(rois).to(dev)
    got, want = roi_align_forward(feat, rois), roi_align_reference(feat, rois)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_fused_block_kernel_matches_twin(dev, rng):
    g = torch.Generator().manual_seed(0)
    for cin, mid, proj in ((64, 64, True), (256, 64, False), (512, 128, False)):
        cout = 4 * mid

        def r(*s, std=1.0):
            return (torch.randn(s, generator=g) * std).to(dev, torch.bfloat16)

        x = torch.relu(r(2, 21, 37, cin))
        w = [r(cin, mid, std=(2 / cin) ** 0.5), r(mid, std=0.1),
             r(9 * mid, mid, std=(2 / (9 * mid)) ** 0.5), r(mid, std=0.1),
             r(mid, cout, std=mid ** -0.5), r(cout, std=0.1)]
        ds = [r(cin, cout, std=cin ** -0.5), r(cout, std=0.1)] if proj else [None, None]
        got = fused_bottleneck(x, *w, *ds).float()
        want = bottleneck_reference(x, w[0], w[1], w[2].reshape(3, 3, mid, mid), *w[3:],
                                    *ds).float()
        scale = want.abs().max().item()
        ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
        assert (got - want).abs().max().item() <= 4 * ulp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_backward_kernel_matches_twin(dev, rng, dtype):
    dout = torch.from_numpy(rng.randn(2, 40, 7, 7, 96).astype(np.float32)).to(dev, dtype)
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


def test_overlap_kernel_bit_equal(dev, rng):
    from frcnn_tpu_torch.ops.anchors import generate_anchors_pre

    anchors, k = generate_anchors_pre(20, 30, 16)
    gt = np.stack([random_boxes(rng, 20, width=479, height=319) for _ in range(3)])
    gt[0, :2] = anchors[[100, 2000]]
    gt[1, 1] = gt[1, 0]
    valid = np.arange(20)[None, :] < np.array([[20], [7], [0]])
    inside = rng.uniform(0, 1, (3, k)) > 0.3
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (anchors, gt, valid, inside)]
    build.reset_launch_counts()
    got = anchor_overlap_stats(*args)
    want = anchor_overlap_stats_reference(*args)
    assert build.LAUNCH_COUNTS["overlap"] == 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("k", [1, 100, 1999, 4000])
def test_select_kernel_matches_twin(dev, rng, k):
    x = rng.randn(3, 4000).astype(np.float32)
    x[1] = np.floor(x[1] * 2)                         # ties
    x[2, ::9], x[2, 1::9], x[2, 2::31] = np.inf, -np.inf, np.nan
    scores = torch.from_numpy(x).to(dev)
    build.reset_launch_counts()
    vals, idx = topk_threshold(scores, k)
    tv, ti = topk_threshold_reference(scores, k)
    assert build.LAUNCH_COUNTS["select"] == 1
    assert torch.equal(idx, ti) and torch.equal(vals.view(torch.int32), tv.view(torch.int32))


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
