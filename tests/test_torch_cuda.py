"""The CUDA kernels against their plain twins on a card (marker ``cuda``).

Run on a machine with an NVIDIA H100 (which has no jax, so without the
suite's conftest):  pytest --noconftest -m cuda tests/test_torch_cuda.py
Here, without a card, every test skips.  ``chip_smoke.py`` runs the same
comparisons at the main path's full shapes."""

import numpy as np
import pytest
import torch

from frcnn_tpu_torch.ops.cuda import build
from frcnn_tpu_torch.ops.cuda.fused_block import bottleneck_reference, fused_bottleneck
from frcnn_tpu_torch.ops.cuda.nms_kernel import nms_mask_batched, nms_mask_reference
from frcnn_tpu_torch.ops.cuda.roi_align_kernel import roi_align_forward, roi_align_reference
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
