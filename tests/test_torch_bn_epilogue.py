"""The BN epilogue (``frcnn_tpu_torch/ops/cuda/bn_epilogue.py``) on the CPU:
its gate, which keeps training, GroupNorm, the CPU and f32 on the
module-by-module path bit for bit; its launch geometry at the C4 serving
shapes; its plain twin (bf16 mul/add, f32 body, one rounding) against the
module path (a bf16 rounding after every op); and the blocks' and the
stem's wiring of it, through the twin."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from frcnn_tpu_torch.models import backbones
from frcnn_tpu_torch.models.backbones import Bottleneck, FrozenBatchNorm, ResNetV1
from frcnn_tpu_torch.ops.cuda import bn_epilogue as epi
from frcnn_tpu_torch.ops.cuda import build, epilogue_grid

BF = torch.bfloat16
CASES = ("cpu", "f32", "grad", "group")


def _seeded_norm(bn, g):
    with torch.no_grad():
        bn.weight.copy_(torch.randn(bn.weight.shape, generator=g) * 0.5)
        bn.bias.copy_(torch.randn(bn.bias.shape, generator=g) * 0.5)
        if isinstance(bn, FrozenBatchNorm):
            bn.running_mean.copy_(torch.randn(bn.running_mean.shape, generator=g) * 0.5)
            bn.running_var.copy_(torch.rand(bn.running_var.shape, generator=g) + 0.25)
    return bn


def _seeded(module, g):
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn_conv):
                m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                               * (2.0 / m.weight[0].numel()) ** 0.5)
            elif isinstance(m, (FrozenBatchNorm, backbones.GroupNorm)):
                _seeded_norm(m, g)
    return module


nn_conv = torch.nn.Conv2d


def _input(g, b, c, h, w, dtype):
    x = torch.relu(torch.randn(b, c, h, w, generator=g))
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


def _plain_block(block, x):
    """The module-by-module path as it stood before the epilogue."""
    y = F.relu(block.bn1(backbones.cast_conv(x, block.conv1)))
    y = F.relu(block.bn2(backbones.cast_conv(y, block.conv2, block.stride, 1)))
    y = block.bn3(backbones.cast_conv(y, block.conv3))
    res = x
    if block.downsample is not None:
        res = block.downsample[1](backbones.cast_conv(x, block.downsample[0], block.stride))
    return F.relu(y + res)


def _refuse(*args, **kwargs):
    raise AssertionError("the epilogue ran where the gate should keep the plain path")


@pytest.mark.parametrize("case", CASES)
def test_gate_keeps_the_plain_path(case, monkeypatch):
    """CPU, f32, autograd on: each alone shuts the gate, even on a tensor
    that says it lies on the card; GroupNorm keeps the plain path with the
    gate open.  The block and the stem then give the module path's bits and
    launch nothing."""
    dtype = torch.float32 if case == "f32" else BF
    norm = "group" if case == "group" else "frozen_bn"
    on_card = SimpleNamespace(is_cuda=case != "cpu", dtype=dtype)
    with torch.set_grad_enabled(case == "grad"):
        assert epilogue_grid.gate(on_card) == (case == "group")
    if case == "group":
        monkeypatch.setattr(epilogue_grid, "gate", lambda x: True)
    monkeypatch.setattr(backbones, "bn_epilogue", _refuse)
    g = torch.Generator().manual_seed(7)
    blocks = [_seeded(Bottleneck(64, 32, stride=2, norm=norm), g),
              _seeded(Bottleneck(128, 32, stride=1, norm=norm), g)]
    net = _seeded(ResNetV1(50, fused=False, norm=norm), g)
    build.reset_launch_counts()
    with torch.set_grad_enabled(case == "grad"):
        for block, cin in zip(blocks, (64, 128)):
            x = _input(g, 2, cin, 9, 14, dtype)
            assert torch.equal(block(x), _plain_block(block, x))
        im = _input(g, 2, 3, 20, 28, dtype)
        want = F.max_pool2d(F.relu(net.bn1(backbones.cast_conv(im, net.conv1, 2, 3))), 3, 2, 1)
        assert torch.equal(net._stem(im), want)
    assert build.LAUNCH_COUNTS["bn_epilogue"] == 0


def test_gate_engages_for_bf16_on_the_card_without_autograd():
    on_card = SimpleNamespace(is_cuda=True, dtype=BF)
    with torch.no_grad():
        assert epilogue_grid.gate(on_card)
    with torch.inference_mode():
        assert epilogue_grid.gate(on_card)
    with torch.enable_grad():
        assert not epilogue_grid.gate(on_card)


def _c4_serving_shapes(bh, bw, crops=2400):
    """(name, (B, C, H, W)) of every epilogue input in layer3 and layer4 of
    a ResNet C4 served at a (bh, bw) bucket, 8 images and 300 rois each."""
    h8, w8, h16, w16 = bh // 8, bw // 8, bh // 16, bw // 16
    return [("layer3.0.conv1", (8, 256, h8, w8)), ("layer3.0.conv2", (8, 256, h16, w16)),
            ("layer3.0.conv3+ds", (8, 1024, h16, w16)), ("layer3.k.conv1", (8, 256, h16, w16)),
            ("layer3.k.conv3+res", (8, 1024, h16, w16)), ("layer4.0.conv1", (crops, 512, 7, 7)),
            ("layer4.0.conv2", (crops, 512, 4, 4)), ("layer4.conv3", (crops, 2048, 4, 4))]


@pytest.mark.parametrize("bucket", [(608, 1024), (1024, 608)])
def test_launch_geometry_at_the_c4_serving_shapes(bucket):
    """At every layer3 and layer4 shape of both buckets: one full wave (a
    512-thread block on each of the 132 SMs), and a grid step that is a
    whole number of pixels, so that every thread's 8 channels are the same
    at each of its vectors (emulated over the thread's whole loop)."""
    for name, (b, c, h, w) in _c4_serving_shapes(*bucket):
        numel = b * c * h * w
        plan = epi.epilogue_plan(numel, c)
        assert plan == {"threads": 512, "blocks": 132}, name
        step = plan["blocks"] * plan["threads"]
        assert step % (c // 8) == 0, name
        nvec = numel // 8
        assert nvec >= step * epilogue_grid.UNROLL, name          # every thread has 4 vectors or more
        for tid in (0, 1, c // 8 - 1, step - 1):
            channels = {(v * 8) % c for v in range(tid, nvec, step)}
            assert len(channels) == 1, (name, tid)


@pytest.mark.parametrize("numel,c,blocks", [
    (8 * 64, 64, 1),                  # tiny: one block
    (300 * 1536, 1536, 30),           # 192 vectors a pixel: blocks a multiple of 3
    (2400 * 16 * 1544, 1544, 193),    # 193 vectors a pixel (a prime): 193 blocks
    (10 ** 6 * 24, 24, 132),          # 3 vectors a pixel, one full wave
    (8 * 304 * 512 * 64, 64, 132),    # the stem at 608x1024
])
def test_launch_geometry_rounds_to_whole_pixels(numel, c, blocks):
    plan = epi.epilogue_plan(numel, c)
    assert plan["blocks"] == blocks
    assert plan["blocks"] * plan["threads"] % (c // 8) == 0


def test_launch_geometry_refuses_channels_off_the_vector():
    with pytest.raises(ValueError):
        epi.epilogue_plan(12 * 100, 12)


def _bf16_ulp(v):
    """The bf16 unit in the last place of |v| (8 significant bits)."""
    v = v.abs().float().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(v)) - 7)


# residual form -> the module path's bf16 roundings: x * mul, + add, then
# + residual, then bn_ds's two and the sum
ROUNDINGS = {None: 2, "residual": 3, "shortcut": 5}


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("form", [None, "residual", "shortcut"])
def test_twin_is_the_module_path_up_to_bf16_rounding(form, relu):
    """The twin rounds once where the module path rounds after every op:
    they differ by at most half a bf16 ulp a rounding, the twin's included,
    of the largest value either path holds for the element: 1.5 ulps with
    no middle term, 2 with the residual, 3 with the shortcut's own BN.
    They do differ: the twin is not the module path."""
    g = torch.Generator().manual_seed(11 + (form is None) + 2 * relu)
    c = 64
    bn, bn_ds = (_seeded_norm(FrozenBatchNorm(c), g) for _ in range(2))
    x, other = (torch.randn(4, c, 6, 10, generator=g).to(BF) * 3 for _ in range(2))
    kw = {} if form is None else ({"residual": other} if form == "residual"
                                  else {"shortcut": other, "shortcut_bn": bn_ds})
    with torch.no_grad():
        got = epi.bn_epilogue_reference(x, bn, relu, **kw)
        mul, add = bn.folded(BF)
        scaled = x * mul[:, None, None]
        y = scaled + add[:, None, None]
        held = [scaled, y]
        if form == "residual":
            held.append(other)
            y = y + other
        elif form == "shortcut":
            mul_d, add_d = bn_ds.folded(BF)
            scaled_d = other * mul_d[:, None, None]
            res = scaled_d + add_d[:, None, None]
            held += [scaled_d, res]
            y = y + res
        held.append(y)
        want = F.relu(y) if relu else y
    assert got.dtype == BF and got.shape == want.shape
    largest = torch.stack([t.float().abs() for t in held]).amax(0)
    bound = (ROUNDINGS[form] + 1) / 2 * _bf16_ulp(largest)
    diff = (got.float() - want.float()).abs()
    assert (diff <= bound).all(), float((diff / bound).max())
    assert (diff > 0).any()


def test_twin_folds_each_norm_once_to_bf16_and_rounds_once():
    """The twin's arithmetic, element by element in float64 over the f32
    fold: bf16 (mul, add), the f32 body, one rounding to bf16."""
    g = torch.Generator().manual_seed(5)
    bn = _seeded_norm(FrozenBatchNorm(16), g)
    x = torch.randn(2, 16, 3, 5, generator=g).to(BF)
    res = torch.randn(2, 16, 3, 5, generator=g).to(BF)
    got = epi.bn_epilogue_reference(x, bn, True, residual=res)
    inv = torch.sqrt(bn.running_var + bn.eps)
    mul = (bn.weight / inv).to(BF).float()
    add = (bn.bias - bn.running_mean * bn.weight / inv).to(BF).float()
    body = (x.float() * mul[:, None, None]).float() + add[:, None, None]
    want = torch.relu(body + res.float()).to(BF)
    assert torch.equal(got, want)


def test_cpu_wrapper_runs_the_twin_and_counts_nothing():
    g = torch.Generator().manual_seed(3)
    bn, bn_ds = (_seeded_norm(FrozenBatchNorm(32), g) for _ in range(2))
    x, s = (_input(g, 2, 32, 5, 7, BF) for _ in range(2))
    build.reset_launch_counts()
    got = epi.bn_epilogue(x, bn, shortcut=s, shortcut_bn=bn_ds)
    assert torch.equal(got, epi.bn_epilogue_reference(x, bn, True, shortcut=s, shortcut_bn=bn_ds))
    assert build.LAUNCH_COUNTS["bn_epilogue"] == 0
    with pytest.raises(ValueError):
        epi.bn_epilogue(x, bn, residual=x, shortcut=s, shortcut_bn=bn_ds)


@pytest.mark.parametrize("cin,channels,stride", [(64, 16, 2), (64, 16, 1), (128, 32, 2)])
def test_blocks_and_stem_wire_the_epilogue(cin, channels, stride, monkeypatch):
    """With the gate forced open on the CPU (the wrapper then runs its twin):
    three epilogues a block, bn1/bn2 with relu after conv1/conv2, bn3 with
    the identity residual or the projection shortcut through its own BN; one
    in the stem; outputs within bf16 rounding of the module path (errors
    carried through the next convolutions), where a norm or a residual put
    in the wrong place is off by the whole signal."""
    calls = []

    def spy(x, bn, relu=True, residual=None, shortcut=None, shortcut_bn=None):
        calls.append((bn, relu, residual is not None, shortcut_bn))
        return epi.bn_epilogue(x, bn, relu, residual, shortcut, shortcut_bn)

    g = torch.Generator().manual_seed(cin + stride)
    block = _seeded(Bottleneck(cin, channels, stride=stride), g)
    net = _seeded(ResNetV1(50, fused=False), g)
    x = _input(g, 2, cin, 10, 14, BF)
    im = _input(g, 2, 3, 24, 30, BF) * 4
    with torch.no_grad():
        want_block = _plain_block(block, x)
        want_stem = net._stem(im)
        monkeypatch.setattr(epilogue_grid, "gate", lambda t: True)
        monkeypatch.setattr(backbones, "bn_epilogue", spy)
        got_block = block(x)
        got_stem = net._stem(im)
    shortcut_bn = block.downsample[1] if block.downsample is not None else None
    assert calls == [(block.bn1, True, False, None), (block.bn2, True, False, None),
                     (block.bn3, True, block.downsample is None, shortcut_bn),
                     (net.bn1, True, False, None)]
    for got, want in ((got_block, want_block), (got_stem, want_stem)):
        assert got.shape == want.shape and got.dtype == BF
        assert got.is_contiguous(memory_format=torch.channels_last)
        err = (got.float() - want.float()).abs()
        scale = want.float().abs().max()
        assert float(err.max()) <= 0.03 * float(scale)
        assert float(err.mean()) <= 0.003 * float(scale)
    assert not np.array_equal(got_block.float().numpy(), want_block.float().numpy())
