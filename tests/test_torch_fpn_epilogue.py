"""The FPN epilogue (``frcnn_tpu_torch/ops/cuda/fpn_epilogue.py``) on the
CPU: its gate (``epilogue_grid.gate``, the BN epilogue's too), which keeps
the CPU, f32 and training on the module-by-module path bit for bit, opens
for either FPN trunk in serving and, open or shut, decides both epilogues
of a res50 FPN forward; its plain twin
against the module path as it ran on the card (the conv's bias as a separate
add, the nearest upsample cropped, the top-down add, the relu), bit for bit
in every mode, odd levels included; the neck's and the RPN's wiring of it,
through the twin; and its launch geometry, with the kernel's decomposition
of a pixel into the coarser level's, at the FPN cell's 13 shapes in both
buckets."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from frcnn_tpu_torch import default_config
from frcnn_tpu_torch.models import fpn
from frcnn_tpu_torch.models import backbones
from frcnn_tpu_torch.models.backbones import cast_conv
from frcnn_tpu_torch.models.network import build_model
from frcnn_tpu_torch.ops.cuda import build, epilogue_grid
from frcnn_tpu_torch.ops.cuda import fpn_epilogue as epi
from frcnn_tpu_torch.ops.cuda.epilogue_grid import epilogue_plan

BF = torch.bfloat16
# C2-C5 of a (104, 150) image: every level after C2 is odd in some direction,
# so the top-down path crops the upsampled coarser level at P3 and P4
FEATS = ((16, 26, 38), (32, 13, 19), (64, 7, 10), (128, 4, 5))


def _bits(t):
    return t.detach().contiguous().view(torch.int16 if t.dtype == BF else torch.int32)


def _assert_bits_equal(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(_bits(got), _bits(want)), float((got.float() - want.float()).abs().max())


def _cl(t):
    return t.contiguous(memory_format=torch.channels_last)


def _seeded_neck(g, out_channels=32):
    neck = fpn.FPNNeck(tuple(c for c, _, _ in FEATS), out_channels)
    with torch.no_grad():
        for m in neck.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                               * (1.0 / m.weight[0].numel()) ** 0.5)
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.5)
    return neck


def _feats(g, dtype, b=2):
    return [_cl((torch.randn(b, c, h, w, generator=g) * 2).to(dtype)) for c, h, w in FEATS]


def _parent_neck(neck, feats):
    """The neck as the module-by-module path wrote it: every lateral conv,
    then the top-down upsample (cropped) and add, then the output convs."""
    laterals = [cast_conv(f, getattr(neck, f"lateral{i}")) for i, f in enumerate(feats, start=2)]
    outs = [laterals[-1]]
    for lat in laterals[-2::-1]:
        up = F.interpolate(outs[0], scale_factor=2, mode="nearest")
        outs.insert(0, lat + up[:, :, :lat.shape[2], :lat.shape[3]])
    ps = [cast_conv(o, getattr(neck, f"output{i}"), padding=1)
          for i, o in enumerate(outs, start=2)]
    return ps + [ps[-1][:, :, ::2, ::2]]


def _card_conv(x, conv, stride=1, padding=0):
    """``cast_conv`` as cuDNN runs it on the card: the convolution without its
    bias, then the bias cast to x's dtype in a separate add_ (a rounding
    between the two, which the CPU's convolution does not make)."""
    y = F.conv2d(x, conv.weight.to(x.dtype), None, stride=stride, padding=padding)
    return y.add_(conv.bias.to(x.dtype).reshape(1, -1, 1, 1))


def _refuse(*args, **kwargs):
    raise AssertionError("the FPN epilogue ran where the gate should keep the module path")


def _as_on_the_card(monkeypatch):
    """The gate as it decides for a bf16 tensor on the card: the real rule,
    handed a stand-in that says it lies there."""
    gate = epilogue_grid.gate
    monkeypatch.setattr(epilogue_grid, "gate",
                        lambda x: gate(SimpleNamespace(is_cuda=True, dtype=x.dtype)))


def _spy(monkeypatch):
    """Records each ``fpn_epilogue`` call as (bias, top, relu), and its result."""
    calls, outs = [], []

    def spy(x, bias, top=None, relu=False):
        calls.append((bias, top, relu))
        outs.append(epi.fpn_epilogue(x, bias, top, relu))
        return outs[-1]

    monkeypatch.setattr(fpn, "fpn_epilogue", spy)
    return calls, outs


@pytest.mark.parametrize("case", ["cpu", "f32", "grad"])
def test_gate_keeps_the_module_path(case, monkeypatch):
    """The CPU, f32, autograd on: each alone shuts the gate, even for a
    tensor that says it lies on the card; the neck and the RPN conv then give
    the module path's bits and launch nothing."""
    dtype = torch.float32 if case == "f32" else BF
    on_card = SimpleNamespace(is_cuda=case != "cpu", dtype=dtype)
    with torch.set_grad_enabled(case == "grad"):
        assert not epilogue_grid.gate(on_card)
    monkeypatch.setattr(fpn, "fpn_epilogue", _refuse)
    g = torch.Generator().manual_seed(3)
    neck, rpn = _seeded_neck(g), torch.nn.Conv2d(32, 32, 3, padding=1)
    feats = _feats(g, dtype)
    build.reset_launch_counts()
    with torch.set_grad_enabled(case == "grad"):
        got, want = neck(feats), _parent_neck(neck, feats)
        for p_got, p_want in zip(got, want):
            _assert_bits_equal(p_got, p_want)
            _assert_bits_equal(fpn.biased_conv(p_got, rpn, padding=1, relu=True),
                               F.relu(cast_conv(p_want, rpn, padding=1)))
    assert build.LAUNCH_COUNTS["fpn_epilogue"] == 0


@pytest.mark.parametrize("net", ["res50_fpn", "res50_fpn_gn"])
def test_gate_opens_for_either_trunk_in_serving(net, monkeypatch):
    """bf16 on the card with autograd off opens the gate whatever the trunk's
    norm: the frozen-BN and the GroupNorm FPN both finish their pyramid and
    RPN in 13 epilogues (3 merges, 5 bias alone, 5 with the relu); with
    autograd on, none."""
    on_card = SimpleNamespace(is_cuda=True, dtype=BF)
    with torch.inference_mode():
        assert epilogue_grid.gate(on_card)
    with torch.no_grad():
        assert epilogue_grid.gate(on_card)
    model = build_model(net, 21, default_config(), dtype=BF)
    _as_on_the_card(monkeypatch)
    calls, _ = _spy(monkeypatch)
    images = torch.from_numpy(
        np.random.RandomState(2).randint(0, 255, (1, 64, 96, 3)).astype(np.float32))
    for grad in (False, True):
        calls.clear()
        with torch.set_grad_enabled(grad):
            model._rpn_all_levels(model._pyramid(images))
        modes = [("merge" if top is not None else "relu" if relu else "bias")
                 for _, top, relu in calls]
        if grad:
            assert modes == []
        else:
            assert sorted(modes) == ["bias"] * 5 + ["merge"] * 3 + ["relu"] * 5


@pytest.mark.parametrize("opened", [True, False])
def test_both_epilogues_follow_the_one_gate(opened, monkeypatch):
    """``epilogue_grid.gate`` alone decides both epilogues.  Forced open on
    the CPU (the wrappers then run their twins), a bf16 res50 FPN forward
    ends every frozen BN of the trunk in a BN epilogue (the stem and three a
    block in all 16 blocks, since K3's gate stays shut off the card) and
    every neck and RPN conv in an FPN epilogue (13); forced shut, neither
    runs."""
    model = build_model("res50_fpn", 21, default_config(), dtype=BF)
    monkeypatch.setattr(epilogue_grid, "gate", lambda x: opened)
    calls = {"bn": 0, "fpn": 0}

    def counted(name, kernel):
        def spy(*args, **kwargs):
            calls[name] += 1
            return kernel(*args, **kwargs)
        return spy

    monkeypatch.setattr(backbones, "bn_epilogue", counted("bn", backbones.bn_epilogue))
    monkeypatch.setattr(fpn, "fpn_epilogue", counted("fpn", fpn.fpn_epilogue))
    images = torch.from_numpy(
        np.random.RandomState(3).randint(0, 255, (1, 64, 96, 3)).astype(np.float32))
    with torch.no_grad():
        model._rpn_all_levels(model._pyramid(images))
    assert calls == ({"bn": 49, "fpn": 13} if opened else {"bn": 0, "fpn": 0})


SHAPES = {"even": ((2, 24, 12, 16), (2, 24, 6, 8)), "odd": ((3, 16, 13, 19), (3, 16, 7, 10))}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("mode", ["bias", "relu", "merge"])
def test_twin_is_bit_equal_to_the_module_path(mode, shape):
    """The twin against the passes it replaces, as they ran on the card: the
    bias cast to bf16 and added in a pass of its own (``add_``, rounded),
    then the nearest upsample of the coarser level cropped to the lateral's
    size and the top-down add (rounded again), or the relu: bit for bit,
    the crop included where a level is odd."""
    g = torch.Generator().manual_seed(len(mode) + len(shape))
    xs, ts = SHAPES[shape]
    x = _cl((torch.randn(xs, generator=g) * 3).to(BF))
    top = _cl((torch.randn(ts, generator=g) * 3).to(BF)) if mode == "merge" else None
    bias = torch.randn(xs[1], generator=g) * 2
    relu = mode == "relu"
    got = epi.fpn_epilogue_reference(x, bias, top, relu)
    want = x.clone().add_(bias.to(BF).reshape(1, -1, 1, 1))
    if top is not None:
        up = F.interpolate(top, scale_factor=2, mode="nearest")
        want = want + up[:, :, :xs[2], :xs[3]]
    if relu:
        want = F.relu(want)
    _assert_bits_equal(got, want)
    assert got.is_contiguous(memory_format=torch.channels_last)
    # the bias's own rounding is not the only one: f32 throughout differs
    once = x.float() + bias[:, None, None]
    if top is not None:
        once = once + up[:, :, :xs[2], :xs[3]].float()
    assert not torch.equal(_bits(got), _bits(once.to(BF)))


def test_twin_arithmetic_element_by_element():
    """The twin's roundings written out in float64: the bias rounded to bf16,
    the bias add rounded to bf16, the top pixel (y // 2, x // 2) added and
    rounded again."""
    g = torch.Generator().manual_seed(9)
    x = (torch.randn(2, 8, 5, 7, generator=g) * 3).to(BF)
    top = (torch.randn(2, 8, 3, 4, generator=g) * 3).to(BF)
    bias = torch.randn(8, generator=g)
    got = epi.fpn_epilogue_reference(x, bias, top).double().numpy()
    xd, td, bd = x.double().numpy(), top.double().numpy(), bias.to(BF).double().numpy()

    def to_bf16(v):
        return torch.from_numpy(np.asarray(v, np.float32)).to(BF).double().item()

    for n, c, y, col in np.ndindex(*x.shape):
        s = to_bf16(np.float32(xd[n, c, y, col] + bd[c]))
        assert got[n, c, y, col] == to_bf16(np.float32(s + td[n, c, y // 2, col // 2]))


def test_cpu_wrapper_runs_the_twin_and_counts_nothing():
    g = torch.Generator().manual_seed(4)
    x = _cl(torch.randn(2, 16, 6, 9, generator=g).to(BF))
    top = _cl(torch.randn(2, 16, 3, 5, generator=g).to(BF))
    bias = torch.randn(16, generator=g)
    build.reset_launch_counts()
    for kw in ({"top": top}, {"relu": True}, {}):
        _assert_bits_equal(epi.fpn_epilogue(x, bias, **kw),
                           epi.fpn_epilogue_reference(x, bias, **kw))
    assert build.LAUNCH_COUNTS["fpn_epilogue"] == 0
    with pytest.raises(ValueError):
        epi.fpn_epilogue(x, bias, top, relu=True)


def test_neck_wires_the_epilogue(monkeypatch):
    """With the gate open (the wrapper then runs its twin on the CPU), the
    neck finishes every conv in the epilogue: P5's lateral with its bias
    alone, P4..P2's merged with the level above them as just made, the four
    output convs with their bias; its pyramid is the module path's as it ran
    on the card (the conv's bias in a separate add), bit for bit, where a
    top-down add or a bias put in the wrong place is off by the signal."""
    g = torch.Generator().manual_seed(5)
    neck = _seeded_neck(g)
    feats = _feats(g, BF)
    monkeypatch.setattr(fpn, "cast_conv", _card_conv)
    with torch.inference_mode():
        want = neck(feats)
        _as_on_the_card(monkeypatch)
        calls, outs = _spy(monkeypatch)
        got = neck(feats)
    laterals = [getattr(neck, f"lateral{i}").bias for i in (5, 4, 3, 2)]
    outputs = [getattr(neck, f"output{i}").bias for i in (2, 3, 4, 5)]
    assert [c[0] for c in calls] == laterals + outputs
    assert [c[2] for c in calls] == [False] * 8
    assert calls[0][1] is None and all(c[1] is None for c in calls[4:])
    # each merge reads the level the launch before it made
    for k in (1, 2, 3):
        assert calls[k][1] is outs[k - 1]
    assert len(got) == 5
    for p_got, p_want in zip(got, want):
        _assert_bits_equal(p_got, p_want)


def test_rpn_wires_the_epilogue(monkeypatch):
    """With the gate open, ``_rpn_all_levels`` ends the RPN conv in the
    epilogue with its relu on each of P2-P6, and its fg probabilities and
    box cells are the module path's as it ran on the card, bit for bit."""
    model = build_model("res50_fpn", 21, default_config(), dtype=BF)
    g = torch.Generator().manual_seed(8)
    with torch.no_grad():
        for t in (model.rpn_net.weight, model.rpn_cls_w, model.rpn_box_w):
            t.copy_(torch.randn(t.shape, generator=g) * 0.05)
        for t in (model.rpn_net.bias, model.rpn_cls_b, model.rpn_box_b):
            t.copy_(torch.randn(t.shape, generator=g) * 0.5)
    pyramid = [_cl(torch.randn(2, 256, h, w, generator=g).to(BF))
               for h, w in ((12, 18), (6, 9), (3, 5), (2, 3), (1, 2))]
    monkeypatch.setattr(fpn, "cast_conv", _card_conv)
    with torch.inference_mode():
        want = model._rpn_all_levels(pyramid)
        _as_on_the_card(monkeypatch)
        calls, _ = _spy(monkeypatch)
        got = model._rpn_all_levels(pyramid)
    assert calls == [(model.rpn_net.bias, None, True)] * 5
    _assert_bits_equal(got[0], want[0])
    for c_got, c_want in zip(got[1], want[1]):
        _assert_bits_equal(c_got, c_want)


@pytest.mark.parametrize("bucket", chip_smoke.FPN_EPILOGUE_BUCKETS)
def test_grid_rule_at_the_fpn_cell_shapes(bucket):
    """At the 13 launches of a res50 FPN serving batch of 8 in each bucket:
    one 512-thread block an SM at most, a grid step that is a whole number
    of pixels, so that every thread's 8 channels (and biases) are the same
    at each of its vectors (emulated over the thread's loop); and, for the
    merges, the kernel's decomposition of an output pixel into (n, y, x) and
    the coarser level's pixel (n, y / 2, x / 2), over every pixel, is the
    twin's nearest upsample cropped."""
    shapes = chip_smoke.fpn_epilogue_shapes(*bucket)
    assert [m for _, m, _, _ in shapes] == ["merge"] * 3 + ["bias"] * 5 + ["relu"] * 5
    for name, mode, (b, c, h, w), top in shapes:
        numel = b * c * h * w
        plan = epilogue_plan(numel, c)
        assert plan["threads"] == 512, name
        assert 1 <= plan["blocks"] <= 132, name
        step = plan["blocks"] * plan["threads"]
        cv = c // 8
        assert step % cv == 0, name
        nvec = numel // 8
        for tid in (0, 1, cv - 1, step - 1):
            assert len({v % cv for v in range(tid, nvec, step)}) == 1, (name, tid)
        assert b * h * w < 2 ** 31, name
        if top is None:
            continue
        _, _, th, tw = top
        assert 2 * th >= h and 2 * tw >= w, name
        p = np.arange(b * h * w, dtype=np.int64)
        col, row_all = p % w, p // w
        row, n = row_all % h, row_all // h
        kernel_top = (n * th + row // 2) * tw + col // 2
        index = torch.arange(b * th * tw).reshape(b, 1, th, tw)
        twin_top = epi.up2(index, h, w).permute(0, 2, 3, 1).reshape(-1).numpy()
        assert np.array_equal(kernel_top, twin_top), name


def test_fpn_cell_levels():
    """The pyramid of the FPN cell's buckets, each stride-2 stage rounding up:
    800x1344 → P2 200x336 .. P6 13x21, and its transpose."""
    for (bh, bw), sizes in (((800, 1344), [(200, 336), (100, 168), (50, 84), (25, 42), (13, 21)]),
                            ((1344, 800), [(336, 200), (168, 100), (84, 50), (42, 25), (21, 13)])):
        shapes = chip_smoke.fpn_epilogue_shapes(bh, bw)
        rpn = [xs[2:] for name, _, xs, _ in shapes if name.startswith("rpn")]
        assert rpn == sizes
        merges = [(xs[2:], ts[2:]) for _, m, xs, ts in shapes if m == "merge"]
        assert merges == list(zip(sizes[:3], sizes[1:4]))
