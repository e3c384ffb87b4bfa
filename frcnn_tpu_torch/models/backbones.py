"""Backbones (``frcnn_tpu/models/backbones.py``): VGG-16, ResNet-v1
(50/101/152) and MobileNet-v1, each a stride-16 trunk (``extract_features``)
and a per-RoI tail (``head_to_tail``); the ResNet also gives the C2-C5
stages of the FPN model (``frcnn_tpu/models/fpn.py::_ResNetStages``).

Parameter names and layouts are torchvision's (``conv1``, ``bn1``,
``layer1.0.conv1.weight``, ``layer1.0.downsample.0.weight``, ...), so a
lineage ``.pth`` loads directly.  The norm is ``make_norm``'s: frozen BN
(y = x * mul + add with (mul, add) folded from the stored statistics, in the
compute dtype), or, for the from-scratch FPN (``res*_fpn_gn``), GroupNorm of
32 groups under the same names, trained.  Served in bf16 on the card, a
ResNet's frozen BNs outside K3 (the stem, the strided and the wide blocks)
run inside the BN epilogue kernel with their residual and relu
(``ops/cuda/bn_epilogue.py``), one launch after each convolution.

Activations are NCHW tensors in ``channels_last`` memory: a permute to NHWC
is then free, which is the layout the fused bottleneck kernel (K3) and the
RoIAlign kernel (K2) read.  Parameters stay float32; each convolution casts
its weight to the input's dtype (bf16 on the card), as the JAX modules do.

The stem is the plain 7x7/s2 conv → norm → relu → 3x3/s2 maxpool; the JAX
package's space-to-depth stem computes the same thing for a TPU's lanes.

Training: frozen BN is buffers, never parameters; ``freeze_fixed_blocks``
sets ``requires_grad=False`` on the stem and layer1..layer``FIXED_BLOCKS``
(``frozen_param`` of the JAX ResNetV1 and FasterRCNNFPN), so autograd neither
computes their gradients nor runs the backward below the first trainable
layer.  VGG-16 freezes its first two conv blocks and MobileNet-v1 ``conv0``
and ``sep1..sep{FIXED_LAYERS - 1}`` the same way (their ``frozen_param``).

VGG-16 keeps torchvision's names (``features.{0,2,...,28}``, ``classifier.0``
(fc6), ``classifier.3`` (fc7)); MobileNet-v1, which has no torchvision
layout in the lineage, the JAX tree's (``conv0``, ``bn0``,
``sep{i}.{depthwise,bn_dw,pointwise,bn_pw}``).

``init_random_`` (in ``models/network.py``) draws every conv He-normal; each
backbone's ``init_random_`` then sets what keeps its activations O(1) at full
size with random weights.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from frcnn_tpu_torch.ops.constants import device_constant
from frcnn_tpu_torch.ops.cuda.bn_epilogue import bn_epilogue
from frcnn_tpu_torch.ops.cuda.fused_block import FusedBottleneckFunction

_RESNET_DEPTHS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}

# Bottleneck widths at or below this run as the fused kernel (layer1 and
# layer2 of a ResNet), as FUSED_MAX_CH in the JAX package.
FUSED_MAX_CH = 128


class FrozenBatchNorm(nn.Module):
    """BatchNorm with frozen statistics and affine, stored as buffers under
    torchvision's names."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def folded(self, dtype):
        """(mul, add) with y = x * mul + add, computed in f32 then cast."""
        inv = torch.sqrt(self.running_var + self.eps)
        mul = self.weight / inv
        add = self.bias - self.running_mean * self.weight / inv
        return mul.to(dtype), add.to(dtype)

    def forward(self, x):
        mul, add = self.folded(x.dtype)
        return x * mul[:, None, None] + add[:, None, None]


class GroupNorm(nn.Module):
    """GroupNorm as flax's ``nn.GroupNorm`` (the JAX package's
    ``make_norm("group")``): 32 groups, epsilon 1e-6, scale and bias trained
    in f32; the statistics and the affine in f32 (or wider), the result cast
    to the input's dtype.  The input is cast and made NCHW in one pass (the CUDA
    kernel of ``F.group_norm`` reads NCHW), the output cast back into
    channels-last memory, the trunk's layout."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.groups = groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        wide = torch.promote_types(x.dtype, torch.float32)
        y = F.group_norm(x.to(wide, memory_format=torch.contiguous_format),
                         self.groups, self.weight.to(wide), self.bias.to(wide), self.eps)
        return y.to(x.dtype, memory_format=torch.channels_last)


def make_norm(norm: str):
    """The norm module of a ResNet: "frozen_bn" (eval-mode BN, never trained;
    the pretrained path) or "group" (GroupNorm-32, trained; from scratch)."""
    if norm == "frozen_bn":
        return FrozenBatchNorm
    if norm == "group":
        return GroupNorm
    raise ValueError(f"unknown norm: {norm}")


def _use_epilogue(norm: str, x) -> bool:
    """Whether a frozen BN after a convolution (with its residual and relu)
    runs as the BN epilogue kernel: bf16 on the card with autograd off (the
    kernel has no backward), which is serving and also the validation losses
    (``SolverWrapper.val_losses`` runs ``train_forward`` under no_grad).
    Training steps, GroupNorm, the CPU and f32 keep the module-by-module
    path."""
    return (norm == "frozen_bn" and x.is_cuda and x.dtype == torch.bfloat16
            and not torch.is_grad_enabled())


def _conv(x, conv: nn.Conv2d, stride: int = 1, padding: int = 0):
    """``conv`` applied in the dtype of ``x`` (weights cast per call)."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, conv.weight.to(x.dtype), bias, stride=stride, padding=padding)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, channels: int, stride: int = 1, fused: bool = False,
                 norm: str = "frozen_bn"):
        super().__init__()
        cout = channels * self.expansion
        bn = make_norm(norm)
        self.stride = stride
        self.fused = fused
        self.norm = norm
        self.conv1 = nn.Conv2d(cin, channels, 1, bias=False)
        self.bn1 = bn(channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, stride=stride, padding=1, bias=False)
        self.bn2 = bn(channels)
        self.conv3 = nn.Conv2d(channels, cout, 1, bias=False)
        self.bn3 = bn(cout)
        self.downsample = None
        if cin != cout or stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride=stride, bias=False), bn(cout))

    def _use_fused(self, x) -> bool:
        # The TPU gate also required a row tile that fits VMEM
        # (pick_row_tile); the CUDA kernel tiles any H and W, so that
        # condition is gone.  K3 folds a frozen BN into its weights: a
        # GroupNorm block never takes it.
        return (self.fused and self.norm == "frozen_bn" and self.stride == 1 and x.is_cuda
                and x.dtype == torch.bfloat16)

    def forward(self, x):
        if self._use_fused(x):
            return self._fused_forward(x)
        if _use_epilogue(self.norm, x):
            return self._epilogue_forward(x)
        y = F.relu(self.bn1(_conv(x, self.conv1)))
        y = F.relu(self.bn2(_conv(y, self.conv2, self.stride, 1)))
        y = self.bn3(_conv(y, self.conv3))
        res = x
        if self.downsample is not None:
            res = self.downsample[1](_conv(x, self.downsample[0], self.stride))
        return F.relu(y + res)

    def _epilogue_forward(self, x):
        """The plain path's convolutions, each followed by one BN epilogue
        launch: bn1 + relu, bn2 + relu, and bn3 + the residual (or the
        projection shortcut's conv through its own BN) + relu."""
        y = bn_epilogue(_conv(x, self.conv1), self.bn1)
        y = bn_epilogue(_conv(y, self.conv2, self.stride, 1), self.bn2)
        y = _conv(y, self.conv3)
        if self.downsample is None:
            return bn_epilogue(y, self.bn3, residual=x)
        return bn_epilogue(y, self.bn3, shortcut=_conv(x, self.downsample[0], self.stride),
                           shortcut_bn=self.downsample[1])

    def _fused_forward(self, x):
        """The same block as one K3 launch: frozen-BN affines folded into the
        weights (bn(conv(v)) == v @ (W * mul) + add), as the JAX fused path."""
        dt = x.dtype
        mid = self.conv1.out_channels
        m1, a1 = self.bn1.folded(dt)
        m2, a2 = self.bn2.folded(dt)
        m3, a3 = self.bn3.folded(dt)
        w1 = self.conv1.weight[:, :, 0, 0].t().to(dt) * m1
        w2 = (self.conv2.weight.permute(2, 3, 1, 0).to(dt) * m2).reshape(9 * mid, mid)
        w3 = self.conv3.weight[:, :, 0, 0].t().to(dt) * m3
        wds = bds = None
        if self.downsample is not None:
            md, bds = self.downsample[1].folded(dt)
            wds = self.downsample[0].weight[:, :, 0, 0].t().to(dt) * md
        out = FusedBottleneckFunction.apply(x.permute(0, 2, 3, 1), w1, a1, w2, a2, w3, a3,
                                            wds, bds)
        return out.permute(0, 3, 1, 2)


def _layer(cin: int, channels: int, blocks: int, stride: int, fused: bool, norm: str):
    layers = [Bottleneck(cin, channels, stride, fused, norm)]
    layers += [Bottleneck(channels * 4, channels, 1, fused, norm) for _ in range(blocks - 1)]
    return nn.Sequential(*layers)


class ResNetV1(nn.Module):
    """conv1 → layer3 is the C4 trunk (stride 16, 1024 channels); the tail
    is layer4 (stride 2 inside the 7x7 crop) + global average pool.  The FPN
    model runs all four layers on the full map (``stages``)."""

    feat_channels = 1024
    tail_dim = 2048
    tail_dropout = 0

    def __init__(self, depth: int = 50, fused: bool = True, norm: str = "frozen_bn"):
        super().__init__()
        blocks = _RESNET_DEPTHS[depth]
        self.norm = norm
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = make_norm(norm)(64)
        cin = 64
        for li, (n, ch, stride) in enumerate(zip(blocks, (64, 128, 256, 512), (1, 2, 2, 2)),
                                             start=1):
            # the tail (layer4) runs on 7x7 crops and is never fused
            use_fused = fused and li <= 3 and ch <= FUSED_MAX_CH
            setattr(self, f"layer{li}", _layer(cin, ch, n, stride, use_fused, norm))
            cin = ch * 4

    def _stem(self, x):
        x = _conv(x, self.conv1, 2, 3)
        if _use_epilogue(self.norm, x):
            x = bn_epilogue(x, self.bn1)
        else:
            x = F.relu(self.bn1(x))
        return F.max_pool2d(x, 3, 2, 1)

    def extract_features(self, x):
        """x (B, 3, H, W) in the compute dtype → (B, 1024, H/16, W/16)."""
        return self.layer3(self.layer2(self.layer1(self._stem(x))))

    def stages(self, x):
        """x (B, 3, H, W) in the compute dtype → [C2, C3, C4, C5] (strides
        4, 8, 16, 32; 256, 512, 1024, 2048 channels)."""
        outs = [self.layer1(self._stem(x))]
        for layer in (self.layer2, self.layer3, self.layer4):
            outs.append(layer(outs[-1]))
        return outs

    def head_to_tail(self, pooled, drop=None):
        """pooled (N, 1024, p, p) → (N, 2048).  The tail has no dropout:
        ``drop`` is always None."""
        return self.layer4(pooled).mean(dim=(2, 3))

    def init_random_(self, normal_) -> None:
        """``init_random_``'s part past the He-normal convs: the last norm of
        each residual branch scaled to 0.5, and the stem's to 1/64 (raw pixels
        are O(100))."""
        for name, module in self.named_modules():
            if name.endswith("bn3") or name.endswith("downsample.1"):
                module.weight.fill_(0.5)
        self.bn1.weight.fill_(1.0 / 64.0)

    def freeze_fixed_blocks(self, fixed_blocks: int) -> None:
        """layer1..layer{fixed_blocks} stop training (cfg.RESNET.FIXED_BLOCKS),
        GroupNorm included, and so does the stem (conv1, bn1): always under
        frozen BN, which assumes pretrained weights, and under GroupNorm only
        when fixed_blocks >= 1, so that a from-scratch run at 0 freezes
        nothing.  Frozen BN is buffers: it never trains."""
        frozen = [getattr(self, f"layer{i}") for i in range(1, fixed_blocks + 1)]
        if self.norm == "frozen_bn" or fixed_blocks >= 1:
            frozen += [self.conv1, self.bn1]
        for module in frozen:
            module.requires_grad_(False)


def dropout(x, uniform, rate: float = 0.5):
    """flax ``nn.Dropout(rate)`` with its uniform draws given: an element is
    kept where its uniform is below 1 - rate (``bernoulli(keep)``) and
    scaled by 1 / (1 - rate), else zeroed."""
    keep = 1.0 - rate
    return torch.where(uniform < keep, x / keep, 0.0)


# channels of the 13 convs, "M" a 2x2 max-pool; the last pool is dropped
_VGG_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512)


class VGG16(nn.Module):
    """VGG-16 (the lineage's ``lib/nets/vgg16.py``): torchvision's
    ``features`` without the last max-pool (13 3x3 convs with relu, 4 2x2
    max-pools that floor odd sizes as flax's VALID pool: stride 16, 512
    channels), and ``classifier`` without fc8: the 7x7 crop flattened in C, H,
    W order (torchvision's; the JAX tail flattens H, W, C and its converter
    permutes fc6), fc6 and fc7, each with relu and, in training, dropout p
    0.5 on the uniforms ``drop`` (``dropout``).  conv1_* and conv2_*
    (``features.0/2/5/7``) are frozen.  Only the parameterized layers are
    modules, under their torchvision indices."""

    feat_channels = 512
    norm = "none"
    tail_dropout = 2       # dropout layers in the tail: fc6's and fc7's

    def __init__(self, tail_dim: int = 4096):
        super().__init__()
        self.tail_dim = tail_dim
        self.features = nn.ModuleDict()
        self._pool_after = set()
        cin, idx = 3, 0
        for v in _VGG_CFG:
            if v == "M":
                self._pool_after.add(idx - 2)
                idx += 1
            else:
                self.features[str(idx)] = nn.Conv2d(cin, v, 3, padding=1)
                cin, idx = v, idx + 2           # the conv, then its relu
        self.classifier = nn.ModuleDict({"0": nn.Linear(512 * 7 * 7, tail_dim),
                                         "3": nn.Linear(tail_dim, tail_dim)})
        for idx in ("0", "2", "5", "7"):        # conv1_1 .. conv2_2
            self.features[idx].requires_grad_(False)

    def extract_features(self, x):
        """x (B, 3, H, W) in the compute dtype → (B, 512, H/16, W/16)."""
        for idx, conv in self.features.items():
            x = F.relu(_conv(x, conv, padding=1))
            if int(idx) in self._pool_after:
                x = F.max_pool2d(x, 2, 2)
        return x

    def head_to_tail(self, pooled, drop=None):
        """pooled (N, 512, 7, 7) → (N, tail_dim); ``drop`` (2, N, tail_dim):
        the uniforms of fc6's and fc7's dropout (training), or None."""
        x = pooled.flatten(1)
        for i, fc in enumerate(self.classifier.values()):
            x = F.relu(F.linear(x, fc.weight.to(x.dtype), fc.bias.to(x.dtype)))
            if drop is not None:
                x = dropout(x, drop[i])
        return x

    def init_random_(self, normal_) -> None:
        """``init_random_``'s part past the He-normal convs: conv1_1 scaled
        by 1/64 (raw pixels are O(100)), fc6 and fc7 N(0, 2/fan_in), biases
        zero."""
        self.features["0"].weight.mul_(1.0 / 64.0)
        for fc in self.classifier.values():
            normal_(fc.weight, math.sqrt(2.0 / fc.in_features))
            fc.bias.zero_()


# (channels, stride) of the 13 separable layers after the stem: sep1-sep11
# are the trunk (stride 16), sep12-13 the tail at stride 1 on the crop
_MOBILENET_CFG = ((64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
                  (512, 1), (512, 1), (512, 1), (512, 1), (512, 1),
                  (1024, 2), (1024, 1))


def _mch(c: int, dm: float) -> int:
    return max(int(c * dm), 8)


def _same_pad(x, stride: int, k: int = 3):
    """x padded as XLA's "SAME" (flax ``padding="SAME"``) pads a k x k
    window at ``stride``: out = ceil(n / stride) a side, and the total pad
    max((out - 1) * stride + k - n, 0) split total // 2 before, the rest
    after.  At stride 2 an even side gets nothing before and one after,
    where a symmetric ``padding=1`` would shift every output a pixel."""
    pads = []
    for n in (x.shape[3], x.shape[2]):              # F.pad lists the last dim first
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class SeparableConv(nn.Module):
    """Depthwise 3x3 (SAME, ``stride``) → frozen BN → relu6 → pointwise 1x1
    → frozen BN → relu6, no conv biases."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.stride = stride
        self.depthwise = nn.Conv2d(cin, cin, 3, stride=stride, groups=cin, bias=False)
        self.bn_dw = FrozenBatchNorm(cin)
        self.pointwise = nn.Conv2d(cin, cout, 1, bias=False)
        self.bn_pw = FrozenBatchNorm(cout)

    def forward(self, x):
        w = self.depthwise.weight.to(x.dtype)
        x = F.conv2d(_same_pad(x, self.stride), w, stride=self.stride, groups=x.shape[1])
        x = F.relu6(self.bn_dw(x))
        return F.relu6(self.bn_pw(_conv(x, self.pointwise)))


class MobileNetV1(nn.Module):
    """MobileNet-v1 (the lineage's ``lib/nets/mobilenet_v1.py``) at width
    ``depth_multiplier``: the trunk is ``conv0`` (3x3/s2 SAME) → ``bn0`` →
    relu6 → ``sep1``..``sep11`` (stride 16, 512 x dm channels); the tail is
    ``sep12``, ``sep13`` at stride 1 on the crop, then the spatial mean
    (1024 x dm).  Every BN is frozen (buffers); ``freeze_fixed_layers``
    freezes ``conv0`` and ``sep1..sep{FIXED_LAYERS - 1}``."""

    norm = "frozen_bn"
    tail_dropout = 0

    def __init__(self, depth_multiplier: float = 1.0):
        super().__init__()
        dm = depth_multiplier
        self.feat_channels = _mch(512, dm)
        self.tail_dim = _mch(1024, dm)
        cin = _mch(32, dm)
        self.conv0 = nn.Conv2d(3, cin, 3, stride=2, bias=False)
        self.bn0 = FrozenBatchNorm(cin)
        for i, (c, s) in enumerate(_MOBILENET_CFG, start=1):
            setattr(self, f"sep{i}", SeparableConv(cin, _mch(c, dm), s if i <= 11 else 1))
            cin = _mch(c, dm)

    def extract_features(self, x):
        """x (B, 3, H, W) in the compute dtype → (B, 512 x dm, ~H/16, ~W/16)."""
        x = F.relu6(self.bn0(_conv(_same_pad(x, 2), self.conv0, 2)))
        for i in range(1, 12):
            x = getattr(self, f"sep{i}")(x)
        return x

    def head_to_tail(self, pooled, drop=None):
        """pooled (N, 512 x dm, p, p) → (N, 1024 x dm).  The tail has no
        dropout: ``drop`` is always None."""
        return self.sep13(self.sep12(pooled)).mean(dim=(2, 3))

    def init_random_(self, normal_) -> None:
        """``init_random_``'s part past the He-normal convs: ``bn0`` scaled to
        1/64 (raw pixels are O(100))."""
        self.bn0.weight.fill_(1.0 / 64.0)

    def freeze_fixed_layers(self, fixed_layers: int) -> None:
        """cfg.MOBILENET.FIXED_LAYERS = n > 0 freezes ``conv0`` and
        ``sep1``..``sep{n-1}`` (the JAX ``frozen_param``)."""
        if fixed_layers > 0:
            self.conv0.requires_grad_(False)
        for i in range(1, fixed_layers):
            getattr(self, f"sep{i}").requires_grad_(False)


def preprocess_images(images, cfg, dtype):
    """Mean-subtract and scale (B, H, W, 3) BGR pixels; returns NHWC in dtype."""
    means = device_constant(cfg.PIXEL_MEANS, torch.float32, images.device)
    x = (images.to(torch.float32) - means) * cfg.DEVICE.PIXEL_SCALE
    return x.to(dtype)


def build_backbone(name: str, cfg, norm: str = "frozen_bn"):
    """Backbone factory (reference tools/trainval_net.py --net): vgg16,
    res50 | res101 | res152 (of either norm) or mobile."""
    if name == "vgg16":
        return VGG16()
    if name in ("res50", "res101", "res152"):
        net = ResNetV1(depth=int(name[3:]),
                       fused=cfg.DEVICE.FUSED_RESNET_BLOCKS and cfg.DEVICE.USE_KERNELS, norm=norm)
        net.freeze_fixed_blocks(cfg.RESNET.FIXED_BLOCKS)
        return net
    if name == "mobile":
        net = MobileNetV1(cfg.MOBILENET.DEPTH_MULTIPLIER)
        net.freeze_fixed_layers(cfg.MOBILENET.FIXED_LAYERS)
        return net
    raise ValueError(f"backbone {name!r} is not ported "
                     "(expected vgg16, res50, res101, res152, mobile)")
