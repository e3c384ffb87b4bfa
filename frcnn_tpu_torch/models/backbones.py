"""ResNet-v1 C4 backbone (``frcnn_tpu/models/backbones.py``, ResNet only).

Parameter names and layouts are torchvision's (``conv1``, ``bn1``,
``layer1.0.conv1.weight``, ``layer1.0.downsample.0.weight``, ...), so a
lineage ``.pth`` loads directly.  All BatchNorm is frozen: y = x * mul + add
with (mul, add) folded from the stored statistics, in the compute dtype.

Activations are NCHW tensors in ``channels_last`` memory: a permute to NHWC
is then free, which is the layout the fused bottleneck kernel (K3) and the
RoIAlign kernel (K2) read.  Parameters stay float32; each convolution casts
its weight to the input's dtype (bf16 on the card), as the JAX modules do.

The stem is the plain 7x7/s2 conv → BN → relu → 3x3/s2 maxpool; the JAX
package's space-to-depth stem computes the same thing for a TPU's lanes.

Training: frozen BN is buffers, never parameters; ``freeze_fixed_blocks``
sets ``requires_grad=False`` on conv1 and layer1..layer``FIXED_BLOCKS``
(``frozen_param`` of the JAX ResNetV1), so autograd neither computes their
gradients nor runs the backward below the first trainable layer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

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


def _conv(x, conv: nn.Conv2d, stride: int = 1, padding: int = 0):
    return F.conv2d(x, conv.weight.to(x.dtype), stride=stride, padding=padding)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, channels: int, stride: int = 1, fused: bool = False):
        super().__init__()
        cout = channels * self.expansion
        self.stride = stride
        self.fused = fused
        self.conv1 = nn.Conv2d(cin, channels, 1, bias=False)
        self.bn1 = FrozenBatchNorm(channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, stride=stride, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm(channels)
        self.conv3 = nn.Conv2d(channels, cout, 1, bias=False)
        self.bn3 = FrozenBatchNorm(cout)
        self.downsample = None
        if cin != cout or stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride=stride, bias=False), FrozenBatchNorm(cout))

    def _use_fused(self, x) -> bool:
        # The TPU gate also required a row tile that fits VMEM
        # (pick_row_tile); the CUDA kernel tiles any H and W, so that
        # condition is gone.  Frozen BN holds by construction here.
        return (self.fused and self.stride == 1 and x.is_cuda
                and x.dtype == torch.bfloat16)

    def forward(self, x):
        if self._use_fused(x):
            return self._fused_forward(x)
        y = F.relu(self.bn1(_conv(x, self.conv1)))
        y = F.relu(self.bn2(_conv(y, self.conv2, self.stride, 1)))
        y = self.bn3(_conv(y, self.conv3))
        res = x
        if self.downsample is not None:
            res = self.downsample[1](_conv(x, self.downsample[0], self.stride))
        return F.relu(y + res)

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


def _layer(cin: int, channels: int, blocks: int, stride: int, fused: bool):
    layers = [Bottleneck(cin, channels, stride, fused)]
    layers += [Bottleneck(channels * 4, channels, 1, fused) for _ in range(blocks - 1)]
    return nn.Sequential(*layers)


class ResNetV1(nn.Module):
    """conv1 → layer3 is the C4 trunk (stride 16, 1024 channels); the tail
    is layer4 (stride 2 inside the 7x7 crop) + global average pool."""

    feat_channels = 1024
    tail_dim = 2048

    def __init__(self, depth: int = 50, fused: bool = True):
        super().__init__()
        blocks = _RESNET_DEPTHS[depth]
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        cin = 64
        for li, (n, ch, stride) in enumerate(zip(blocks, (64, 128, 256, 512), (1, 2, 2, 2)),
                                             start=1):
            # the tail (layer4) runs on 7x7 crops and is never fused
            use_fused = fused and li <= 3 and ch <= FUSED_MAX_CH
            setattr(self, f"layer{li}", _layer(cin, ch, n, stride, use_fused))
            cin = ch * 4

    def extract_features(self, x):
        """x (B, 3, H, W) in the compute dtype → (B, 1024, H/16, W/16)."""
        x = F.relu(self.bn1(_conv(x, self.conv1, 2, 3)))
        x = F.max_pool2d(x, 3, 2, 1)
        return self.layer3(self.layer2(self.layer1(x)))

    def head_to_tail(self, pooled):
        """pooled (N, 1024, p, p) → (N, 2048)."""
        return self.layer4(pooled).mean(dim=(2, 3))

    def freeze_fixed_blocks(self, fixed_blocks: int) -> None:
        """conv1 and layer1..layer{fixed_blocks} stop training
        (cfg.RESNET.FIXED_BLOCKS); BN is frozen throughout."""
        frozen = [self.conv1] + [getattr(self, f"layer{i}") for i in range(1, fixed_blocks + 1)]
        for module in frozen:
            module.requires_grad_(False)


def preprocess_images(images, cfg, dtype):
    """Mean-subtract and scale (B, H, W, 3) BGR pixels; returns NHWC in dtype."""
    means = torch.tensor(cfg.PIXEL_MEANS, dtype=torch.float32, device=images.device)
    x = (images.to(torch.float32) - means) * cfg.DEVICE.PIXEL_SCALE
    return x.to(dtype)


def build_backbone(name: str, cfg):
    """ResNet factory (reference tools/trainval_net.py --net)."""
    if name in ("res50", "res101", "res152"):
        net = ResNetV1(depth=int(name[3:]),
                       fused=cfg.DEVICE.FUSED_RESNET_BLOCKS and cfg.DEVICE.USE_KERNELS)
        net.freeze_fixed_blocks(cfg.RESNET.FIXED_BLOCKS)
        return net
    raise ValueError(f"backbone {name!r} is not ported (expected res50, res101, res152)")
