"""JAX params → the port's state_dict: the inverse of
``frcnn_tpu/utils/weight_convert.py::convert_detector``.

The port keeps the lineage's torchvision names and layouts, so a lineage
``.pth`` loads with ``load_state_dict`` and needs no conversion.  This
module maps a ``frcnn_tpu`` FasterRCNN ``variables["params"]`` tree (numpy
arrays) back to those names:

  * conv kernels HWIO → OIHW; dense kernels (in, out) → (out, in);
  * FrozenBatchNorm {scale, bias, mean, var} → {weight, bias, running_mean,
    running_var};
  * ``rpn_cls_score``: the JAX module orders the 2A channels per anchor
    (c = a*2 + j); the lineage orders a bg block then an fg block
    (c = j*A + a).  The channel permutation is undone.
"""

from __future__ import annotations

import numpy as np
import torch

_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float32)))


def _conv(kernel):
    return _t(np.asarray(kernel).transpose(3, 2, 0, 1))  # HWIO → OIHW


def _bn(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    sd[f"{prefix}.running_mean"] = _t(p["mean"])
    sd[f"{prefix}.running_var"] = _t(p["var"])


def convert_resnet_from_jax(backbone, depth: int):
    """``params["backbone"]`` of a ResNetV1 → torchvision resnet names."""
    sd = {"conv1.weight": _conv(backbone["trunk"]["conv1"]["kernel"])}
    _bn(sd, "bn1", backbone["trunk"]["bn1"])
    for li, n in enumerate(_BLOCKS[depth], start=1):
        src = backbone["trunk"] if li <= 3 else backbone["tail"]
        for bi in range(n):
            block = src[f"layer{li}_block{bi}"]
            p = f"layer{li}.{bi}"
            for ci in (1, 2, 3):
                sd[f"{p}.conv{ci}.weight"] = _conv(block[f"conv{ci}"]["kernel"])
                _bn(sd, f"{p}.bn{ci}", block[f"bn{ci}"])
            if "downsample_conv" in block:
                sd[f"{p}.downsample.0.weight"] = _conv(block["downsample_conv"]["kernel"])
                _bn(sd, f"{p}.downsample.1", block["downsample_bn"])
    return sd


def convert_from_jax(params, net: str, num_anchors: int = 9):
    """Full JAX FasterRCNN params tree (numpy leaves) → the port's
    state_dict (torch tensors, lineage names and layouts)."""
    if not net.startswith("res") or "_" in net:
        raise ValueError(f"no converter for backbone {net}")
    sd = convert_resnet_from_jax(params["backbone"], int(net[3:]))
    a = num_anchors
    # JAX channel k = i*2 + j holds lineage channel perm[k] = j*A + i
    perm = np.array([j * a + i for i in range(a) for j in range(2)])
    inv = np.argsort(perm)
    cls = params["rpn_cls_score"]
    sd["rpn_net.weight"] = _conv(params["rpn_net"]["kernel"])
    sd["rpn_net.bias"] = _t(params["rpn_net"]["bias"])
    sd["rpn_cls_score.weight"] = _conv(np.asarray(cls["kernel"])[..., inv])
    sd["rpn_cls_score.bias"] = _t(np.asarray(cls["bias"])[inv])
    sd["rpn_bbox_pred.weight"] = _conv(params["rpn_bbox_pred"]["kernel"])
    sd["rpn_bbox_pred.bias"] = _t(params["rpn_bbox_pred"]["bias"])
    for name in ("cls_score", "bbox_pred"):
        sd[f"{name}.weight"] = _t(np.asarray(params[name]["kernel"]).T)
        sd[f"{name}.bias"] = _t(params[name]["bias"])
    return sd
