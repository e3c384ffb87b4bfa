"""JAX params → the port's state_dict: the inverse of
``frcnn_tpu/utils/weight_convert.py::convert_detector``.

The port keeps the lineage's torchvision names and layouts, so a lineage
``.pth`` loads with ``load_state_dict`` and needs no conversion.  This
module maps a ``frcnn_tpu`` FasterRCNN ``variables["params"]`` tree (numpy
arrays) back to those names:

  * conv kernels HWIO → OIHW; dense kernels (in, out) → (out, in);
  * FrozenBatchNorm {scale, bias, mean, var} → {weight, bias, running_mean,
    running_var}; GroupNorm {scale, bias} → {weight, bias};
  * ``rpn_cls_score``: the JAX module orders the 2A channels per anchor
    (c = a*2 + j); the lineage orders a bg block then an fg block
    (c = j*A + a).  The channel permutation is undone.

``convert_fpn_from_jax`` maps a ``FasterRCNNFPN`` tree the same way, of
either norm (``res*_fpn`` or ``res*_fpn_gn``).  The
FPN model has no lineage checkpoint, so its RPN keeps the JAX layout
(``rpn_cls_w`` (C, 2A), ``rpn_box_w`` (C, 4A)) unpermuted, and the box
head's ``fc1`` DenseGeneral kernel (p, p, C, 1024) becomes a (1024, p*p*C)
weight over the (py, px, c) flattening.
"""

from __future__ import annotations

import numpy as np
import torch

_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _conv(kernel):
    return _t(np.asarray(kernel).transpose(3, 2, 0, 1))  # HWIO → OIHW


def _bn(sd, prefix, p):
    """A norm's params: GroupNorm has no running statistics."""
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    if "mean" in p:
        sd[f"{prefix}.running_mean"] = _t(p["mean"])
        sd[f"{prefix}.running_var"] = _t(p["var"])


def _resnet(stem, layer_params, depth: int):
    """torchvision resnet names from the stem's params (``conv1``, ``bn1``)
    and ``layer_params(li)``, the tree that holds ``layer{li}_block{i}``."""
    sd = {"conv1.weight": _conv(stem["conv1"]["kernel"])}
    _bn(sd, "bn1", stem["bn1"])
    for li, n in enumerate(_BLOCKS[depth], start=1):
        src = layer_params(li)
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


def convert_resnet_from_jax(backbone, depth: int):
    """``params["backbone"]`` of a ResNetV1 → torchvision resnet names."""
    return _resnet(backbone["trunk"],
                   lambda li: backbone["trunk"] if li <= 3 else backbone["tail"], depth)


def _conv_bias(sd, prefix, p):
    sd[f"{prefix}.weight"] = _conv(p["kernel"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _dense(sd, prefix, p):
    """A Dense / DenseGeneral kernel (..., out) → a (out, prod(...)) weight."""
    kernel = np.asarray(p["kernel"])
    sd[f"{prefix}.weight"] = _t(kernel.reshape(-1, kernel.shape[-1]).T)
    sd[f"{prefix}.bias"] = _t(p["bias"])


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
    _conv_bias(sd, "rpn_net", params["rpn_net"])
    sd["rpn_cls_score.weight"] = _conv(np.asarray(cls["kernel"])[..., inv])
    sd["rpn_cls_score.bias"] = _t(np.asarray(cls["bias"])[inv])
    _conv_bias(sd, "rpn_bbox_pred", params["rpn_bbox_pred"])
    for name in ("cls_score", "bbox_pred"):
        _dense(sd, name, params[name])
    return sd


def convert_fpn_from_jax(params, net: str):
    """JAX FasterRCNNFPN params tree (numpy leaves) → the port's
    FasterRCNNFPN state_dict (torch tensors)."""
    trunk, _, norm = net.partition("_fpn")
    if trunk not in ("res50", "res101", "res152") or norm not in ("", "_gn"):
        raise ValueError(f"no FPN converter for backbone {net}")
    stages = params["stages"]
    sd = _resnet(stages, lambda li: stages, int(trunk[3:]))
    for name, p in params["neck"].items():            # lateral{2..5}, output{2..5}
        _conv_bias(sd, f"neck.{name}", p)
    _conv_bias(sd, "rpn_net", params["rpn_net"])
    for name in ("rpn_cls_w", "rpn_cls_b", "rpn_box_w", "rpn_box_b"):
        # the reference keeps these in the compute dtype: bf16 stays bf16
        bf16 = np.asarray(params[name]).dtype.name == "bfloat16"
        sd[name] = _t(params[name]).to(torch.bfloat16) if bf16 else _t(params[name])
    for name in ("fc1", "fc2"):
        _dense(sd, f"box_head.{name}", params["box_head"][name])
    for name in ("cls_score", "bbox_pred"):
        _dense(sd, name, params[name])
    return sd
