"""JAX params → the port's state_dict: the inverse of
``frcnn_tpu/utils/weight_convert.py::convert_detector``.

The port keeps the lineage's torchvision names and layouts, so a lineage
``.pth`` loads with ``load_state_dict`` and needs no conversion.  This
module maps a ``frcnn_tpu`` FasterRCNN ``variables["params"]`` tree (numpy
arrays) back to those names:

  * conv kernels HWIO → OIHW (a depthwise (3, 3, 1, C) → (C, 1, 3, 3));
    dense kernels (in, out) → (out, in);
  * FrozenBatchNorm {scale, bias, mean, var} → {weight, bias, running_mean,
    running_var}; GroupNorm {scale, bias} → {weight, bias};
  * ``rpn_cls_score``: the JAX module orders the 2A channels per anchor
    (c = a*2 + j); the lineage orders a bg block then an fg block
    (c = j*A + a).  The channel permutation is undone;
  * VGG-16: ``trunk.conv{b}_{i}`` → torchvision's ``features.{idx}``,
    ``tail.fc6/fc7`` → ``classifier.0/3``; the JAX tail flattens the 7x7
    crop in H, W, C order and torchvision in C, H, W, so fc6's input columns
    are permuted (the inverse of the JAX ``convert_vgg16``'s);
  * MobileNet-v1: the JAX tree's names (``trunk.conv0``, ``trunk.bn0``,
    ``{trunk,tail}.sep{i}.{depthwise,bn_dw,pointwise,bn_pw}``) flattened.

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


# torchvision vgg16 ``features`` indices of the 13 convs, in order
_VGG_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_VGG_NAMES = ("conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv3_1", "conv3_2", "conv3_3",
              "conv4_1", "conv4_2", "conv4_3", "conv5_1", "conv5_2", "conv5_3")


def convert_vgg16_from_jax(backbone):
    """``params["backbone"]`` of a VGG16 → torchvision vgg16 names."""
    sd = {}
    for idx, name in zip(_VGG_IDX, _VGG_NAMES):
        _conv_bias(sd, f"features.{idx}", backbone["trunk"][name])
    tail = backbone["tail"]
    c = np.asarray(backbone["trunk"]["conv5_3"]["kernel"]).shape[-1]
    w6 = np.asarray(tail["fc6"]["kernel"])                      # (p * p * C, D), rows (y, x, c)
    p = int(round((w6.shape[0] // c) ** 0.5))
    w6 = w6.reshape(p, p, c, -1).transpose(2, 0, 1, 3).reshape(w6.shape)   # rows (c, y, x)
    _dense(sd, "classifier.0", {"kernel": w6, "bias": tail["fc6"]["bias"]})
    _dense(sd, "classifier.3", tail["fc7"])
    return sd


def convert_mobilenet_from_jax(backbone):
    """``params["backbone"]`` of a MobileNetV1 → the port's names (the JAX
    tree's, flattened)."""
    trunk = backbone["trunk"]
    sd = {"conv0.weight": _conv(trunk["conv0"]["kernel"])}
    _bn(sd, "bn0", trunk["bn0"])
    for part in (trunk, backbone["tail"]):
        for name, layer in part.items():
            if name.startswith("sep"):
                for conv in ("depthwise", "pointwise"):
                    sd[f"{name}.{conv}.weight"] = _conv(layer[conv]["kernel"])
                for bn in ("bn_dw", "bn_pw"):
                    _bn(sd, f"{name}.{bn}", layer[bn])
    return sd


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
    if net == "vgg16":
        sd = convert_vgg16_from_jax(params["backbone"])
    elif net in ("res50", "res101", "res152"):
        sd = convert_resnet_from_jax(params["backbone"], int(net[3:]))
    elif net == "mobile":
        sd = convert_mobilenet_from_jax(params["backbone"])
    else:
        raise ValueError(f"no converter for backbone {net}")
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
