"""Seeded random weights, made on the device in one draw: every tensor the
reference's ``param_specs`` lists, float32, under the names the program's
``state_dict`` uses."""

from __future__ import annotations

import math

import torch

from benchmark.reference.detector import param_specs


def make_weights(net: str, num_classes: int, c: dict, seed: int, device,
                 scheme: dict | None = None) -> dict:
    """{name: float32 tensor on ``device``}: the normal draws of all tensors
    come from one ``torch.randn`` of a generator seeded with ``seed``, then
    each slice is scaled by its std; fills and zeros are made in place.
    ``scheme``: the configuration file's ``weights`` (``param_specs``)."""
    specs = param_specs(net, num_classes, c, scheme)
    normal = [(name, shape, init[1]) for name, shape, init in specs if init[0] == "normal"]
    total = sum(math.prod(shape) for _, shape, _ in normal)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device)
    out, off = {}, 0
    for name, shape, std in normal:
        n = math.prod(shape)
        out[name] = flat[off:off + n].view(shape).mul_(std)
        off += n
    for name, shape, init in specs:
        if init[0] == "fill":
            out[name] = torch.full(shape, float(init[1]), device=device)
        elif init[0] == "zeros":
            out[name] = torch.zeros(shape, device=device)
    return {name: out[name] for name, _, _ in specs}
