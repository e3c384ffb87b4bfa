"""What the benchmark takes from the system under test (``frcnn_tpu_torch``):
its configuration, its model with the benchmark's weights loaded, and the
settings the reference reads, both from the configuration file's ``cfg``
and the traffic file's ``set``."""

from __future__ import annotations

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def settings(config: dict, traffic: dict, seed: int) -> dict:
    """The flat dotted settings of a cell: the configuration's ``cfg``, the
    traffic's ``set`` over it, and RNG_SEED from the seed (the data layer's
    order, the sampling draws)."""
    c = dict(config["cfg"])
    c.update(traffic.get("set", {}))
    c["RNG_SEED"] = seed % (2**31 - 2)
    return c


def port_config(c: dict):
    """The program's ``Config`` with every setting of ``c``."""
    from frcnn_tpu_torch import cfg_from_list, default_config

    pairs = []
    for k, v in c.items():
        pairs += [k, v if not isinstance(v, list) else [tuple(x) if isinstance(x, list) else x
                                                        for x in v]]
    return cfg_from_list(default_config(), pairs)


def build(config: dict, c: dict, weights: dict, device):
    """The program's detector for ``config`` on ``device`` with ``weights``
    loaded (every tensor by name, none missing or left over)."""
    from frcnn_tpu_torch.models.network import build_model

    cfg = port_config(c)
    model = build_model(config["net"], config["num_classes"], cfg,
                        dtype=DTYPES[c["DEVICE.DTYPE"]])
    model.load_state_dict(weights, strict=True)
    return model.to(device), cfg
