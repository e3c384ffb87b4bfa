"""Checkpoint I/O for the tools (``frcnn_tpu/engine/checkpoint.py``).

A snapshot (``SolverWrapper.snapshot``) is ``<prefix>_iter_N.pth``, a
``torch.save`` of {"model": state_dict, "optimizer": state_dict, "step"},
with a ``.pkl`` of host state beside it.  A params-only file is a
``torch.save`` of the model's state_dict."""

from __future__ import annotations

import torch


def save_params(path: str, model: torch.nn.Module) -> None:
    """Write the model's state_dict to ``path``."""
    torch.save(model.state_dict(), path)


def load_params(path: str) -> dict:
    """The model's state_dict, on the CPU, from a snapshot ``.pth`` or a
    params-only file."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and isinstance(state.get("model"), dict):
        return state["model"]
    return state
