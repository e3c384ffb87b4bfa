"""Engines of the PyTorch port: serving (``serve.Detector``, which on the
card replays ``graphs.DetectGraphs``' captured CUDA graphs) and training
(``train.SolverWrapper``), and the device rule they share."""

from __future__ import annotations

import torch


def resolve_device(device=None, mesh=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the mesh's device
    under a ``mesh``, else the card (``cuda:0``), and raises when there is
    none; ``"cpu"`` (or any ``torch.device``) is an explicit request, which
    under a mesh must be the mesh's device."""
    if device is not None:
        device = torch.device(device)
        if mesh is not None and device != mesh.device:
            raise ValueError(f"device {device} is not the mesh's device {mesh.device}")
        return device
    if mesh is not None:
        return mesh.device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: cuda:0 is not available "
                           "(torch.cuda.is_available() is False); the entry points run on "
                           "the card unless the caller passes device='cpu'")
    return torch.device("cuda", 0)
