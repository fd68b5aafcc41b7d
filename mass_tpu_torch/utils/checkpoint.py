"""Checkpointing: ``.pth`` state dicts (port of
``mass_tpu.utils.checkpoint``).

The JAX package saves its pytrees with orbax; the port saves and loads
PyTorch state dicts, the format the reference's own checkpoints have
(``policy.pth``, detectron2's ``model_final.pth``).  Tensors are written
from the CPU and read onto the CPU with ``weights_only=True``, so a file
written on the card loads on a box without one.
"""

from __future__ import annotations

import os
from typing import Dict

import torch


def save_state_dict(path: str, state_dict: Dict[str, torch.Tensor]) -> str:
    """Write ``state_dict`` (its tensors copied to the CPU) to ``path``;
    returns the absolute path."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path)
    return path


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The state dict saved at ``path``, on the CPU."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return torch.load(path, map_location="cpu", weights_only=True)
