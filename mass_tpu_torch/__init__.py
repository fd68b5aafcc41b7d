"""mass_tpu_torch — the PyTorch / CUDA port of ``mass_tpu``.

A second package beside the JAX reference: the same 3D semantic
mapping and rearrangement pipeline, written with PyTorch on tensors and
with every TPU kernel on the ported path replaced by a kernel written by
hand for NVIDIA Hopper (``csrc/``).  Module names mirror ``mass_tpu``'s,
so each port sits at the same path as its reference.  The package never
imports ``jax`` nor anything of ``mass_tpu``: what it needs of the JAX-free
reference modules (config, taxonomy, grid world, metrics) lives here as
its own copy.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no GPU and no explicit ``cpu`` they raise (see
:func:`resolve_device`).
"""

from __future__ import annotations

__version__ = "0.1.0"


def resolve_device(device=None):
    """The ``torch.device`` an entry point runs on.

    ``None`` means ``cuda``.  A CUDA device on a box without CUDA raises
    instead of falling back: a run that silently lands on the CPU would
    report CPU numbers under a GPU's name.
    """
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mass_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' (CLI: --device cpu) to run on "
            "the CPU")
    return dev
