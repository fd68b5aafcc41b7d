"""What the port's trainers share: flax's default initialisers, and the
cuDNN flags that forward and backward run under.

The JAX package initialises its networks with flax's defaults: every conv
kernel from ``lecun_normal`` (a normal truncated at two standard
deviations, rescaled so that the kept draws have variance 1 / fan-in),
conv biases at zero, group-norm scales at one and biases at zero.
PyTorch's own defaults (Kaiming-uniform kernels, uniform biases) start a
network elsewhere, so the trainers draw from these instead, from an
explicit ``torch.Generator``.

The networks' ``forward`` sets deterministic cuDNN without TF32 around
itself, but autograd's backward runs later, under the global flags, where
TF32 is on by default: a trainer runs forward and backward inside
:func:`exact_convs`.
"""

from __future__ import annotations

import math

import torch
from torch import nn

# the standard deviation of a unit normal truncated to [-2, 2]
# (flax's variance_scaling divides by it)
TRUNCATED_STD = 0.87962566103423978


def truncated_normal_(weight: torch.Tensor, std: float,
                      generator: torch.Generator) -> torch.Tensor:
    """Fill ``weight`` in place as flax's truncated-normal variance
    scaling does: a normal truncated at two standard deviations, rescaled
    so that the kept draws have standard deviation ``std``."""
    std = std / TRUNCATED_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def lecun_normal_(weight: torch.Tensor,
                  generator: torch.Generator) -> torch.Tensor:
    """Fill a conv kernel ``[out, in, kh, kw]`` (or a linear weight
    ``[out, in]``) in place as flax's ``lecun_normal`` does: fan-in = in *
    kh * kw."""
    fan_in = weight.shape[1] * math.prod(weight.shape[2:])
    return truncated_normal_(weight, math.sqrt(1.0 / fan_in), generator)


def flax_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialise ``module``'s convs and group norms in place (in
    module order) with flax's defaults; returns the module."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.GroupNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
    return module


def exact_convs():
    """cuDNN on, deterministic algorithms, no TF32: the flags a training
    step's forward and backward run under (a context manager)."""
    return torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                      allow_tf32=False)
