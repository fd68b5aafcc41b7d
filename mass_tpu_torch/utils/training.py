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

The JAX package's trainers run data-parallel on one controller: one
jitted step with the parameters replicated and the batch sharded over a
``data`` mesh axis.  :class:`Replicas` is that step in one process: a
replica of the module on each device of the data axis, the batch split
in order into equal shards, each replica's loss the mean over its shard,
and the gradients summed into the first replica in device order and
divided by the count (JAX's ``psum``): with equal shards, the mean of
the shards' means is the batch's mean.  One replica is the one-device
step.
"""

from __future__ import annotations

import copy
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from mass_tpu_torch.parallel.mesh import (canonical_device, cuda_devices,
                                         make_mesh)

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


def data_devices(device, count: Optional[int] = None) -> List[torch.device]:
    """The ``data`` axis of a data-parallel trainer whose first device is
    ``device``: on CUDA ``count`` cards from ``device``'s index on (by
    default every one from there; more than are present raises); on the
    CPU ``count`` replicas (default one: the CPU counts as any number of
    devices)."""
    device = canonical_device(device)
    if device.type == "cpu":
        return [device] * (count or 1)
    cards = cuda_devices()[device.index:]
    return make_mesh((count or len(cards),), ("data",),
                     cards).axis_devices("data")


def largest_divisor(batch: int, count: int) -> int:
    """The largest divisor of ``batch`` that is at most ``count`` (the
    JAX detector trainers' data axis)."""
    n = min(count, batch)
    while batch % n:
        n -= 1
    return n


class Replicas:
    """``module`` (on ``devices[0]``) and a copy of it on each further
    device of a data axis; ``names`` are the parameters that train (all
    that require a gradient by default).

    :meth:`grads` is one data-parallel forward and backward: replica 0's
    parameters and buffers copied into the others, the batch split in
    order into equal shards, each replica's losses on its shard under
    :func:`exact_convs`, and the losses and gradients summed on the first
    device in device order and divided by the count.  A device may repeat
    (``["cpu"] * 4``, ``["cuda:0"] * 2``).
    """

    def __init__(self, module: nn.Module, devices: Sequence,
                 names: Optional[Sequence[str]] = None):
        self.devices = [canonical_device(d) for d in devices]
        first = canonical_device(next(module.parameters()).device)
        if first != self.devices[0]:
            raise ValueError(f"the module lies on {first}, the data axis "
                             f"starts at {self.devices[0]}")
        self.modules = [module] + [copy.deepcopy(module).to(d)
                                   for d in self.devices[1:]]
        self.names = list(names) if names is not None else [
            n for n, p in module.named_parameters() if p.requires_grad]
        self._params = [[dict(m.named_parameters())[n] for n in self.names]
                        for m in self.modules]

    def __len__(self) -> int:
        return len(self.modules)

    @torch.no_grad()
    def broadcast(self) -> None:
        """Copy replica 0's parameters and buffers into the others."""
        source = self.modules[0]
        for replica in self.modules[1:]:
            for dst, src in zip(replica.parameters(), source.parameters()):
                dst.copy_(src)
            for dst, src in zip(replica.buffers(), source.buffers()):
                dst.copy_(src)

    def shards(self, *batch: torch.Tensor) -> List[Tuple[torch.Tensor, ...]]:
        """Each tensor of ``batch`` (``[B, ...]``) cut in order into one
        equal shard a replica, on its device."""
        n = len(self)
        for t in batch:
            if t.shape[0] % n:
                raise ValueError(f"a batch of {t.shape[0]} does not split "
                                 f"over {n} replicas")
        return [tuple(t.chunk(n)[k].to(d) for t in batch)
                for k, d in enumerate(self.devices)]

    def grads(self, losses: Callable[..., Dict[str, torch.Tensor]],
              *batch: torch.Tensor
              ) -> Tuple[Dict[str, torch.Tensor], List[torch.Tensor]]:
        """``(losses, gradients)`` of one data-parallel step:
        ``losses(module, *shard)`` gives a replica's mean losses on its
        shard, ``"total"`` the one differentiated.  Both come back on the
        first device: each loss, and each gradient of :attr:`names`, the
        replicas' sum in device order over their count."""
        self.broadcast()
        first = self.devices[0]
        loss_sum: Dict[str, torch.Tensor] = {}
        grad_sum: List[torch.Tensor] = []
        for k, (module, shard) in enumerate(zip(self.modules,
                                                self.shards(*batch))):
            with exact_convs():
                out = losses(module, *shard)
                grads = torch.autograd.grad(out["total"], self._params[k])
            out = {name: v.detach().to(first) for name, v in out.items()}
            grads = [g.to(first) for g in grads]
            if k == 0:
                loss_sum, grad_sum = out, list(grads)
            else:
                loss_sum = {name: loss_sum[name] + v
                            for name, v in out.items()}
                grad_sum = [a + b for a, b in zip(grad_sum, grads)]
        n = len(self)
        return ({name: v / n for name, v in loss_sum.items()},
                [g / n for g in grad_sum])

    def set_grads(self, grads: Sequence[torch.Tensor]) -> None:
        """Give replica 0's trained parameters these gradients (for a
        ``torch.optim`` optimizer's step)."""
        for p, g in zip(self._params[0], grads):
            p.grad = g
