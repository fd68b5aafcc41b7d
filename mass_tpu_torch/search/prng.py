"""The subset of ``jax.random`` that the agent's policy heads draw from,
bit for bit, on torch tensors (port of the threefry2x32 stream of
``jax._src.prng`` with ``jax_threefry_partitionable=True`` and of
``jax.random.uniform`` / ``categorical``).

A key is an int64 tensor ``[2]`` holding two unsigned 32-bit words;
every word of the hash lives in an int64 tensor masked to 32 bits, so
the functions run unchanged on any device.  A stack of keys ``[..., 2]``
works wherever one key does, as ``jax.vmap`` over the keys would: the
results gain the keys' leading axes.  Keys are passed explicitly:
nothing here touches a global torch generator.

    key = PRNGKey(seed)
    key, sub = split(key)
    cell = categorical(sub, logits)
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# the smallest normal float32 (``jnp.finfo(float32).tiny``)
TINY = float(np.finfo(np.float32).tiny)


def _rotate_left(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs
    ``(x1, x2)`` under the key ``(k1, k2)``; all 32-bit words in int64
    tensors, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = x[0] ^ _rotate_left(x[1], r)
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x[0], x[1]


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a seed of int32 range (JAX's
    default, 32-bit mode): the key ``[0, seed mod 2**32]``."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed {seed} is outside the int32 range")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64, device=device)


def _counters(shape: Sequence[int], device) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """The partitionable counters of an array of ``shape``: the flat
    index as a 64-bit word, split into its high and low halves."""
    n = int(np.prod(shape, dtype=np.int64))
    flat = torch.arange(n, dtype=torch.int64, device=device)
    return ((flat >> 32).reshape(tuple(shape)),
            (flat & _MASK).reshape(tuple(shape)))


def _words(key: torch.Tensor, ndim: int) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """The two words of a key ``[..., 2]``, shaped to broadcast against
    ``ndim`` trailing axes of counters."""
    lead = tuple(key.shape[:-1]) + (1,) * ndim
    return key[..., 0].reshape(lead), key[..., 1].reshape(lead)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``[..., num, 2]`` new keys."""
    hi, lo = _counters((num,), key.device)
    b1, b2 = threefry2x32(*_words(key, 1), hi, lo)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the hash of the counter pair
    ``(0, data)`` (``data`` as an unsigned 32-bit word) under the key,
    ``[..., 2]``."""
    k1, k2 = _words(key, 0)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(k1),
                          torch.full_like(k1, int(data) & _MASK))
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int] = ()
                ) -> torch.Tensor:
    """32 random bits per element of ``shape`` (int64 tensor
    ``[..., *shape]``)."""
    hi, lo = _counters(shape, key.device)
    b1, b2 = threefry2x32(*_words(key, len(tuple(shape))), hi, lo)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Sequence[int] = (),
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: 23 random mantissa bits under
    the exponent of 1.0, minus 1, scaled into ``[minval, maxval)`` and
    clamped below at ``minval``.  XLA fuses the scale and shift into one
    fused multiply-add, so they are done here in float64 and rounded once
    (the product of two floats is exact there); for the policy's ranges,
    ``[0, 1)`` and ``[tiny, 1)``, the scale is 1 and no rounding differs."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    scaled = (floats.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` in float32, mode "low":
    ``-log(-log(uniform(minval=tiny)))``."""
    return -torch.log(-torch.log(uniform(key, shape, TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis: the
    Gumbel-max sample, the first index on ties."""
    noise = gumbel(key, tuple(logits.shape))
    return torch.argmax(noise.to(logits.device) + logits, dim=-1)
