"""Stride-1 "same"-padded box pooling (port of ``mass_tpu.ops.pool``).

Both filters are separable and built from shifted slices of a padded
tensor, so integer and boolean inputs stay exact and float window sums
add the window's elements in order, as ``lax.reduce_window`` does.
"""

from __future__ import annotations

import torch


def _axis_window(x: torch.Tensor, dim: int, k: int, fill, op):
    """1-D stride-1 same-padded window reduction along ``dim``."""
    r = (k - 1) // 2
    shape = list(x.shape)
    shape[dim] = r
    pad = torch.full(shape, fill, dtype=x.dtype, device=x.device)
    padded = torch.cat([pad, x, pad], dim=dim)
    n = x.shape[dim]
    out = padded.narrow(dim, 0, n)
    for o in range(1, k):
        out = op(out, padded.narrow(dim, o, n))
    return out


def avg_pool3d_same(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Box-average a ``[..., H, W, D]`` volume with a cubic kernel of side
    ``2 * radius + 1``, dividing by the full kernel volume at borders
    too (torch ``count_include_pad=True``)."""
    if radius == 0:
        return x
    k = 2 * radius + 1
    for dim in (-3, -2, -1):
        x = _axis_window(x, x.dim() + dim, k, 0.0, torch.add)
    return x / float(k ** 3)


def max_pool2d_same(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Max-filter a ``[..., H, W]`` image with a square kernel of side
    ``2 * radius + 1`` (bool, integer or float)."""
    if radius == 0:
        return x
    k = 2 * radius + 1
    if x.dtype == torch.bool:
        fill, op = False, torch.logical_or
    elif x.dtype.is_floating_point:
        fill, op = float("-inf"), torch.maximum
    else:
        fill, op = torch.iinfo(x.dtype).min, torch.maximum
    for dim in (-2, -1):
        x = _axis_window(x, x.dim() + dim, k, fill, op)
    return x


def min_pool2d_same(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Min-filter a ``[..., H, W]`` integer image (padding never wins)."""
    if radius == 0:
        return x
    k = 2 * radius + 1
    fill = torch.iinfo(x.dtype).max
    for dim in (-2, -1):
        x = _axis_window(x, x.dim() + dim, k, fill, torch.minimum)
    return x
