"""Trilinear voxel scatter: the corner records of a frame (port of
``mass_tpu.ops.scatter.corner_contributions``).

Each valid pixel contributes to the 8 voxels around it with trilinear
weights ``w``; a touched voxel becomes the w-weighted average of
per-pixel EMA blends with its old value, which is algebraically

    W_v  = sum w_p        S2_v = sum w_p^2       T_v = sum w_p^2 f_p
    out_v = old_v * (1 - iw * S2_v / W_v) + iw * T_v / W_v

and untouched voxels keep their value.  Invalid pixels carry the
discard id ``V`` (one past the last voxel), as in the JAX package.

The update itself is ``ops/splat.py``: the hand-written kernel and its
plain version, which stands in for the JAX package's XLA blends
(``apply_onehot_cmajor`` / ``apply_onehot_vmajor``) and its span sort.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mass_tpu_torch.core.geometry import BinnedPoints


def _corner_indices_and_weights(ind, ratio, size: int):
    """Lower/upper cell ids and linear weights along one axis.  Below
    the cell midpoint a point shares weight with the previous cell,
    above with the next; at the grid edge both corners fold onto the
    same cell and both weights accumulate there."""
    near_low = ratio < 0.5
    lower = torch.where(near_low, (ind - 1).clamp_min(0), ind)
    upper = torch.where(near_low, ind, (ind + 1).clamp_max(size - 1))
    w_lower = torch.where(near_low, 0.5 - ratio, 1.5 - ratio)
    w_upper = torch.where(near_low, ratio + 0.5, ratio - 0.5)
    return (lower, upper), (w_lower, w_upper)


def corner_contributions(points: BinnedPoints,
                         sizes: Tuple[int, int, int],
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expand binned pixels into their 8 voxel-corner records.

    Returns ``(ids, weights)``, both ``[8N]`` in corner-major order (the
    pixel of record ``k`` is ``k % N``).  ``ids`` are flat voxel ids
    ``(row * W + col) * D + z`` (int64); invalid pixels get ``H*W*D``.
    Weights are ``1e-9 + w0 * w1 * w2`` in that association order.
    """
    size_h, size_w, size_d = sizes
    num_voxels = size_h * size_w * size_d

    (l0, u0), (wl0, wu0) = _corner_indices_and_weights(
        points.ind_y.reshape(-1), points.ratio_y.reshape(-1), size_h)
    (l1, u1), (wl1, wu1) = _corner_indices_and_weights(
        points.ind_x.reshape(-1), points.ratio_x.reshape(-1), size_w)
    (l2, u2), (wl2, wu2) = _corner_indices_and_weights(
        points.ind_z.reshape(-1), points.ratio_z.reshape(-1), size_d)

    ids, weights = [], []
    for i0, w0 in ((l0, wl0), (u0, wu0)):
        for i1, w1 in ((l1, wl1), (u1, wu1)):
            for i2, w2 in ((l2, wl2), (u2, wu2)):
                ids.append((i0 * size_w + i1) * size_d + i2)
                weights.append(1e-9 + w0 * w1 * w2)
    ids = torch.stack(ids).reshape(-1)
    weights = torch.stack(weights).reshape(-1)
    valid = points.valid.reshape(-1).repeat(8)
    ids = torch.where(valid, ids, torch.full_like(ids, num_voxels))
    return ids, weights
