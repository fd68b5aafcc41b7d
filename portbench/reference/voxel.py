"""Plain voxel-map update: one RGB-D frame's class image folded into a
one-hot voxel map, written from the semantics of the reference
projection (``mass/utils/projection.py``), in plain PyTorch.

A pixel's ray endpoint ``origin + ray * depth`` is binned into the grid
(y flipped to map rows), spread over the 8 voxels around it with
trilinear weights ``w = 1e-9 + wy * wx * wz``, and every touched voxel
becomes the weight-averaged EMA blend of its old value with the pixel's
one-hot class:

    out_v = old_v * (1 - iw * S2_v / W_v) + iw * T_v / W_v
    W_v = sum w     S2_v = sum w^2     T_v[c] = sum of w^2 over class c

A dense feature map (``fold_dense``) blends each pixel's feature row in
place of its one-hot class: ``T_v = sum of w^2 * feature``.

The binning is strict float32 in the same operation order as the
program's (the rotation built on the host from the float32 pose, the
products written out), so both bin every pixel alike; the sums and the
blend run in the map's own dtype: float64 for the reference, bfloat16
for the control.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class Geometry(NamedTuple):
    height: int          # map rows (world y, flipped)
    width: int           # map columns (world x)
    depth: int           # map z cells (world up)
    classes: int         # one-hot channels
    resolution: float    # metres per cell
    blend: float = 0.5   # EMA interpolation weight

    @property
    def voxels(self) -> int:
        return self.height * self.width * self.depth


def camera_rays(size: int, vertical_fov: float, device) -> torch.Tensor:
    """``[size, size, 3]`` pinhole rays looking down -z, y up, unit
    length along the camera axis (built in float64, stored float32)."""
    focal = size / 2.0 / math.tan(math.radians(vertical_fov) / 2.0)
    y, x = np.meshgrid(np.arange(size, dtype=np.float64),
                       np.arange(size, dtype=np.float64), indexing="ij")
    rays = np.stack([(x - 0.5 * (size - 1)) / focal,
                     -(y - 0.5 * (size - 1)) / focal,
                     -np.ones_like(x)], axis=-1)
    return torch.tensor(rays, dtype=torch.float32, device=device)


def _unit(yaw: float, elevation: float) -> np.ndarray:
    f = np.float32
    cy, sy = f(math.cos(float(yaw))), f(math.sin(float(yaw)))
    ce, se = f(math.cos(float(elevation))), f(math.sin(float(elevation)))
    return np.array([cy * ce, sy * ce, se], np.float32)


def rotation(yaw: float, elevation: float) -> np.ndarray:
    """Camera-to-world rotation, columns ``[right, up, -eye]``, float32."""
    eye = _unit(yaw, elevation)
    up = _unit(yaw, np.float32(elevation) + np.float32(np.pi / 2))
    right = np.cross(eye, up).astype(np.float32)
    return np.stack([right, up, -eye], axis=-1)


def edges(origin: float, cells: int, resolution: float,
          device) -> torch.Tensor:
    """``cells + 1`` voxel boundaries centred on ``origin`` (float32)."""
    o = torch.tensor(float(np.float32(origin)), dtype=torch.float32,
                     device=device)
    lo = o - float(np.float32((cells + 1) * resolution / 2.0))
    i = torch.arange(cells + 1, dtype=torch.float32, device=device)
    return lo + i * float(np.float32(resolution))


def grid_edges(origins, g: Geometry, device):
    """(x, y, z) edges ``[B, n + 1]`` of B maps, each centred on its world
    point of ``origins [B, 3]``."""
    return tuple(torch.stack([edges(o[k], n, g.resolution, device)
                              for o in origins])
                 for k, n in enumerate((g.width, g.height, g.depth)))


def _bracket(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """``i`` with ``e[i] <= x < e[i + 1]`` for each frame's own edges
    (``x [B, n]`` against ``e [B, m]``): -1 below, ``m - 1`` at or above
    the last edge."""
    return torch.searchsorted(e, x.contiguous(), right=True) - 1


def records(rays, bins, g: Geometry, positions, yaws, elevations, depths,
            classes, max_depth: float = 10.0):
    """The valid pixels' 8 corner records of B frames, each binned on its
    own grid: ``(frames [R], ids [R]`` int64 voxel ids ``(row * W + col) *
    D + z``, ``weights [R]`` float32, ``classes [R])``.  ``bins`` are the
    frames' ``[B, n + 1]`` edges per axis, ``positions [B, 3]`` float32
    world, ``yaws``/``elevations [B]``, ``depths [B, h, w]`` planar
    metres, ``classes [B, h, w]``."""
    dev = rays.device
    B = depths.shape[0]
    rot = torch.from_numpy(np.stack([rotation(y, e) for y, e in
                                     zip(yaws, elevations)])).to(dev)
    rot = rot[:, None, None]                            # [B, 1, 1, 3, 3]
    r0, r1, r2 = rays[..., 0], rays[..., 1], rays[..., 2]
    world = torch.stack([r0 * rot[..., i, 0] + r1 * rot[..., i, 1]
                         + r2 * rot[..., i, 2] for i in range(3)], -1)
    origin = torch.as_tensor(np.asarray(positions, np.float32), device=dev)
    points = origin[:, None, None, :] + world * depths[..., None]
    bx, by, bz = bins
    flat = points.reshape(B, -1, 3)
    ix = _bracket(flat[..., 0], bx).view(depths.shape)
    iy = _bracket(flat[..., 1], by).view(depths.shape)
    iz = _bracket(flat[..., 2], bz).view(depths.shape)
    valid = ((depths >= 0) & (depths <= max_depth)
             & (ix >= 0) & (ix < bx.shape[-1] - 1)
             & (iy >= 0) & (iy < by.shape[-1] - 1)
             & (iz >= 0) & (iz < bz.shape[-1] - 1))
    frame = torch.arange(B, device=dev)[:, None, None].expand(depths.shape)
    frame = frame[valid]
    p = points[valid]
    ix, iy, iz = ix[valid], iy[valid], iz[valid]
    cls = classes[valid].to(torch.int64)

    def ratio(coord, i, e):
        left, right = e[frame, i], e[frame, i + 1]
        return (coord - left) / (right - left)

    rx, rz = ratio(p[:, 0], ix, bx), ratio(p[:, 2], iz, bz)
    ry = 1.0 - ratio(p[:, 1], iy, by)
    row = (by.shape[-1] - 2) - iy

    def corners(i, r, size):
        # below the cell's midpoint a point shares weight with the
        # previous cell, above it with the next; at the grid's edge both
        # corners fold onto the same cell
        low = r < 0.5
        return ((torch.where(low, (i - 1).clamp_min(0), i),
                 torch.where(low, 0.5 - r, 1.5 - r)),
                (torch.where(low, i, (i + 1).clamp_max(size - 1)),
                 torch.where(low, r + 0.5, r - 0.5)))

    ids, weights = [], []
    for a, wa in corners(row, ry, g.height):
        for b, wb in corners(ix, rx, g.width):
            for c, wc in corners(iz, rz, g.depth):
                ids.append((a * g.width + b) * g.depth + c)
                weights.append(1e-9 + wa * wb * wc)
    return (frame.repeat(8), torch.cat(ids), torch.cat(weights),
            cls.repeat(8))


def _blend(data: torch.Tensor, ids, weights, g: Geometry, t_sum) -> None:
    """The EMA rule over ``data [V, F]`` in place, in ``data``'s dtype;
    ``t_sum(inverse, w2, n)`` gives the n touched voxels' ``T`` rows from
    each record's voxel (its index among them) and squared weight."""
    voxels, inverse = torch.unique(ids, return_inverse=True)
    w = weights.to(data.dtype)
    w2 = w * w
    n = voxels.shape[0]
    w_sum = data.new_zeros(n).index_add_(0, inverse, w)
    s2_sum = data.new_zeros(n).index_add_(0, inverse, w2)
    keep = 1.0 - g.blend * s2_sum / w_sum
    data[voxels] = (data[voxels] * keep[:, None]
                    + (g.blend / w_sum)[:, None] * t_sum(inverse, w2, n))


def fold(data: torch.Tensor, ids, weights, classes, g: Geometry) -> None:
    """Blend one frame's records into ``data [V, F]`` in place, in
    ``data``'s dtype."""
    def t_sum(inverse, w2, n):
        ok = (classes >= 0) & (classes < g.classes)
        return data.new_zeros(n * g.classes).index_add_(
            0, (inverse * g.classes + classes)[ok], w2[ok]).view(
            n, g.classes)

    _blend(data, ids, weights, g, t_sum)


def fold_dense(data: torch.Tensor, ids, weights, pixels, features,
               g: Geometry) -> None:
    """Blend one frame's dense records into ``data [V, F]`` in place, in
    ``data``'s dtype: record r carries the feature row
    ``features[pixels[r]]`` (``[P, F]``) where ``fold`` carries a one-hot
    class."""
    def t_sum(inverse, w2, n):
        return data.new_zeros(n, data.shape[1]).index_add_(
            0, inverse, w2[:, None] * features[pixels].to(data.dtype))

    _blend(data, ids, weights, g, t_sum)


def touched_voxels(frames: torch.Tensor, ids: torch.Tensor,
                   voxels: int) -> int:
    """Distinct (frame, voxel) pairs the records touch: each frame's map
    rows, counted apart."""
    return int(torch.unique(frames * voxels + ids).shape[0])


def occupied(data: torch.Tensor, g: Geometry, z_start: int, z_stop: int,
             threshold: float = 0.0) -> torch.Tensor:
    """``[H, W]`` bool: a voxel of the z slice with L1 norm over the
    threshold."""
    grid = data.view(g.height, g.width, g.depth, g.classes)
    return (grid[:, :, z_start:z_stop].abs().sum(-1) > threshold).any(-1)
