"""Camera / world geometry for RGB-D unprojection (port of
``mass_tpu.core.geometry``).

Pinhole ray generation in the OpenGL convention, camera-to-world
rotation from a (yaw, elevation) pose, and uniform-grid binning of ray
endpoints with validity masking.  Binning stays fully masked and
fixed-shape, as in the JAX package: every pixel keeps a slot, and
invalid pixels carry ``valid=False`` so the splat routes them to the
discard id.

Precision: everything is strict float32.  The 3x3 rotation is written
out as elementwise products (no matmul, so no TF32), and the rotation
itself is computed on the host from the scalar pose, so a CPU run and a
CUDA run bin every pixel identically.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


def spherical_to_cartesian(yaw: float, elevation: float) -> np.ndarray:
    """Unit vector for a (yaw, elevation) pair, z-up, zero yaw and
    elevation along +x, yaw counter-clockwise (float32, host)."""
    f = np.float32
    cy, sy = f(math.cos(float(yaw))), f(math.sin(float(yaw)))
    ce, se = f(math.cos(float(elevation))), f(math.sin(float(elevation)))
    return np.array([cy * ce, sy * ce, se], np.float32)


def camera_rays(image_height: int, image_width: int,
                focal_length_y: float, focal_length_x: float,
                device=None) -> torch.Tensor:
    """Per-pixel ray directions ``[height, width, 3]`` for a pinhole camera
    looking down -z, y up (built in float64 with numpy, stored float32 —
    the same construction as the JAX package)."""
    y, x = np.meshgrid(np.arange(image_height, dtype=np.float64),
                       np.arange(image_width, dtype=np.float64),
                       indexing="ij")
    rays_y = (y - 0.5 * float(image_height - 1)) / focal_length_y
    rays_x = (x - 0.5 * float(image_width - 1)) / focal_length_x
    rays = np.stack([rays_x, -rays_y, -np.ones_like(rays_x)], axis=-1)
    return torch.tensor(rays, dtype=torch.float32, device=device)


def camera_rotation(yaw: float, elevation: float) -> np.ndarray:
    """3x3 camera-to-world rotation with columns ``[right, up, -eye]``;
    the eye looks along (yaw, elevation) and the up vector along
    (yaw, elevation + pi/2)."""
    eye = spherical_to_cartesian(yaw, elevation)
    up = spherical_to_cartesian(
        yaw, np.float32(elevation) + np.float32(np.pi / 2))
    right = np.cross(eye, up).astype(np.float32)
    return np.stack([right, up, -eye], axis=-1)


def orient_rays(rays: torch.Tensor, yaw: float,
                elevation: float) -> torch.Tensor:
    """Rotate camera-frame rays ``[..., 3]`` into the world frame:
    ``out[..., i] = sum_j rays[..., j] * R[i, j]`` in float32."""
    rot = camera_rotation(yaw, elevation)
    r0, r1, r2 = rays[..., 0], rays[..., 1], rays[..., 2]
    return torch.stack(
        [r0 * float(rot[i, 0]) + r1 * float(rot[i, 1])
         + r2 * float(rot[i, 2]) for i in range(3)], dim=-1)


def uniform_bins(origin: float, num_cells: int, resolution: float,
                 device=None) -> torch.Tensor:
    """Voxel-boundary positions for one axis: ``num_cells + 1`` edges
    centred on ``origin``, ``f32(lo) + f32(i) * f32(res)``."""
    o = torch.tensor(float(origin), dtype=torch.float32, device=device)
    lo = o - float(np.float32((num_cells + 1) * resolution / 2.0))
    i = torch.arange(num_cells + 1, dtype=torch.float32, device=device)
    return lo + i * float(np.float32(resolution))


def _edge(bins: torch.Tensor, idx: torch.Tensor,
          resolution=None) -> torch.Tensor:
    """World position of edge ``idx``: recomputed analytically with the
    construction resolution (bit-identical to ``bins[idx]``), else
    gathered."""
    if resolution is None:
        return bins[idx]
    return bins[0] + idx.to(torch.float32) * float(np.float32(resolution))


def bucketize(x: torch.Tensor, bins: torch.Tensor,
              resolution=None) -> torch.Tensor:
    """Index ``i`` with ``bins[i] <= x < bins[i+1]``; -1 below and
    ``len(bins)-1`` at or above the last edge (int64).

    Analytic division plus a one-step correction against the true edges
    — the JAX package's rule, which equals
    ``torch.bucketize(x, bins, right=True) - 1`` on uniform bins but is
    not computed that way.
    """
    n = bins.shape[0]
    res = (bins[1] - bins[0]) if resolution is None \
        else float(np.float32(resolution))
    # clamp while still float: the int conversion of an out-of-range
    # float is undefined in torch (XLA saturates)
    idx = torch.floor((x - bins[0]) / res).clamp(-1, n - 1).to(torch.int64)
    safe = idx.clamp(0, n - 1)
    below = x < _edge(bins, safe, resolution)
    above = x >= _edge(bins, (idx + 1).clamp(0, n - 1), resolution)
    idx = torch.where((idx >= 0) & below, idx - 1, idx)
    idx = torch.where((idx < n - 1) & above, idx + 1, idx)
    return idx.clamp(-1, n - 1)


class BinnedPoints(NamedTuple):
    """Fixed-shape binned point cloud for one frame (all ``[h, w]``):
    cell indices per axis (y already flipped to map-row order), the
    fraction through each cell (y ratio reversed), and the validity
    mask."""

    ind_x: torch.Tensor
    ind_y: torch.Tensor
    ind_z: torch.Tensor
    ratio_x: torch.Tensor
    ratio_y: torch.Tensor
    ratio_z: torch.Tensor
    valid: torch.Tensor


def bin_rays(bins_x, bins_y, bins_z, origin, rays, depth,
             min_ray_depth: float = 0.0,
             max_ray_depth: float = 10.0,
             resolution: float = None) -> BinnedPoints:
    """Bin world-frame ray endpoints ``origin + rays * depth`` into voxel
    cells with validity masking; the y index is flipped
    (``len(bins_y) - 2 - ind_y``) and its ratio reversed."""
    points = origin[None, None, :] + rays * depth
    px, py, pz = points[..., 0], points[..., 1], points[..., 2]

    ind_x = bucketize(px, bins_x, resolution)
    ind_y = bucketize(py, bins_y, resolution)
    ind_z = bucketize(pz, bins_z, resolution)

    d = depth[..., 0]
    valid = ((d >= min_ray_depth) & (d <= max_ray_depth) &
             (ind_x >= 0) & (ind_x < bins_x.shape[0] - 1) &
             (ind_y >= 0) & (ind_y < bins_y.shape[0] - 1) &
             (ind_z >= 0) & (ind_z < bins_z.shape[0] - 1))

    def _ratio(p, ind, bins):
        safe = ind.clamp(0, bins.shape[0] - 2)
        left = _edge(bins, safe, resolution)
        right = _edge(bins, safe + 1, resolution)
        return (p - left) / (right - left)

    ratio_x = _ratio(px, ind_x, bins_x)
    ratio_y = _ratio(py, ind_y, bins_y)
    ratio_z = _ratio(pz, ind_z, bins_z)

    zero = torch.zeros_like(ind_x)
    half = torch.full_like(ratio_x, 0.5)
    return BinnedPoints(
        ind_x=torch.where(valid, ind_x, zero),
        ind_y=torch.where(valid, bins_y.shape[0] - 2 - ind_y, zero),
        ind_z=torch.where(valid, ind_z, zero),
        ratio_x=torch.where(valid, ratio_x, half),
        ratio_y=torch.where(valid, 1.0 - ratio_y, half),
        ratio_z=torch.where(valid, ratio_z, half),
        valid=valid)


def upsample_features(features: torch.Tensor, height: int,
                      width: int) -> torch.Tensor:
    """Nearest-repeat a ``[h, w, F]`` feature image up to
    ``[height, width, F]`` by integer factors."""
    fh, fw = features.shape[0], features.shape[1]
    if fh != height:
        features = features.repeat_interleave(height // fh, dim=0)
    if fw != width:
        features = features.repeat_interleave(width // fw, dim=1)
    return features
