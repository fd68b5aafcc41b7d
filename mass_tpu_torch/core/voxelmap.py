"""The voxel feature map (port of ``mass_tpu.core.voxelmap``).

The JAX package keeps the map as an immutable pytree in one of two
layouts; its channel-major ``[F, V]`` form exists for the TPU's lane
tiling.  The port stores every map voxel-major ``[V, F]`` with F
unpadded, so a touched voxel is one contiguous row for the splat
kernel, and updates it IN PLACE: at the full 384x384x96x54 geometry the
buffer is 3 GB, and a functional copy per frame would double the memory
traffic.  ``grid()`` returns the same logical ``[H, W, D, F]`` view as
the JAX package (row = flipped world y).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from mass_tpu_torch import resolve_device
from mass_tpu_torch.config import MapGeometry
from mass_tpu_torch.core import geometry as G
from mass_tpu_torch.ops import scatter as S
from mass_tpu_torch.ops import splat as SP


def _bins(origin, g: MapGeometry, device):
    ox, oy, oz = (float(np.float32(v)) for v in origin)
    return (G.uniform_bins(ox, g.map_width, g.grid_resolution, device),
            G.uniform_bins(oy, g.map_height, g.grid_resolution, device),
            G.uniform_bins(oz, g.map_depth, g.grid_resolution, device))


@dataclasses.dataclass
class VoxelMap:
    """Voxel grid state: ``data [V, F]`` plus per-axis bin edges (world
    positions of voxel boundaries, recomputed when the map is re-centred
    on a new origin)."""

    data: torch.Tensor    # [V, F]
    bins_x: torch.Tensor  # [W + 1]
    bins_y: torch.Tensor  # [H + 1]
    bins_z: torch.Tensor  # [D + 1]
    geometry: MapGeometry

    @property
    def device(self) -> torch.device:
        return self.data.device

    @staticmethod
    def create(geometry: MapGeometry,
               origin: Tuple[float, float, float] = (0.0, 0.0, 0.0),
               device=None, dtype=torch.float32) -> "VoxelMap":
        """Fresh zeroed map centred on ``origin`` = (x, y, z) world."""
        device = resolve_device(device)
        g = geometry
        data = torch.zeros((g.num_voxels, g.feature_size), dtype=dtype,
                           device=device)
        return VoxelMap(data, *_bins(origin, g, device), geometry=g)

    def reset(self, origin) -> "VoxelMap":
        """Zero the features and re-centre the grid on a new world origin
        (in place; returns the map)."""
        self.data.zero_()
        self.bins_x, self.bins_y, self.bins_z = _bins(
            origin, self.geometry, self.device)
        return self

    def grid(self) -> torch.Tensor:
        """The logical ``[H, W, D, F]`` grid (a view of the storage)."""
        g = self.geometry
        return self.data.view(g.map_height, g.map_width, g.map_depth,
                              g.feature_size)

    def with_grid(self, grid: torch.Tensor) -> "VoxelMap":
        """A new map holding ``grid`` (``[H, W, D, F]``) as its storage."""
        g = self.geometry
        data = grid.to(self.device, self.data.dtype).reshape(
            g.num_voxels, g.feature_size).contiguous()
        return dataclasses.replace(self, data=data)

    # ------------------------------------------------------------------
    # the hot path
    # ------------------------------------------------------------------

    def contributions(self, rays, position, yaw, elevation, depth,
                      min_ray_depth: float = 0.0,
                      max_ray_depth: float = 10.0):
        """Orient + bin + trilinear corner records for one frame:
        ``(ids, weights)``, shared by every map of the same camera and
        grid.  With host arrays ``yaw``/``elevation [T]`` (``position
        [T, 3]``, ``depth [T, h, w, 1]``) it bins T frames as one batch:
        ``[T, 8N]`` records, frame t equal to its own one-frame call."""
        return contributions(rays, self.bins, self.geometry, position, yaw,
                             elevation, depth, min_ray_depth, max_ray_depth)

    def contributions_frames(self, rays, positions, yaws, elevations,
                             depths, min_ray_depth: float = 0.0,
                             max_ray_depth: float = 10.0):
        """:meth:`contributions` of T frames as one batch: the poses
        reach the host once (one sync on a card), where the T rotations
        are built as for one frame.  Returns ``[T, 8N]`` ids and
        weights."""
        return contributions_frames(rays, self.bins, self.geometry,
                                    positions, yaws, elevations, depths,
                                    min_ray_depth, max_ray_depth)

    def apply_onehot(self, ids, weights, classes) -> "VoxelMap":
        """EMA-blend one frame's one-hot records into the map in place
        (the splat kernel on CUDA, its plain version on the CPU)."""
        SP.splat_onehot(self.data, ids, weights, classes.reshape(-1),
                        self.geometry.interpolation_weight)
        return self

    def update_classes(self, rays, position, yaw, elevation, depth,
                       classes, min_ray_depth: float = 0.0,
                       max_ray_depth: float = 10.0) -> "VoxelMap":
        """Project an ``[h, w]`` integer class image (implicit
        ``one_hot(classes, F)`` features) into the map in place."""
        h, w = rays.shape[0], rays.shape[1]
        classes = G.upsample_features(classes[..., None], h, w)[..., 0]
        ids, weights = self.contributions(rays, position, yaw, elevation,
                                          depth, min_ray_depth,
                                          max_ray_depth)
        return self.apply_onehot(ids, weights, classes)

    def update_classes_frames(self, rays, positions, yaws, elevations,
                              depths, classes, min_ray_depth: float = 0.0,
                              max_ray_depth: float = 10.0) -> "VoxelMap":
        """Fold T frames into the map in place, in order, in one launch of
        the frames kernel: equal to T calls of :meth:`update_classes`.

        Args:
          positions: ``[T, 3]``; yaws / elevations: ``[T]``;
          depths: ``[T, h, w, 1]``; classes: ``[T, ch, cw]`` (integer,
          upsampled to the ray grid).
        """
        h, w = rays.shape[0], rays.shape[1]
        ids, weights = self.contributions_frames(
            rays, positions, yaws, elevations, depths, min_ray_depth,
            max_ray_depth)
        classes = G.upsample_features(classes[..., None], h, w)[..., 0]
        SP.splat_onehot_frames(self.data, ids, weights,
                               classes.reshape(classes.shape[0], -1),
                               self.geometry.interpolation_weight)
        return self

    def update(self, rays, position, yaw, elevation, depth, features,
               min_ray_depth: float = 0.0,
               max_ray_depth: float = 10.0) -> "VoxelMap":
        """Project one frame of dense per-pixel features into the map in
        place (the dense splat kernel on CUDA, its plain version on the
        CPU).

        Args:
          rays: camera-frame ray directions ``[h, w, 3]``.
          position: camera origin, world ``[3]``; yaw / elevation:
            radians.
          depth: ``[h, w, 1]`` ray lengths.
          features: ``[fh, fw, F]`` feature image, integer-upsampled to
            the ray grid if smaller.
        """
        h, w = rays.shape[0], rays.shape[1]
        features = G.upsample_features(features, h, w)
        ids, weights = self.contributions(rays, position, yaw, elevation,
                                          depth, min_ray_depth,
                                          max_ray_depth)
        SP.splat_dense(self.data, ids, weights,
                       features.reshape(-1, self.geometry.feature_size),
                       self.geometry.interpolation_weight)
        return self

    # ------------------------------------------------------------------
    # rendering / reading
    # ------------------------------------------------------------------

    def top_down(self, z_start: int = 0, z_stop: int = 32) -> torch.Tensor:
        """Feature of the top-most non-empty voxel per (row, col) within a
        depth slice; zero where the column is empty."""
        fmap = self.grid()[:, :, z_start:z_stop]
        mask = (fmap != 0).any(dim=-1)
        # index of the last occupied z: cumsum peaks there, masked argmax
        idx = torch.argmax(torch.cumsum(mask, dim=-1) * mask, dim=-1)
        return torch.gather(
            fmap, 2, idx[:, :, None, None].expand(
                -1, -1, 1, fmap.shape[-1]))[:, :, 0]

    def max_over_depth(self) -> torch.Tensor:
        """``[H, W, F]`` max over the full z extent."""
        return self.grid().amax(dim=2)

    def occupancy_mask(self, z_start: int = 0, z_stop: int = 32,
                       threshold: float = 0.0) -> torch.Tensor:
        """``[H, W]`` bool — any voxel in the z slice has L1 feature norm
        above ``threshold``.  The norm reduces the slice view directly,
        with no ``abs`` copy of the map."""
        sl = self.grid()[:, :, z_start:z_stop]
        l1 = torch.linalg.vector_norm(sl, ord=1, dim=-1)
        return (l1 > threshold).any(dim=-1)

    # ------------------------------------------------------------------
    # coordinate transforms
    # ------------------------------------------------------------------

    @property
    def bins(self):
        return self.bins_x, self.bins_y, self.bins_z

    def _tensor(self, coords, dtype=None) -> torch.Tensor:
        t = coords if isinstance(coords, torch.Tensor) \
            else torch.as_tensor(np.asarray(coords))
        t = t.to(self.device)
        return t if dtype is None else t.to(dtype)

    def clamp_to_world(self, coords) -> torch.Tensor:
        """Clamp world xyz (or xy) into the span of voxel-centre
        extrema."""
        return _clamp_to_world(self.bins, self._tensor(coords, torch.float32))

    def clamp_to_map(self, coords) -> torch.Tensor:
        """Clamp map xyz (or xy) cell coordinates into the grid."""
        g = self.geometry
        coords = self._tensor(coords)
        upper = torch.tensor(
            [g.map_width - 1, g.map_height - 1, g.map_depth - 1],
            dtype=coords.dtype, device=self.device)
        return torch.minimum(coords.clamp_min(0), upper[:coords.shape[-1]])

    def map_to_world(self, coords) -> torch.Tensor:
        """Map cell coords (xyz order, float) -> world, interpolating
        between voxel-centre positions (y reads the flipped table)."""
        coords = self.clamp_to_map(self._tensor(coords, torch.float32))
        floored = torch.floor(coords)
        idx = floored.to(torch.int64)
        mid_x = (self.bins_x[:-1] + self.bins_x[1:]) / 2
        mid_y = torch.flip((self.bins_y[:-1] + self.bins_y[1:]) / 2, [0])
        mid_z = (self.bins_z[:-1] + self.bins_z[1:]) / 2

        def _interp(mids, i, frac):
            left = mids[i]
            right = mids[(i + 1).clamp(0, mids.shape[0] - 1)]
            return left + (right - left) * frac

        frac = coords - floored
        out = [_interp(mid_x, idx[..., 0], frac[..., 0]),
               _interp(mid_y, idx[..., 1], frac[..., 1])]
        if coords.shape[-1] == 3:
            out.append(_interp(mid_z, idx[..., 2], frac[..., 2]))
        return torch.stack(out, dim=-1)

    def world_to_map(self, coords) -> torch.Tensor:
        """World xyz (or xy) -> integer map cell coords, y flipped."""
        return world_to_cells(self.bins, self._tensor(coords, torch.float32))


def contributions(rays, bins, geometry: MapGeometry, position, yaw,
                  elevation, depth, min_ray_depth: float = 0.0,
                  max_ray_depth: float = 10.0):
    """:meth:`VoxelMap.contributions` on a grid's ``bins`` (x, y, z):
    ``[n]`` edges each, or ``[T, n]`` when each of T frames (host
    ``yaw``/``elevation [T]``) bins against its own grid."""
    g = geometry
    oriented = G.orient_rays(rays, yaw, elevation)
    points = G.bin_rays(*bins, position, oriented, depth,
                        min_ray_depth=min_ray_depth,
                        max_ray_depth=max_ray_depth,
                        resolution=g.grid_resolution)
    return S.corner_contributions(
        points, (g.map_height, g.map_width, g.map_depth))


def contributions_frames(rays, bins, geometry: MapGeometry, positions, yaws,
                         elevations, depths, min_ray_depth: float = 0.0,
                         max_ray_depth: float = 10.0):
    """:func:`contributions` of T frames as one batch, with the poses
    copied to the host once (no copy for host poses)."""
    yaws, elevations = torch.stack([torch.as_tensor(yaws),
                                    torch.as_tensor(elevations)]).cpu()
    return contributions(rays, bins, geometry, positions, yaws.numpy(),
                         elevations.numpy(), depths, min_ray_depth,
                         max_ray_depth)


def _clamp_to_world(bins, coords: torch.Tensor) -> torch.Tensor:
    bx, by, bz = bins
    lower = torch.stack([(bx[..., 0] + bx[..., 1]) / 2,
                         (by[..., 0] + by[..., 1]) / 2,
                         (bz[..., 0] + bz[..., 1]) / 2], dim=-1)
    upper = torch.stack([(bx[..., -1] + bx[..., -2]) / 2,
                         (by[..., -1] + by[..., -2]) / 2,
                         (bz[..., -1] + bz[..., -2]) / 2], dim=-1)
    k = coords.shape[-1]
    return torch.minimum(torch.maximum(coords, lower[..., :k]),
                         upper[..., :k])


def world_to_cells(bins, coords: torch.Tensor) -> torch.Tensor:
    """World xyz (or xy) ``coords [..., k]`` (float32, on the bins'
    device) -> integer map cells, y flipped, clamped into the grid.
    ``bins`` are the (x, y, z) edges of one grid (``[n]`` each), or of G
    grids (``[G, n]`` each) against ``coords [G, k]``."""
    bx, by, bz = bins
    coords = _clamp_to_world(bins, coords)
    ix = G.bucketize(coords[..., 0], bx)
    iy = by.shape[-1] - 2 - G.bucketize(coords[..., 1], by)
    out = [ix, iy]
    if coords.shape[-1] == 3:
        out.append(G.bucketize(coords[..., 2], bz))
    return torch.stack(out, dim=-1)


class HostMapToWorld:
    """NumPy ``map_to_world`` for host-side callers (path backtracking,
    goal sampling): the bins are read off the device once per reset and
    the midpoint tables cached.  Callers that know the reset generation
    (map layers carry ``bins_epoch``) pass ``epoch=``; otherwise the
    cache keys on the bins tensor's identity, which the port replaces
    only on reset."""

    def __init__(self):
        self._key = None
        self._epoch = None
        self._mids = None

    def _tables(self, vm: VoxelMap, epoch=None):
        if epoch is not None:
            stale = self._mids is None or self._epoch != epoch
        else:
            stale = self._key is not vm.bins_x
        if stale:
            # one device-to-host copy for the three tables
            nx, ny = vm.bins_x.shape[0], vm.bins_y.shape[0]
            flat = torch.cat([vm.bins_x, vm.bins_y, vm.bins_z]).cpu()
            flat = flat.numpy()
            bx, by, bz = flat[:nx], flat[nx:nx + ny], flat[nx + ny:]
            self._mids = ((bx[:-1] + bx[1:]) / 2,
                          ((by[:-1] + by[1:]) / 2)[::-1].copy(),
                          (bz[:-1] + bz[1:]) / 2)
            self._key = vm.bins_x
            self._epoch = epoch
        return self._mids

    def __call__(self, vm: VoxelMap, coords, epoch=None) -> np.ndarray:
        mids = self._tables(vm, epoch=epoch)
        g = vm.geometry
        upper = np.asarray(
            [g.map_width - 1, g.map_height - 1, g.map_depth - 1],
            np.float32)
        coords = np.asarray(coords, np.float32)
        k = coords.shape[-1]
        coords = np.clip(coords, 0, upper[:k])
        floored = np.floor(coords)
        idx = floored.astype(np.int32)
        frac = (coords - floored).astype(np.float32)

        out = []
        for a in range(k):
            m = mids[a].astype(np.float32)
            left = m[idx[..., a]]
            right = m[np.clip(idx[..., a] + 1, 0, m.shape[0] - 1)]
            out.append(left + (right - left) * frac[..., a])
        return np.stack(out, axis=-1)


def apply_onehot_group(vms, ids, weights, classes_list):
    """EMA-blend one frame's shared corner records into the group's
    one-hot maps (one grid) in place, sorted once for the group.  The maps
    go to the splat kernels in chunks of at most four: two to four maps in
    one launch of the multi-map kernel, one map in one launch of the
    single-map kernel.  Each map equals its own single-map update bit for
    bit, so the group equals per-map updates."""
    vms = list(vms)
    SP.check_voxels(max(vm.data.shape[0] for vm in vms))
    records = SP.sorted_records_multi(
        ids, weights, [c.reshape(-1) for c in classes_list])
    for lo in range(0, len(vms), SP.MAX_MAPS):
        chunk = vms[lo:lo + SP.MAX_MAPS]
        classes = records.classes[lo:lo + len(chunk)]
        iws = [vm.geometry.interpolation_weight for vm in chunk]
        if len(chunk) == 1:
            SP.apply_records(chunk[0].data, records._replace(
                classes=classes[0]), iws[0])
        else:
            SP.apply_records_multi([vm.data for vm in chunk],
                                   records._replace(classes=classes), iws)
    return vms
