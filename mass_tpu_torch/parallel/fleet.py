"""Fleet mapping: B episodes' one-hot maps, each family in one buffer,
updated by one sort and one splat launch per step (port of
``mass_tpu.parallel.fleet``).

A family (``semantic0``, ``occupancy``, ...) keeps all B episodes' maps as
slabs of one voxel-major ``[B*V, F]`` buffer: episode e's map is rows
``e*V:(e+1)*V``, so a fleet buffer is just a taller map and the splat
kernels of the single-episode path serve it unchanged.  Each episode's
frame bins against its own grid (the bins carry a leading ``[B]``), its
corner ids re-base by ``e*V``, and an invalid pixel of any episode goes
to the global discard id ``B*V``, so it cannot leak into the next
episode's first voxel.

Every episode's slab equals, bit for bit, what the single-episode
``VoxelMap`` updates of the same frames give: records sort stably, so
each voxel sums its records in the same order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from mass_tpu_torch import resolve_device
from mass_tpu_torch.config import CameraConfig, MapGeometry
from mass_tpu_torch.core import geometry as G
from mass_tpu_torch.core.voxelmap import (VoxelMap, _bins,
                                          apply_onehot_group,
                                          contributions_frames)
from mass_tpu_torch.ops import splat as SP


class FleetMaps:
    """B episodes x named one-hot map families of one camera and grid.

    Args:
      batch: number of episodes B.
      camera: shared camera intrinsics.
      geometry: per-episode map geometry (``feature_size`` is ignored:
        each family has its own).
      feature_sizes: family name -> channel count, e.g.
        ``{"semantic0": 54, "occupancy": 1}``; families named
        ``occupancy*`` take class 0 for every pixel.
      device: where the buffers live; ``None`` means CUDA.
      mesh, dense_sizes: the JAX package's row-sharded buffers and dense
        feature families, which arrive with later slices of the port.
    """

    def __init__(self, batch: int, camera: CameraConfig,
                 geometry: MapGeometry, feature_sizes: Dict[str, int],
                 device=None, mesh=None, dense_sizes: Dict[str, int] = None):
        if mesh is not None:
            raise NotImplementedError(
                "row-sharded fleet maps (mesh) are ported in slice 4")
        if dense_sizes:
            raise NotImplementedError(
                "dense feature families are ported in slice 3")
        self.batch = batch
        self.camera = camera
        self.base_geometry = geometry
        self.names: List[str] = list(feature_sizes)
        self.device = resolve_device(device)
        self.rays = G.camera_rays(camera.height, camera.width,
                                  camera.focal_length, camera.focal_length,
                                  device=self.device)
        V = self.episode_voxels = geometry.num_voxels
        SP.check_voxels(batch * V)       # the discard id B*V is int32 too
        self._episode_geoms = {
            name: dataclasses.replace(geometry, feature_size=f)
            for name, f in feature_sizes.items()}
        bins = _bins((0.0, 0.0, 0.0), geometry, self.device)
        # a fleet buffer is one taller map: B*H rows of the same grid
        self._fleet_maps = {
            name: VoxelMap(
                torch.zeros((batch * V, f), device=self.device), *bins,
                geometry=dataclasses.replace(
                    geometry, map_height=geometry.map_height * batch,
                    feature_size=f))
            for name, f in feature_sizes.items()}
        self.buffers = {name: vm.data for name, vm in self._fleet_maps.items()}
        self.bins_x, self.bins_y, self.bins_z = (
            b.repeat(batch, 1) for b in bins)            # [B, n + 1] each
        self._offsets = torch.arange(batch, device=self.device) * V
        # per-episode reset generation (maps/layers._BaseMap.bins_epoch):
        # host midpoint caches key on it
        self._bins_epochs = [0] * batch

    def reset(self, episode: int, origin) -> None:
        """Zero one episode's slabs and re-centre its grid (in place)."""
        V = self.episode_voxels
        for buf in self.buffers.values():
            buf[episode * V:(episode + 1) * V].zero_()
        for rows, b in zip((self.bins_x, self.bins_y, self.bins_z),
                           _bins(origin, self.base_geometry, self.device)):
            rows[episode] = b
        self._bins_epochs[episode] += 1

    def bins_epoch(self, episode: int) -> int:
        return self._bins_epochs[episode]

    def view(self, name: str, episode: int) -> VoxelMap:
        """One episode's map as a ``VoxelMap`` whose data and bins are
        views of the fleet's (no copy): what the planner and the matcher
        read."""
        V = self.episode_voxels
        return VoxelMap(self.buffers[name][episode * V:(episode + 1) * V],
                        self.bins_x[episode], self.bins_y[episode],
                        self.bins_z[episode],
                        geometry=self._episode_geoms[name])

    def _put(self, x, dtype) -> torch.Tensor:
        """An input on the buffers' device (host arrays without a sync)."""
        if isinstance(x, torch.Tensor) and x.device == self.device:
            return x.to(dtype)
        return G.to_device(torch.as_tensor(np.asarray(x), dtype=dtype),
                           self.device)

    def update_batch(self, positions, yaws, elevations, depths,
                     classes: Dict[str, np.ndarray],
                     active: Dict[str, np.ndarray] = None) -> None:
        """Fold one frame per episode into every family, in place.

        Args: ``positions [B, 3]``, ``yaws [B]``, ``elevations [B]``,
        ``depths [B, h, w, 1]``, ``classes`` name -> ``[B, ch, cw]``
        (omit occupancy families); ``active`` (optional) name -> ``[B]``
        bool, which episodes update which family this step.

        Unmasked, every family shares one sort and one launch (the
        multi-map kernel for 2-4 families).  Masked, an inactive
        episode's records go to the discard id for that family, and
        families whose masks are equal share one sort and one launch; a
        family no episode updates is not launched.  The poses reach the
        host at most once.
        """
        B, V = self.batch, self.episode_voxels
        h, w = self.rays.shape[0], self.rays.shape[1]
        n = h * w
        ids, weights = contributions_frames(
            self.rays, (self.bins_x, self.bins_y, self.bins_z),
            self.base_geometry, self._put(positions, torch.float32), yaws,
            elevations, self._put(depths, torch.float32))      # [B, 8N]
        gids = torch.where(ids < V, ids + self._offsets[:, None], B * V)
        # the records are corner-major (record k's pixel is k % (B*N)),
        # as the sort and the splat read them: [8, B, N]
        gids = gids.view(B, 8, n).transpose(0, 1)
        gw = weights.view(B, 8, n).transpose(0, 1).reshape(-1)
        cls = {}
        for name in self.names:
            if name in classes:
                up = G.upsample_features(
                    self._put(classes[name], torch.int32)[..., None], h,
                    w)[..., 0]
                cls[name] = up.reshape(-1)
            else:
                cls[name] = torch.zeros(B * n, dtype=torch.int32,
                                        device=self.device)

        groups: Dict[bytes, List[str]] = {}
        masks = {}
        for name in self.names:
            mask = (np.ones(B, bool) if active is None
                    else np.asarray(active[name], bool))
            if mask.any():
                groups.setdefault(mask.tobytes(), []).append(name)
                masks[mask.tobytes()] = mask
        for key, names in groups.items():
            mask = masks[key]
            fam_ids = gids
            if not mask.all():
                keep = self._put(mask, torch.bool)[None, :, None]
                fam_ids = torch.where(keep, gids, B * V)
            apply_onehot_group([self._fleet_maps[name] for name in names],
                               fam_ids.reshape(-1), gw,
                               [cls[name] for name in names])
