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

Dense feature families (the ResNet maps of ``--use-feature-matching``)
are ``[B*V, F]`` slabs too: ``update_dense`` sends the B RGB frames
through the backbone in one batched call, bins the B feature cameras as
one batch, and folds the embeddings in with one dense splat launch per
family (families whose masks are equal share one sort).

With a ``mesh``, every family's ``[B*V, F]`` buffer is row-sharded over
the mesh axis (``parallel/sharding.ShardedVoxelMap``): n slabs of
``B*V/n`` rows, one on each of the axis's devices, and each step's sort
serves every slab, one launch a slab.  An episode lies inside one slab
when n divides B; otherwise its rows cross slabs.  Either way
:meth:`FleetMaps.view` is a ``ShardedVoxelMap`` over its pieces, whose
reads land on the fleet's device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from mass_tpu_torch import resolve_device
from mass_tpu_torch.config import CameraConfig, MapGeometry
from mass_tpu_torch.core import geometry as G
from mass_tpu_torch.core.voxelmap import (BaseVoxelMap, VoxelMap, _bins,
                                          apply_dense_records,
                                          apply_onehot_group,
                                          contributions_frames)
from mass_tpu_torch.ops import splat as SP
from mass_tpu_torch.parallel.mesh import canonical_device
from mass_tpu_torch.parallel.sharding import ShardedVoxelMap


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
      mesh / mesh_axis: (optional) row-shard every family's buffer over
        this mesh axis, one slab on each of its devices (the module
        docstring); ``device`` is then the axis's first device.
      dense_sizes, backbone, stride: dense feature families, name ->
        channel count (``{"feature0": 256, "feature1": 256}``), the
        ``[B, h, w, 3]`` -> ``[B, h/stride, w/stride, F]`` backbone that
        feeds them and its stride (``update_dense``).

    ``buffers`` maps each family to its storage: the ``[B*V, F]`` tensor,
    or with a mesh the list of its slabs.
    """

    def __init__(self, batch: int, camera: CameraConfig,
                 geometry: MapGeometry, feature_sizes: Dict[str, int],
                 device=None, mesh=None, mesh_axis: str = "map",
                 dense_sizes: Dict[str, int] = None,
                 backbone: Optional[Callable] = None, stride: int = 4):
        devices = None
        if mesh is not None:
            devices = mesh.axis_devices(mesh_axis)
            rows = batch * geometry.num_voxels
            if rows % len(devices):
                raise ValueError(
                    f"fleet slab rows {rows} must divide over the "
                    f"{len(devices)}-device '{mesh_axis}' axis")
            if device is not None and canonical_device(device) != devices[0]:
                raise ValueError(f"a fleet on {device} cannot shard over a "
                                 f"mesh whose first device is {devices[0]}")
            device = devices[0]
        self.mesh = mesh
        self.batch = batch
        self.camera = camera
        self.base_geometry = geometry
        self.names: List[str] = list(feature_sizes)
        self.dense_names: List[str] = list(dense_sizes or {})
        if self.dense_names and backbone is None:
            raise ValueError("dense feature families need a backbone")
        self._backbone = backbone
        self._stride = stride
        self.device = resolve_device(device)
        self.rays = G.camera_rays(camera.height, camera.width,
                                  camera.focal_length, camera.focal_length,
                                  device=self.device)
        dcam = camera.downsample(stride)
        self.dense_rays = G.camera_rays(dcam.height, dcam.width,
                                        dcam.focal_length, dcam.focal_length,
                                        device=self.device)
        V = self.episode_voxels = geometry.num_voxels
        SP.check_voxels(batch * V)       # the discard id B*V is int32 too
        sizes = {**feature_sizes, **(dense_sizes or {})}
        self._episode_geoms = {
            name: dataclasses.replace(geometry, feature_size=f)
            for name, f in sizes.items()}
        bins = _bins((0.0, 0.0, 0.0), geometry, self.device)

        def fleet_map(f: int):
            # a fleet buffer is one taller map: B*H rows of the same grid
            g = dataclasses.replace(geometry, feature_size=f,
                                    map_height=geometry.map_height * batch)
            if devices is not None:
                return ShardedVoxelMap.create(g, devices)
            return VoxelMap(torch.zeros((batch * V, f), device=self.device),
                            *bins, geometry=g)

        self._fleet_maps = {name: fleet_map(f) for name, f in sizes.items()}
        self.buffers = {name: (vm.slab_data if devices is not None
                               else vm.data)
                        for name, vm in self._fleet_maps.items()}
        self.bins_x, self.bins_y, self.bins_z = (
            b.repeat(batch, 1) for b in bins)            # [B, n + 1] each
        self._offsets = torch.arange(batch, device=self.device) * V
        # per-episode reset generation (maps/layers._BaseMap.bins_epoch):
        # host midpoint caches key on it
        self._bins_epochs = [0] * batch

    def reset(self, episode: int, origin) -> None:
        """Zero one episode's slabs and re-centre its grid (in place)."""
        V = self.episode_voxels
        for vm in self._fleet_maps.values():
            vm.zero_voxels(episode * V, (episode + 1) * V)
        for rows, b in zip((self.bins_x, self.bins_y, self.bins_z),
                           _bins(origin, self.base_geometry, self.device)):
            rows[episode] = b
        self._bins_epochs[episode] += 1

    def bins_epoch(self, episode: int) -> int:
        return self._bins_epochs[episode]

    def view(self, name: str, episode: int) -> BaseVoxelMap:
        """One episode's map, its data and bins views of the fleet's (no
        copy): what the planner and the matcher read.  A ``VoxelMap``;
        in a sharded fleet a ``ShardedVoxelMap`` over the pieces of the
        slabs the episode crosses (one piece when n divides B), each on
        its slab's device, whose reads land on the fleet's device as
        every sharded map's do (``grid()`` gathers there)."""
        V = self.episode_voxels
        pieces = self._fleet_maps[name].pieces(episode * V, (episode + 1) * V)
        bins = (b[episode] for b in (self.bins_x, self.bins_y, self.bins_z))
        geometry = self._episode_geoms[name]
        if self.mesh is None:
            return VoxelMap(pieces[0], *bins, geometry=geometry)
        return ShardedVoxelMap(pieces, *bins, geometry)

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

        Unmasked, every family shares one sort and one launch a slab (the
        multi-map kernel for 2-4 families).  Masked, an inactive
        episode's records go to the discard id for that family, and
        families whose masks are equal share one sort and one launch; a
        family no episode updates is not launched.  The poses reach the
        host at most once.
        """
        B = self.batch
        h, w = self.rays.shape[0], self.rays.shape[1]
        n = h * w
        gids, gw = self._records(self.rays, positions, yaws, elevations,
                                 self._put(depths, torch.float32))
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

        for names, fam_ids in self._family_ids(self.names, gids, active):
            apply_onehot_group([self._fleet_maps[name] for name in names],
                               fam_ids, gw, [cls[name] for name in names])

    def update_dense(self, positions, yaws, elevations, depths, rgbs,
                     active: Dict[str, np.ndarray] = None) -> None:
        """Fold one RGB frame per episode into every dense family, in
        place: the B frames through the backbone in one call, depth
        subsampled at the stride's pixel centres, the B feature cameras
        binned as one batch.

        Args: ``positions [B, 3]``, ``yaws [B]``, ``elevations [B]``,
        ``depths [B, h, w, 1]``, ``rgbs [B, h, w, 3]``; ``active``
        (optional) name -> ``[B]`` bool as in :meth:`update_batch`.
        Records are corner-major over the fleet (record r's pixel is
        ``r % (B*n)``); families with equal masks share one sort, and
        each family takes one dense splat launch.
        """
        if not self.dense_names:
            raise ValueError("no dense feature families configured")
        B, k = self.batch, self._stride
        hd, wd = self.dense_rays.shape[0], self.dense_rays.shape[1]
        feats = self._backbone(self._put(rgbs, torch.float32))
        feats = G.upsample_features(feats, hd, wd)
        feats = feats.reshape(B * hd * wd, feats.shape[-1]).contiguous()
        sub = self._put(depths, torch.float32)[:, k // 2::k, k // 2::k]
        gids, gw = self._records(self.dense_rays, positions, yaws,
                                 elevations, sub.contiguous())
        for names, fam_ids in self._family_ids(self.dense_names, gids,
                                               active):
            records = SP.sorted_dense_records(fam_ids, gw, B * hd * wd)
            for name in names:
                apply_dense_records(self._fleet_maps[name], records, feats)

    def _records(self, rays, positions, yaws, elevations, depths):
        """The B frames' corner records on their episodes' grids, re-based
        into the fleet's rows: ``gids [8, B, n]`` (an invalid pixel of any
        episode at the discard id ``B*V``) and ``weights [8*B*n]``, both
        corner-major (record k's pixel is ``k % (B*n)``), as the sorts and
        the splats read them."""
        B, V = self.batch, self.episode_voxels
        n = rays.shape[0] * rays.shape[1]
        ids, weights = contributions_frames(
            rays, (self.bins_x, self.bins_y, self.bins_z),
            self.base_geometry, self._put(positions, torch.float32), yaws,
            elevations, depths)                                 # [B, 8n]
        gids = torch.where(ids < V, ids + self._offsets[:, None], B * V)
        return (gids.view(B, 8, n).transpose(0, 1),
                weights.view(B, 8, n).transpose(0, 1).reshape(-1))

    def _family_ids(self, names, gids, active):
        """``(families, ids [8*B*n])`` per group of families that the
        same episodes update (``active``: name -> ``[B]`` bool, None for
        all), an inactive episode's records at the discard id; a family
        that no episode updates is left out."""
        B, V = self.batch, self.episode_voxels
        groups: Dict[bytes, List[str]] = {}
        masks = {}
        for name in names:
            mask = (np.ones(B, bool) if active is None
                    else np.asarray(active[name], bool))
            if mask.any():
                groups.setdefault(mask.tobytes(), []).append(name)
                masks[mask.tobytes()] = mask
        for key, group in groups.items():
            mask = masks[key]
            fam_ids = gids
            if not mask.all():
                keep = self._put(mask, torch.bool)[None, :, None]
                fam_ids = torch.where(keep, gids, B * V)
            yield group, fam_ids.reshape(-1)
