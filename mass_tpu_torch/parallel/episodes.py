"""Batched multi-episode mapping service (port of
``mass_tpu.parallel.episodes``).

B independent episodes' one-hot maps live in one voxel-major ``[B*V, F]``
buffer and every call folds one frame per episode into them with one
sort and one launch of the single-map splat kernel, the way
``parallel/fleet.FleetMaps`` updates a family (a ``BatchedMapper`` is a
fleet of one family).  Host simulators meet the device at this batch
boundary.

With a ``(data, map)`` mesh the buffer is cut into ``data * map`` row
slabs, one on each device in mesh order: the ``data`` axis takes
contiguous runs of episodes, and the ``map`` axis cuts each run's rows
(JAX's ``P("data", "map")`` gives each device the same amount of the
same maps, in another order of rows).  Each step makes one launch a slab.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mass_tpu_torch.config import CameraConfig, MapGeometry
from mass_tpu_torch.core.voxelmap import BaseVoxelMap
from mass_tpu_torch.parallel.fleet import FleetMaps
from mass_tpu_torch.parallel.mesh import DeviceMesh

_NAME = "map"


class BatchedMapper:
    """B independent voxel maps (``geometry.feature_size`` classes)
    updated by one splat launch a slab per frame batch.

    Args:
      batch: number of episodes B.
      camera: shared camera intrinsics.
      geometry: per-episode map geometry.
      mesh: (optional) a ``parallel/mesh.DeviceMesh`` with ``data`` and
        ``map`` axes; the maps row-shard over all of its devices.
      device: where the maps live without a mesh; ``None`` means CUDA.
    """

    def __init__(self, batch: int, camera: CameraConfig,
                 geometry: MapGeometry, mesh: Optional[DeviceMesh] = None,
                 device=None):
        self.batch = batch
        self.geometry = geometry
        self.camera = camera
        self.mesh = mesh
        self._fleet = FleetMaps(
            batch, camera, geometry, {_NAME: geometry.feature_size},
            device=device, mesh=mesh,
            mesh_axis=None if mesh is None else mesh.axis_names)
        self.device = self._fleet.device
        self.rays = self._fleet.rays

    def reset(self, episode_index: int, origin) -> None:
        """Zero one episode's map and re-centre it."""
        self._fleet.reset(episode_index, origin)

    def step(self, positions, yaws, elevations, depths, classes) -> None:
        """Fold one frame per episode: ``positions [B, 3]``, ``yaws``,
        ``elevations [B]``, ``depths [B, h, w, 1]`` and integer
        ``classes [B, h, w]``."""
        self._fleet.update_batch(positions, yaws, elevations, depths,
                                 {_NAME: np.asarray(classes, np.int32)})

    def top_down(self, z_start: int = 0, z_stop: int = 32) -> torch.Tensor:
        """``[B, H, W, F]``: each episode's :meth:`VoxelMap.top_down`."""
        return torch.stack([self.voxel_map(e).top_down(z_start, z_stop)
                            for e in range(self.batch)])

    def voxel_map(self, episode_index: int) -> BaseVoxelMap:
        """One episode's map (views of the buffer, ``FleetMaps.view``),
        for the matcher or the planner."""
        return self._fleet.view(_NAME, episode_index)
