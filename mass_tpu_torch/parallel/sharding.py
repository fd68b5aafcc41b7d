"""Row-sharded voxel maps over a device mesh (port of
``mass_tpu.parallel.sharding``).

The voxel grid cuts cleanly into slabs of voxel ids: with n devices on
the mesh axis, device k owns the voxel-major slab ``[V/n, F]`` of ids
``k*V/n`` up to ``(k+1)*V/n`` (``H/n`` map rows when n divides H).  A
frame's update makes no collective and no host sync: the frame is binned
and its records sorted once, on the first device, as for one map; for
slab k the sorted ids re-base by ``k*V/n`` (``ops/splat.rebase_records``)
and the records go to slab k's device, where one ordinary splat launch
updates the slab.  Re-basing keeps the ids in order, and the kernels and
their plain versions skip ids below 0 and from the slab's end on, so no
slab needs its share of the stream cut out (which would need the cut's
position on the host).  A voxel's run lies wholly in one slab and sums in
the same record order as in the unsharded map, so a sharded map equals
the unsharded one bit for bit, on the CPU and on a card (the JAX
package's own sharded maps agree with its unsharded ones within 1e-5).

Reads:

- the row-local reads (``top_down``, ``max_over_depth``,
  ``occupancy_mask``, ``nav/grid``'s observed cells) reduce each slab
  where it lies and join the ``[H, W, ...]`` results on the first device,
  when every slab holds whole map rows (``V/n`` a multiple of ``W*D``:
  every n of 2, 4 or 8 at the full 384-row width);
- every other read goes through :meth:`ShardedVoxelMap.grid`, which
  gathers the slabs into one ``[H, W, D, F]`` tensor on the first
  device: a whole map there, 3.06 GB at 384x384x96x54.  The matcher,
  snapshots, visualization, the replay digest and ``convert`` read so.

The bins live on the first device, where the frame is binned.  Each
slab is an allocation of its own, also when several lie on one card.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

from mass_tpu_torch.config import MapGeometry
from mass_tpu_torch.core.voxelmap import BaseVoxelMap, VoxelMap, _bins
from mass_tpu_torch.parallel.mesh import DeviceMesh, canonical_device


def check_divides(num_voxels: int, n: int, axis: str = "map") -> None:
    """The JAX package's rule: the voxels divide over the axis."""
    if num_voxels % n:
        raise ValueError(f"num_voxels {num_voxels} must divide over the "
                         f"{n}-device '{axis}' axis")


class ShardedVoxelMap(BaseVoxelMap):
    """A voxel map as row slabs ``[rows_k, F]`` in voxel order, slab k on
    its own device, with its bins on the first device (where every read's
    result lands).  :meth:`create` and :func:`shard_voxelmap` cut n equal
    slabs; ``parallel/fleet.FleetMaps.view`` takes an episode's pieces of
    the fleet's slabs, which need not be equal.

    Its updates and reads are :class:`~mass_tpu_torch.core.voxelmap.
    VoxelMap`'s (``BaseVoxelMap``): one splat launch a slab, the
    row-local reads a slab at a time, every other read through the
    gathered :meth:`grid`.  ``update_classes_frames`` has no sharded form
    (the JAX package's takes no mesh either).
    """

    def __init__(self, slab_data: Sequence[torch.Tensor], bins_x, bins_y,
                 bins_z, geometry: MapGeometry):
        self.slab_data: List[torch.Tensor] = list(slab_data)
        self.bins_x, self.bins_y, self.bins_z = bins_x, bins_y, bins_z
        self.geometry = geometry
        if sum(s.shape[0] for s in self.slab_data) != geometry.num_voxels:
            raise ValueError(
                f"{len(self.slab_data)} slabs of "
                f"{[tuple(s.shape) for s in self.slab_data]} do not hold "
                f"{geometry.num_voxels} voxels")

    @staticmethod
    def create(geometry: MapGeometry, devices: Sequence,
               origin: Tuple[float, float, float] = (0.0, 0.0, 0.0),
               dtype=torch.float32, axis: str = "map") -> "ShardedVoxelMap":
        """A fresh zeroed map centred on ``origin``, one slab on each of
        ``devices`` (the devices of the mesh axis ``axis``)."""
        devices = [canonical_device(d) for d in devices]
        g = geometry
        check_divides(g.num_voxels, len(devices), axis)
        rows = g.num_voxels // len(devices)
        slabs = [torch.zeros((rows, g.feature_size), dtype=dtype, device=d)
                 for d in devices]
        return ShardedVoxelMap(slabs, *_bins(origin, g, devices[0]), g)

    @property
    def device(self) -> torch.device:
        """The first device: the bins and every read's result."""
        return self.bins_x.device

    @property
    def devices(self) -> List[torch.device]:
        return [s.device for s in self.slab_data]

    def slabs(self) -> List[Tuple[int, torch.Tensor]]:
        out, first = [], 0
        for s in self.slab_data:
            out.append((first, s))
            first += s.shape[0]
        return out

    def grid(self) -> torch.Tensor:
        """The logical ``[H, W, D, F]`` grid, gathered on the first
        device (a copy, a whole map; a view only for one slab that lies
        there)."""
        g = self.geometry
        parts = [s.to(self.device) for s in self.slab_data]
        data = parts[0] if len(parts) == 1 else torch.cat(parts)
        return data.view(g.map_height, g.map_width, g.map_depth,
                         g.feature_size)

    def rows(self, reduce: Callable[[torch.Tensor], torch.Tensor]
             ) -> torch.Tensor:
        """``reduce`` of each slab's rows where the slab lies, joined on
        the first device; on the gathered grid when a slab holds part of
        a row."""
        g = self.geometry
        row = g.map_width * g.map_depth
        if any(s.shape[0] % row for s in self.slab_data):
            return reduce(self.grid())
        return torch.cat([reduce(s.view(-1, g.map_width, g.map_depth,
                                        g.feature_size)).to(self.device)
                          for s in self.slab_data])

def shard_voxelmap(vm: VoxelMap, mesh: DeviceMesh,
                   axis: str = "map") -> ShardedVoxelMap:
    """``vm``'s state as a :class:`ShardedVoxelMap` over the devices of
    ``axis`` (each slab a copy; ``vm`` is left as it is), its bins on the
    first device."""
    devices = mesh.axis_devices(axis)
    g = vm.geometry
    check_divides(g.num_voxels, len(devices), axis)
    rows = g.num_voxels // len(devices)
    slabs = [vm.data[k * rows:(k + 1) * rows].to(d, copy=True)
             for k, d in enumerate(devices)]
    return ShardedVoxelMap(slabs, *(b.to(devices[0], copy=True)
                                    for b in vm.bins), g)


def sharded_update_fn(mesh: DeviceMesh, geometry: MapGeometry,
                      axis: str = "map", onehot: bool = False,
                      min_ray_depth: float = 0.0,
                      max_ray_depth: float = 10.0):
    """``(vm, rays, position, yaw, elevation, depth, features) -> vm``
    for a :class:`ShardedVoxelMap` over ``axis``, updated in place.

    ``features`` is an ``[h, w]`` class-id image when ``onehot`` (the
    occupancy and semantic path: one single-map splat launch a slab), else
    an ``[h, w, F]`` feature image (one dense splat launch a slab)."""
    n = mesh.shape[axis]
    check_divides(geometry.num_voxels, n, axis)

    def update(vm: ShardedVoxelMap, rays, position, yaw, elevation, depth,
               features) -> ShardedVoxelMap:
        if not isinstance(vm, ShardedVoxelMap) or len(vm.slab_data) != n:
            raise ValueError(f"expected a map sharded over the {n}-device "
                             f"'{axis}' axis (shard_voxelmap)")
        step = vm.update_classes if onehot else vm.update
        return step(rays, position, yaw, elevation, depth, features,
                    min_ray_depth, max_ray_depth)

    return update
