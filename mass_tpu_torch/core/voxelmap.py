"""The voxel feature map (port of ``mass_tpu.core.voxelmap``).

The JAX package keeps the map as an immutable pytree in one of two
layouts; its channel-major ``[F, V]`` form exists for the TPU's lane
tiling.  The port stores every map voxel-major ``[V, F]`` with F
unpadded, so a touched voxel is one contiguous row for the splat
kernel, and updates it IN PLACE: at the full 384x384x96x54 geometry the
buffer is 3 GB, and a functional copy per frame would double the memory
traffic.  ``grid()`` returns the same logical ``[H, W, D, F]`` view as
the JAX package (row = flipped world y).

What a map does beyond its storage (binning, the one-hot and dense
updates, the row-local reads and the coordinate transforms) lives in
:class:`BaseVoxelMap`, written against :meth:`~BaseVoxelMap.slabs` and
:meth:`~BaseVoxelMap.rows`; ``parallel/sharding.ShardedVoxelMap`` is the
same map cut into row slabs over several devices.

An update's parts run in ``mass.mapping.records`` (binning, corner
records, the class upsample) and ``mass.mapping.splat`` (sort and
splat) spans (``utils/profiling.span``), as the fleet's do.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple

import numpy as np
import torch

from mass_tpu_torch import resolve_device
from mass_tpu_torch.config import MapGeometry
from mass_tpu_torch.core import geometry as G
from mass_tpu_torch.ops import scatter as S
from mass_tpu_torch.ops import splat as SP
from mass_tpu_torch.utils.profiling import span


def _bins(origin, g: MapGeometry, device):
    ox, oy, oz = (float(np.float32(v)) for v in origin)
    return (G.uniform_bins(ox, g.map_width, g.grid_resolution, device),
            G.uniform_bins(oy, g.map_height, g.grid_resolution, device),
            G.uniform_bins(oz, g.map_depth, g.grid_resolution, device))


class BaseVoxelMap:
    """What every voxel map does through its storage's slabs: a subclass
    gives ``geometry``, the bins ``bins_x/y/z`` and ``device`` (where the
    bins and every read's result live), :meth:`slabs`, :meth:`rows` and
    :meth:`grid`."""

    geometry: MapGeometry

    def slabs(self) -> List[Tuple[int, torch.Tensor]]:
        """``(first voxel, [rows, F] storage)`` of each slab, in voxel
        order."""
        raise NotImplementedError

    def rows(self, reduce: Callable[[torch.Tensor], torch.Tensor]
             ) -> torch.Tensor:
        """``reduce`` of the ``[H, W, D, F]`` grid, for a ``reduce`` that
        maps each grid row on its own (its result leads with ``[H]``), on
        :attr:`device`."""
        raise NotImplementedError

    def grid(self) -> torch.Tensor:
        raise NotImplementedError

    def zero_voxels(self, lo: int, hi: int) -> None:
        """Zero storage rows ``lo:hi`` in place, in every slab they
        cross."""
        for piece in self.pieces(lo, hi):
            piece.zero_()

    def pieces(self, lo: int, hi: int) -> List[torch.Tensor]:
        """The views of storage rows ``lo:hi`` (voxel ids) in each slab
        they cross, in voxel order, each on its slab's device."""
        out = []
        for first, slab in self.slabs():
            a, b = max(lo, first), min(hi, first + slab.shape[0])
            if a < b:
                out.append(slab[a - first:b - first])
        return out

    def reset(self, origin) -> "BaseVoxelMap":
        """Zero the features and re-centre the grid on a new world origin
        (in place; returns the map)."""
        for _, slab in self.slabs():
            slab.zero_()
        self.bins_x, self.bins_y, self.bins_z = _bins(
            origin, self.geometry, self.device)
        return self

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

    def apply_onehot(self, ids, weights, classes) -> "BaseVoxelMap":
        """EMA-blend one frame's one-hot records into the map in place
        (the splat kernel on CUDA, one launch a slab; its plain version
        on the CPU)."""
        apply_onehot_group([self], ids, weights, [classes])
        return self

    def apply_dense(self, ids, weights, features) -> "BaseVoxelMap":
        """EMA-blend one frame's dense records (``features [N, F]``) into
        the map in place, sorted once (the dense splat kernel on CUDA,
        one launch a slab; its plain version on the CPU)."""
        with span("mass.mapping.splat"):
            records = SP.sorted_dense_records(ids, weights,
                                              features.shape[0])
            apply_dense_records(self, records, features)
        return self

    def update_classes(self, rays, position, yaw, elevation, depth,
                       classes, min_ray_depth: float = 0.0,
                       max_ray_depth: float = 10.0) -> "BaseVoxelMap":
        """Project an ``[h, w]`` integer class image (implicit
        ``one_hot(classes, F)`` features) into the map in place."""
        h, w = rays.shape[0], rays.shape[1]
        with span("mass.mapping.records"):
            classes = G.upsample_features(classes[..., None], h, w)[..., 0]
            ids, weights = self.contributions(rays, position, yaw,
                                              elevation, depth,
                                              min_ray_depth, max_ray_depth)
        return self.apply_onehot(ids, weights, classes)

    def update(self, rays, position, yaw, elevation, depth, features,
               min_ray_depth: float = 0.0,
               max_ray_depth: float = 10.0) -> "BaseVoxelMap":
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
        with span("mass.mapping.records"):
            features = G.upsample_features(features, h, w)
            ids, weights = self.contributions(rays, position, yaw,
                                              elevation, depth,
                                              min_ray_depth, max_ray_depth)
        return self.apply_dense(ids, weights, features.reshape(
            -1, self.geometry.feature_size))

    # ------------------------------------------------------------------
    # rendering / reading
    # ------------------------------------------------------------------

    def top_down(self, z_start: int = 0, z_stop: int = 32) -> torch.Tensor:
        """Feature of the top-most non-empty voxel per (row, col) within a
        depth slice; zero where the column is empty."""
        return self.rows(lambda grid: _top_down(grid[:, :, z_start:z_stop]))

    def max_over_depth(self) -> torch.Tensor:
        """``[H, W, F]`` max over the full z extent."""
        return self.rows(lambda grid: grid.amax(dim=2))

    def occupancy_mask(self, z_start: int = 0, z_stop: int = 32,
                       threshold: float = 0.0) -> torch.Tensor:
        """``[H, W]`` bool — any voxel in the z slice has L1 feature norm
        above ``threshold``.  The norm reduces the slice view directly,
        with no ``abs`` copy of the map."""
        return self.rows(lambda grid: (torch.linalg.vector_norm(
            grid[:, :, z_start:z_stop], ord=1, dim=-1) > threshold
        ).any(dim=-1))

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


@dataclasses.dataclass
class VoxelMap(BaseVoxelMap):
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

    def slabs(self) -> List[Tuple[int, torch.Tensor]]:
        return [(0, self.data)]

    def grid(self) -> torch.Tensor:
        """The logical ``[H, W, D, F]`` grid (a view of the storage)."""
        g = self.geometry
        return self.data.view(g.map_height, g.map_width, g.map_depth,
                              g.feature_size)

    def rows(self, reduce: Callable[[torch.Tensor], torch.Tensor]
             ) -> torch.Tensor:
        return reduce(self.grid())

    def with_grid(self, grid: torch.Tensor) -> "VoxelMap":
        """A new map holding ``grid`` (``[H, W, D, F]``) as its storage."""
        g = self.geometry
        data = grid.to(self.device, self.data.dtype).reshape(
            g.num_voxels, g.feature_size).contiguous()
        return dataclasses.replace(self, data=data)

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
        with span("mass.mapping.records"):
            ids, weights = self.contributions_frames(
                rays, positions, yaws, elevations, depths, min_ray_depth,
                max_ray_depth)
            classes = G.upsample_features(classes[..., None], h, w)[..., 0]
        with span("mass.mapping.splat"):
            SP.splat_onehot_frames(self.data, ids, weights,
                                   classes.reshape(classes.shape[0], -1),
                                   self.geometry.interpolation_weight)
        return self


def _top_down(fmap: torch.Tensor) -> torch.Tensor:
    """The feature of each column's top-most non-empty voxel of ``fmap
    [h, W, d, F]``."""
    mask = (fmap != 0).any(dim=-1)
    # index of the last occupied z: cumsum peaks there, masked argmax
    idx = torch.argmax(torch.cumsum(mask, dim=-1) * mask, dim=-1)
    return torch.gather(
        fmap, 2, idx[:, :, None, None].expand(
            -1, -1, 1, fmap.shape[-1]))[:, :, 0]


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


def _shared_slabs(vms) -> List[List[Tuple[int, torch.Tensor]]]:
    """Each map's :meth:`~BaseVoxelMap.slabs`; the maps of one group must
    cut their voxels into the same slabs on the same devices."""
    parts = [vm.slabs() for vm in vms]
    cuts = {tuple((first, slab.shape[0], slab.device)
                  for first, slab in p) for p in parts}
    if len(cuts) != 1:
        raise ValueError(f"the maps of one group must share their slabs' "
                         f"voxels and devices, got {sorted(cuts)}")
    return parts


def apply_onehot_group(vms, ids, weights, classes_list):
    """EMA-blend one frame's shared corner records into the group's
    one-hot maps (one grid) in place, sorted once for the group.  For
    each slab (one for a :class:`VoxelMap`, a row slab of a sharded map
    each), the records' ids re-base to the slab's first voxel and go to
    its device, and the slab's maps go to the splat kernels in chunks of
    at most four: two to four maps in one launch of the multi-map kernel,
    one map in one launch of the single-map kernel.  Each map equals its
    own single-map update bit for bit, so the group equals per-map
    updates, and a sharded map equals the unsharded one.  Runs in one
    ``mass.mapping.splat`` span."""
    vms = list(vms)
    with span("mass.mapping.splat"):
        parts = _shared_slabs(vms)
        first, slab = parts[0][-1]
        SP.check_voxels(first + slab.shape[0])
        records = SP.sorted_records_multi(
            ids, weights, [c.reshape(-1) for c in classes_list])
        iws = [vm.geometry.interpolation_weight for vm in vms]
        for k, (first, slab) in enumerate(parts[0]):
            slab_records = SP.rebase_records(records, first, slab.device)
            datas = [p[k][1] for p in parts]
            for lo in range(0, len(vms), SP.MAX_MAPS):
                chunk = datas[lo:lo + SP.MAX_MAPS]
                classes = slab_records.classes[lo:lo + len(chunk)]
                if len(chunk) == 1:
                    SP.apply_records(chunk[0], slab_records._replace(
                        classes=classes[0]), iws[lo])
                else:
                    SP.apply_records_multi(chunk, slab_records._replace(
                        classes=classes), iws[lo:lo + len(chunk)])
        return vms


def apply_dense_records(vm: BaseVoxelMap, records: SP.DenseRecords,
                        features: torch.Tensor) -> BaseVoxelMap:
    """Fold sorted dense records (``features [P, F]``) into ``vm`` in
    place: one dense splat launch a slab, the ids re-based to the slab's
    first voxel, records and features on its device."""
    first, slab = vm.slabs()[-1]
    SP.check_voxels(first + slab.shape[0])
    features = features.to(torch.float32).contiguous()
    for first, slab in vm.slabs():
        SP.apply_dense_records(
            slab, SP.rebase_records(records, first, slab.device),
            features.to(slab.device), vm.geometry.interpolation_weight)
    return vm
