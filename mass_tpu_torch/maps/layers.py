"""Voxel-map layers: occupancy, semantic, dense-feature and CLIP (port
of ``mass_tpu.maps.layers``).

Each layer pairs a per-layer encoder with a ``VoxelMap`` on the layer's
device:

  * OccupancyMap -- 1 channel of ones per depth pixel;
  * SemanticMap  -- one-hot class probabilities from the segmentation;
  * FeatureMap   -- backbone embeddings at 1/stride of the camera's
    resolution, with depth subsampled at the stride's pixel centres
    (reference: resnet_projection_layer.py:121-213);
  * ClipMap      -- a whole-image embedding at the centre ray (a 1x1
    feature camera; reference: clip_projection_layer.py:61-194).

``MapSet.update_group`` folds one observation into several layers: the
orient/bin/corner pass runs once per camera and grid for the one-hot
layers, and each group of them splats from the shared records; a dense
layer (``shared_onehot`` False) runs its own update, with its own
camera, through the dense splat.

``mesh`` (optional) row-shards a layer's map over the mesh's ``map``
axis (``parallel/sharding.py``): n slabs, one on each of the axis's devices,
each updated by its own splat launch from the frame's one binning pass;
the layer's ``device`` is the axis's first device.

An update's parts run in ``mass.mapping.*`` spans as the fleet's do
(``utils/profiling.span``): ``upload`` (the observation's pose, depth
and class image or RGB to the layer's device), ``records`` and
``splat``.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from mass_tpu_torch import resolve_device
from mass_tpu_torch.config import CameraConfig, MapGeometry
from mass_tpu_torch.core import geometry as G
from mass_tpu_torch.core.voxelmap import VoxelMap, apply_onehot_group
from mass_tpu_torch.parallel.mesh import canonical_device
from mass_tpu_torch.parallel.sharding import ShardedVoxelMap
from mass_tpu_torch.utils.profiling import span


def _pose_args(observation: Dict, device):
    """(position [3], yaw, elevation, depth [h, w, 1]) of an observation;
    the pose stays host scalars (the rotation is built on the host)."""
    position = torch.as_tensor(
        np.asarray(observation["position"], np.float32), device=device)
    depth = torch.as_tensor(np.asarray(observation["depth"], np.float32),
                            device=device)
    return (position, float(np.float32(observation["yaw"])),
            float(np.float32(observation["elevation"])), depth)


class _BaseMap:
    """Shared construction and reset of a layer."""

    # layers whose update is (shared binning) + (one-hot splat): map
    # groups reuse one orient/bin/corner pass per camera and grid
    shared_onehot = True

    def __init__(self, camera: CameraConfig, geometry: MapGeometry,
                 origin=(0.0, 0.0, 0.0), device=None, mesh=None):
        self.camera = camera
        self.geometry = geometry
        self.mesh = mesh
        if mesh is not None:
            first = mesh.axis_devices("map")[0]
            if device is not None and canonical_device(device) != first:
                raise ValueError(f"a layer on {device} cannot shard over "
                                 f"a mesh whose first device is {first}")
            device = first
        self.device = resolve_device(device)
        self.rays = G.camera_rays(camera.height, camera.width,
                                  camera.focal_length, camera.focal_length,
                                  device=self.device)
        self.voxel_map = self._place(origin)
        # host-side reset generation: bins change only here, so host
        # midpoint caches (core/voxelmap.HostMapToWorld) key on it
        self.bins_epoch = 0

    def _place(self, origin):
        """A fresh map on the layer's device, or row-sharded over the
        mesh's ``map`` axis (the JAX package's rule: its voxels divide
        over the axis)."""
        if self.mesh is None:
            return VoxelMap.create(self.geometry, origin, self.device)
        return ShardedVoxelMap.create(
            self.geometry, self.mesh.axis_devices("map"), origin,
            axis="map")

    def reset(self, origin) -> None:
        self.voxel_map.reset(origin)
        self.bins_epoch += 1


class OccupancyMap(_BaseMap):
    """Single-channel density map: every valid depth pixel deposits
    occupancy mass (class 0)."""

    def __init__(self, camera: CameraConfig,
                 config_geometry: MapGeometry = None,
                 origin=(0.0, 0.0, 0.0), device=None, mesh=None, **geo_kwargs):
        geometry = config_geometry or MapGeometry(feature_size=1,
                                                  **geo_kwargs)
        super().__init__(camera, geometry, origin, device, mesh)

    def classes_for(self, aux, depth):
        return torch.zeros(depth.shape[:2], dtype=torch.int32,
                           device=self.device)

    def aux_from_observation(self, observation: Dict):
        return None


class SemanticMap(_BaseMap):
    """Per-voxel class-probability map fed by segmentation images."""

    def __init__(self, camera: CameraConfig, num_classes: int = 54,
                 config_geometry: MapGeometry = None,
                 origin=(0.0, 0.0, 0.0), device=None, mesh=None, **geo_kwargs):
        geometry = config_geometry or MapGeometry(feature_size=num_classes,
                                                  **geo_kwargs)
        super().__init__(camera, geometry, origin, device, mesh)

    def classes_for(self, aux, depth):
        h, w = self.rays.shape[0], self.rays.shape[1]
        return G.upsample_features(aux[..., None], h, w)[..., 0]

    def aux_from_observation(self, observation: Dict):
        semantic = np.asarray(observation["semantic"])
        if semantic.ndim == 3:
            semantic = semantic[..., 0]
        return torch.as_tensor(semantic.astype(np.int32),
                               device=self.device)


def _rgb(observation: Dict, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(observation["rgb"], np.float32),
                           device=device)


class FeatureMap(_BaseMap):
    """Dense-embedding map: ``backbone`` maps the RGB frame to an
    ``[h/k, w/k, F]`` feature image; depth is subsampled at the feature
    stride's pixel centres (``depth[k//2::k, k//2::k]``)."""

    shared_onehot = False

    def __init__(self, camera: CameraConfig, feature_size: int,
                 backbone: Callable[[torch.Tensor], torch.Tensor],
                 stride: int = 4, config_geometry: MapGeometry = None,
                 origin=(0.0, 0.0, 0.0), device=None, mesh=None, **geo_kwargs):
        geometry = config_geometry or MapGeometry(feature_size=feature_size,
                                                  **geo_kwargs)
        super().__init__(camera.downsample(stride), geometry, origin, device,
                         mesh)
        self.backbone = backbone
        self.stride = stride

    def aux_from_observation(self, observation: Dict):
        return _rgb(observation, self.device)

    def update_from_observation(self, observation: Dict) -> None:
        with span("mass.mapping.upload"):
            position, yaw, elevation, depth = _pose_args(observation,
                                                         self.device)
            rgb = self.aux_from_observation(observation)
        k = self.stride
        feats = self.backbone(rgb)
        self.voxel_map.update(self.rays, position, yaw, elevation,
                              depth[k // 2::k, k // 2::k].contiguous(),
                              feats)


class ClipMap(_BaseMap):
    """Whole-image embedding scattered at the image-centre ray: a 1x1
    feature camera; ``encoder`` maps the RGB frame to ``F`` values."""

    shared_onehot = False

    def __init__(self, camera: CameraConfig, feature_size: int,
                 encoder: Callable[[torch.Tensor], torch.Tensor],
                 config_geometry: MapGeometry = None,
                 origin=(0.0, 0.0, 0.0), device=None, mesh=None, **geo_kwargs):
        geometry = config_geometry or MapGeometry(feature_size=feature_size,
                                                  **geo_kwargs)
        centre = CameraConfig(height=1, width=1, vertical_fov_degrees=
                              camera.vertical_fov_degrees)
        super().__init__(centre, geometry, origin, device, mesh)
        self.encoder = encoder

    def aux_from_observation(self, observation: Dict):
        return _rgb(observation, self.device)

    def update_from_observation(self, observation: Dict) -> None:
        with span("mass.mapping.upload"):
            position, yaw, elevation, depth = _pose_args(observation,
                                                         self.device)
            rgb = self.aux_from_observation(observation)
        embedding = self.encoder(rgb)
        h, w = depth.shape[0], depth.shape[1]
        self.voxel_map.update(
            self.rays, position, yaw, elevation,
            depth[h // 2:h // 2 + 1, w // 2:w // 2 + 1].contiguous(),
            embedding.reshape(1, 1, self.geometry.feature_size))


class MapSet(dict):
    """Named map collection with broadcast reset and grouped updates."""

    def reset_all(self, origin) -> None:
        for layer in self.values():
            layer.reset(origin)

    def update_group(self, names, observation: Dict) -> None:
        """Fold one observation into the named layers (names not in the
        set are skipped): one orient/bin/corner pass per camera+grid
        signature, shared by every one-hot layer of that signature
        (layers reset together share bins; sharded layers of one mesh
        axis share their slabs, and each slab takes one launch for the
        group); dense layers run their own update."""
        layers = [self[n] for n in names if n in self]
        shared = {}      # signature -> (ids, weights)
        grouped = {}     # signature -> [(layer, classes)]
        for layer in layers:
            if not layer.shared_onehot:
                layer.update_from_observation(observation)
                continue
            vm, g = layer.voxel_map, layer.geometry
            with span("mass.mapping.upload"):
                position, yaw, elevation, depth = _pose_args(observation,
                                                             layer.device)
                aux = layer.aux_from_observation(observation)
            sig = (tuple(layer.rays.shape), g.map_height, g.map_width,
                   g.map_depth, g.grid_resolution,
                   tuple(slab.device for _, slab in vm.slabs()))
            with span("mass.mapping.records"):
                if sig not in shared:
                    shared[sig] = vm.contributions(layer.rays, position,
                                                   yaw, elevation, depth)
                grouped.setdefault(sig, []).append(
                    (layer, layer.classes_for(aux, depth)))
        for sig, members in grouped.items():
            ids, weights = shared[sig]
            apply_onehot_group([layer.voxel_map for layer, _ in members],
                               ids, weights, [cls for _, cls in members])
