"""Instance localization in semantic voxel maps (port of
``mass_tpu.match.find``).

Per class: smooth the class-probability volume, threshold it, split the
top-down footprint into connected blobs, and reduce each blob's
bounding rectangle over the full z extent into a confidence, an expected
world position and a voxel mass, and (with a co-registered feature
map, for ``--use-feature-matching``) a pooled feature vector.  The
all-classes sweep batches the class axis (one labelling over
``[C, H, W]``), where the JAX package vmapped.  World sums use the
separability of voxel-centre coordinates, so every per-instance
statistic is a masked reduction.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mass_tpu_torch.core.voxelmap import VoxelMap
from mass_tpu_torch.ops.components import extract_instances
from mass_tpu_torch.ops.pool import avg_pool3d_same


class FoundInstances(NamedTuple):
    """K size-ranked instances (leading class axis when batched);
    ``present`` already folds in the confidence threshold."""

    present: torch.Tensor     # [..., K] bool
    confidence: torch.Tensor  # [..., K]
    position: torch.Tensor    # [..., K, 3] world xyz
    size: torch.Tensor        # [..., K] voxel mass
    truncated: torch.Tensor   # [...] more than K blobs existed
    features: Optional[torch.Tensor] = None  # [K, F] pooled embeddings


def _axis_world_coords(vm: VoxelMap):
    """Per-axis voxel-centre world coords (wy flipped to map rows)."""
    wx = (vm.bins_x[:-1] + vm.bins_x[1:]) / 2
    wy = torch.flip((vm.bins_y[:-1] + vm.bins_y[1:]) / 2, [0])
    wz = (vm.bins_z[:-1] + vm.bins_z[1:]) / 2
    return wx, wy, wz


def pooled_features(volume: torch.Tensor, feature_volume: torch.Tensor,
                    roi: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    """``[K, F]`` feature vectors of K instances: per column the
    class-mass-weighted feature sum over depth, ``e[h, w] = sum_d
    volume[h, w, d] * feature[h, w, d, :]``, then each instance's
    rectangle sum of ``e`` over its mass.  ``e`` is one batched product
    over the H*W columns, so no ``[H, W, D, F]`` temporary is made (the
    feature volume is a view of the map, 13.5 GiB at full width)."""
    h, w, d = volume.shape
    f = feature_volume.shape[-1]
    e = torch.bmm(volume.reshape(h * w, 1, d),
                  feature_volume.reshape(h * w, d, f)).reshape(h * w, f)
    return (roi.reshape(roi.shape[0], h * w) @ e) / denom[:, None]


def _instances_from_volume(coords, volume: torch.Tensor,
                           confidence_threshold: float,
                           contour_padding: int,
                           contour_threshold: float,
                           max_instances: int,
                           feature_volume: Optional[torch.Tensor] = None
                           ) -> FoundInstances:
    """``volume`` is the ``[..., H, W, D]`` class-probability mass,
    ``coords`` the per-axis voxel-centre world coordinates; with
    ``feature_volume [H, W, D, F]`` (one class) each instance also gets
    its pooled feature vector."""
    smooth = avg_pool3d_same(volume, contour_padding)
    footprint = (smooth > contour_threshold).any(dim=-1)
    inst = extract_instances(footprint, max_instances)

    wx, wy, wz = coords
    a = volume.sum(dim=-1)                          # sum_z m
    b = (volume * volume).sum(dim=-1)               # sum_z m^2
    c = (volume * wz).sum(dim=-1)                   # sum_z m*wz

    roi = inst.roi.to(volume.dtype)                 # [..., K, H, W]
    a4, b4, c4 = a[..., None, :, :], b[..., None, :, :], c[..., None, :, :]
    m_sum = (roi * a4).sum(dim=(-2, -1))
    m2_sum = (roi * b4).sum(dim=(-2, -1))
    ra = roi * a4
    sx = (ra.sum(dim=-2) * wx).sum(dim=-1)
    sy = (ra.sum(dim=-1) * wy).sum(dim=-1)
    sz = (roi * c4).sum(dim=(-2, -1))

    denom = m_sum + 1e-9
    confidence = m2_sum / denom
    position = torch.stack([sx, sy, sz], dim=-1) / denom[..., None]
    present = inst.present & (confidence > confidence_threshold)
    features = (None if feature_volume is None else
                pooled_features(volume, feature_volume, roi, denom))
    return FoundInstances(present=present, confidence=confidence,
                          position=position, size=m_sum,
                          truncated=inst.truncated, features=features)


def find_class_instances(vm: VoxelMap, semantic_category: int,
                         feature_map: Optional[VoxelMap] = None,
                         confidence_threshold: float = 0.2,
                         contour_padding: int = 3,
                         contour_threshold: float = 0.0,
                         max_instances: int = 16) -> FoundInstances:
    """Localize the instances of one class, with pooled feature vectors
    from a co-registered ``feature_map`` (``--use-feature-matching``)."""
    volume = vm.grid()[..., int(semantic_category)]
    fvol = None if feature_map is None else feature_map.grid()
    return _instances_from_volume(
        _axis_world_coords(vm), volume, confidence_threshold,
        contour_padding, contour_threshold, max_instances, fvol)


def find_all_classes(vm: VoxelMap, confidence_threshold: float = 0.2,
                     contour_padding: int = 3,
                     contour_threshold: float = 0.0,
                     max_instances: int = 16) -> FoundInstances:
    """Localize the instances of every class in one batched sweep
    (leading class axis on every field)."""
    volumes = vm.grid().permute(3, 0, 1, 2)        # [C, H, W, D] view
    return _instances_from_volume(
        _axis_world_coords(vm), volumes, confidence_threshold,
        contour_padding, contour_threshold, max_instances)


def find_all_classes_pair(vm0: VoxelMap, vm1: VoxelMap, **kw):
    """All-classes sweep over both phase maps, one map at a time (two
    maps' class volumes at once would double the peak memory)."""
    return find_all_classes(vm0, **kw), find_all_classes(vm1, **kw)
