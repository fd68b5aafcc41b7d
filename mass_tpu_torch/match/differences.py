"""Cross-phase map differencing and instance matching (port of
``mass_tpu.match.differences``).

Per candidate class: localize instances in both phase maps, cost each
pair by the L2 distance of their pooled feature vectors (with feature
maps, ``--use-feature-matching``) or ``|voxel-mass difference|``
(pickable), or by world distance (openable), solve the minimum-cost
assignment, and keep pairs that moved beyond ``distance_threshold``
(pickable) or any pair (openable); the first candidate class with kept
pairs wins.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from mass_tpu_torch import taxonomy
from mass_tpu_torch.config import MatchConfig
from mass_tpu_torch.core.voxelmap import VoxelMap
from mass_tpu_torch.match.find import (find_all_classes_pair,
                                       find_class_instances)
from mass_tpu_torch.ops.hungarian import linear_sum_assignment


def _detect_all(vm0: VoxelMap, vm1: VoxelMap, **kw):
    f0, f1 = find_all_classes_pair(vm0, vm1, **kw)
    return f0.present.any(-1) & f1.present.any(-1), f0, f1


def _match_class(vm0: VoxelMap, vm1: VoxelMap, fm0: Optional[VoxelMap],
                 fm1: Optional[VoxelMap], class_id: int, pickable: bool,
                 **kw):
    """Instances of one class in both maps, paired by minimum cost
    (pickable pairs by their pooled features when ``fm0``/``fm1`` are
    given).  Returns host numpy ``(matched [K], dist [K], goals0 [K, 3],
    goals1 [K, 3], truncated)``."""
    # only a pickable class's cost reads the features: an openable one
    # pairs by distance, so its instances skip the pooling
    use_features = pickable and fm0 is not None and fm1 is not None
    r0 = find_class_instances(vm0, class_id,
                              feature_map=fm0 if use_features else None,
                              **kw)
    r1 = find_class_instances(vm1, class_id,
                              feature_map=fm1 if use_features else None,
                              **kw)
    pair_ok = r0.present[:, None] & r1.present[None, :]
    if use_features:
        deform = torch.linalg.vector_norm(
            r0.features[:, None] - r1.features[None, :], dim=-1)
    else:
        deform = (r0.size[:, None] - r1.size[None, :]).abs()
    distance = torch.linalg.vector_norm(
        r0.position[:, None] - r1.position[None, :], dim=-1)
    raw = deform if pickable else distance
    # absent pairs cost just above the real range, so the optimum
    # maximizes real-real pairings without drowning real cost
    # differences in the solver's float32 duals
    big = torch.where(pair_ok, raw, torch.zeros_like(raw)).max() + 1.0
    cost = torch.where(pair_ok, raw, big)
    k = cost.shape[0]
    # one device-to-host copy for everything the host side reads
    host = torch.cat([
        cost.reshape(-1), distance.reshape(-1),
        pair_ok.reshape(-1).to(cost.dtype), r0.position.reshape(-1),
        r1.position.reshape(-1),
        (r0.truncated | r1.truncated).reshape(1).to(cost.dtype)]).cpu()
    host = host.numpy()
    cost_h, dist_h, ok_h, pos0, pos1 = (
        host[:k * k].reshape(k, k), host[k * k:2 * k * k].reshape(k, k),
        host[2 * k * k:3 * k * k].reshape(k, k) > 0,
        host[3 * k * k:3 * k * k + 3 * k].reshape(k, 3),
        host[3 * k * k + 3 * k:3 * k * k + 6 * k].reshape(k, 3))
    truncated = bool(host[-1] > 0)
    col = linear_sum_assignment(cost_h).numpy()
    safe_col = np.maximum(col, 0)
    rows = np.arange(k)
    matched = (col >= 0) & ok_h[rows, safe_col]
    return (matched, dist_h[rows, safe_col], pos0, pos1[safe_col],
            truncated)


def predict_scene_differences(
        semantic_map0: VoxelMap, semantic_map1: VoxelMap,
        feature_map0: Optional[VoxelMap], feature_map1: Optional[VoxelMap],
        objects_moved: Set[int], candidate_classes: Sequence[int],
        config: MatchConfig = MatchConfig(),
) -> Tuple[Optional[int], List[np.ndarray], List[np.ndarray]]:
    """Pick the next class to rearrange and its paired goal positions;
    with both feature maps, pickable instances pair by their pooled
    features.

    Returns ``(class_id | None, goals0, goals1)``: walkthrough-phase
    (target) and unshuffle-phase (current) world positions.
    """
    kw = dict(confidence_threshold=config.confidence_threshold,
              contour_padding=config.contour_padding,
              contour_threshold=config.contour_threshold,
              max_instances=config.max_instances)
    both, f0, f1 = _detect_all(semantic_map0, semantic_map1, **kw)
    flags = torch.stack([both, f0.truncated | f1.truncated]).cpu().numpy()
    both, truncated = flags[0], flags[1]
    if truncated.any():
        # presence detection is cap-safe (needs >= 1 blob); per-class
        # matching below escalates K, so this is informational
        names = [taxonomy.CLASS_NAMES[i]
                 for i in np.nonzero(truncated)[0]]
        print(f"[match] max_instances={config.max_instances} cap bound "
              f"in sweep for: {', '.join(names)} (per-class match "
              f"escalates)")

    for cls in candidate_classes:
        pickable = taxonomy.ID_TO_PICKABLE[cls]
        openable = taxonomy.ID_TO_OPENABLE[cls]
        if cls in objects_moved or not (pickable or openable):
            continue
        if not both[cls]:
            continue

        # adaptive instance cap: double K until every blob is
        # represented (the reference's contour path is unbounded)
        mkw = dict(kw)
        while True:
            matched, dist, pos0, goals1, trunc = _match_class(
                semantic_map0, semantic_map1, feature_map0, feature_map1,
                cls, pickable, **mkw)
            if not trunc or mkw["max_instances"] >= 256:
                break
            mkw["max_instances"] *= 2
            print(f"[match] {taxonomy.CLASS_NAMES[cls]}: cap bound, "
                  f"retrying with max_instances="
                  f"{mkw['max_instances']}")

        goals_a, goals_b = [], []
        for i in range(matched.shape[0]):
            if not matched[i]:
                continue
            move = pickable and dist[i] > config.distance_threshold
            if move or openable:
                goals_a.append(pos0[i])
                goals_b.append(goals1[i])
        if goals_a:
            return cls, goals_a, goals_b
    return None, [], []
