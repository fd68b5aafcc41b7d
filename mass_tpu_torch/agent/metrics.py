"""Per-task result serialization: metrics JSON, analytics CSV, search
recordings (reference: agent.py:609-653 and §5.5 of SURVEY.md)."""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


class NumpyJSONEncoder(json.JSONEncoder):
    """JSON encoder accepting numpy scalars/arrays (reference:
    mass/utils/experimentation.py:21-37)."""

    def default(self, obj):
        if isinstance(obj, np.bool_):
            return bool(obj)
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        return super().default(obj)


def write_task_metrics(logdir: str, task_id: int, metrics: Dict) -> str:
    path = os.path.join(logdir, "results", f"{task_id}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(metrics, f, indent=4, cls=NumpyJSONEncoder)
    return path


def write_analytics(logdir: str, task_id: int,
                    records: List[Dict]) -> str:
    path = os.path.join(logdir, "results", f"analytics-{task_id}.csv")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    keys: List[str] = []
    for r in records:
        for k in r:
            if k not in keys:
                keys.append(k)
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=[""] + keys)
        writer.writeheader()
        for i, r in enumerate(records):
            writer.writerow({"": i, **r})
    return path


def write_map_snapshots(logdir: str, task_id: int, maps) -> str:
    """End-of-episode voxel-map state for post-hoc debugging
    (SURVEY.md §5.4 — the reference hints at the practice with a
    commented-out np.save of its semantic maps, agent.py:417-418).

    One compressed npz per task: each layer's logical ``[H, W, D, F]``
    grid in float16 plus its axis bins (float32), so world coordinates
    are recoverable offline.  Each grid is cast on its own device and
    only the float16 copy crosses to the host (1.53 GB for a full-width
    semantic map, not 3.06); the cast rounds to nearest even, as numpy's
    does, so the arrays equal the JAX package's.
    """
    arrays = {}
    for name, layer in maps.items():
        vm = getattr(layer, "voxel_map", layer)  # layer or bare VoxelMap
        arrays[name] = vm.grid().to(torch.float16).cpu().numpy()
        for axis in ("x", "y", "z"):
            arrays[f"{name}_bins_{axis}"] = getattr(
                vm, f"bins_{axis}").to(torch.float32).cpu().numpy()
    path = os.path.join(logdir, "results", f"maps-{task_id}.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **arrays)
    return path


def write_found_objects(logdir: str, task_id: int, phase: str,
                        agent_positions: Sequence[np.ndarray],
                        object_positions: np.ndarray,
                        object_types: Optional[Sequence[str]] = None
                        ) -> Optional[str]:
    """Agent-to-object distance matrix over time (reference:
    agent.py:612-631).

    ``object_types`` (class name per distance-matrix row, aligned with
    ``object_positions``) is saved to a sibling
    ``objects-found-{phase}-{task_id}-types.json`` so the analyzer can
    split found-rate curves per class (``analyze found --per-class``).
    """
    if len(agent_positions) == 0 or object_positions.size == 0:
        return None
    agent = np.stack(agent_positions, axis=0)
    dist = np.linalg.norm(agent[None] - object_positions[:, None],
                          axis=-1)
    path = os.path.join(logdir, "results",
                        f"objects-found-{phase}-{task_id}.npy")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    # traces are COMMITTED per protocol (experiments/mr22/run_arm.sh)
    # and compound across arms/reruns — store f32: metre-scale
    # distances lose nothing against the 0.25-2 m found-radius
    # thresholds, at half the repo growth (advisor r4)
    np.save(path, dist.astype(np.float32))
    if object_types is not None and len(object_types) == len(dist):
        with open(os.path.join(
                logdir, "results",
                f"objects-found-{phase}-{task_id}-types.json"),
                "w") as f:
            json.dump(list(object_types), f)
    return path


def object_analytics_record(pose_current: Dict, pose_goal: Dict,
                            all_poses: List[Dict],
                            are_equal, pickable: set,
                            openable: set, prefix: str) -> Dict:
    """One object's neighborhood/correctness features (reference:
    agent.py:210-298, 536-607)."""
    def neighbor_distances(filt):
        out = []
        p1 = np.asarray(list(pose_current["position"].values()))
        for other in all_poses:
            if other["name"] == pose_current["name"] or not filt(other):
                continue
            p2 = np.asarray(list(other["position"].values()))
            out.append(float(np.linalg.norm(p1 - p2)))
        return out

    d_all = neighbor_distances(lambda o: True)
    d_pick = neighbor_distances(lambda o: o["type"] in pickable)
    d_type = neighbor_distances(
        lambda o: o["type"] == pose_current["type"])

    p1 = np.asarray(list(pose_current["position"].values()))
    p2 = np.asarray(list(pose_goal["position"].values()))
    openness = 0.0
    if pose_current.get("openness") is not None and \
            pose_goal.get("openness") is not None:
        openness = abs(pose_current["openness"] - pose_goal["openness"])

    size = 0.0
    if pose_current.get("bounding_box") is not None:
        bbox = np.asarray(pose_current["bounding_box"])
        size = float(np.prod(bbox.max(0) - bbox.min(0)))

    rec = {
        f"{prefix}_openness": openness,
        f"{prefix}_distance": float(np.linalg.norm(p1 - p2)),
        f"{prefix}_correct": (not pose_current.get("broken", False)
                              and are_equal(pose_current, pose_goal)),
    }
    for name, vals in (("all", d_all), ("pickable", d_pick),
                       ("type", d_type)):
        rec[f"{prefix}_min_distance_{name}"] = (
            min(vals) if vals else None)
        rec[f"{prefix}_mean_distance_{name}"] = (
            float(np.mean(vals)) if vals else None)
    if prefix == "initial":
        rec["size"] = size
        rec["type"] = pose_current["type"]
        rec["pickable"] = pose_current["type"] in pickable
        rec["openable"] = pose_current["type"] in openable
    return rec
