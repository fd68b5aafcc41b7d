"""Ground-truth scene-difference extraction (the GT-injection ablation
paths; reference: mass/utils/experimentation.py:90-166)."""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from mass_tpu_torch import taxonomy


def scene_difference_types(task) -> Iterator[str]:
    """Type names of movable objects whose current pose differs from the
    walkthrough pose (reference: get_scene_differences)."""
    start, goal, _ = task.env.poses
    for current, target in zip(start, goal):
        if not task.env.are_poses_equal(current, target) and (
                current["type"] in taxonomy.PICKABLE_TO_COLOR or
                current["type"] in taxonomy.OPENABLE_TO_COLOR):
            yield current["type"]


def scene_difference_positions(task) -> Iterator[
        Tuple[np.ndarray, np.ndarray]]:
    """(current, walkthrough) world positions — in the framework's
    (x, z_sim, y_up) convention — of misplaced movable objects
    (reference: get_scene_differences_pose)."""
    start, goal, _ = task.env.poses
    for current, target in zip(start, goal):
        if not task.env.are_poses_equal(current, target) and (
                current["type"] in taxonomy.PICKABLE_TO_COLOR or
                current["type"] in taxonomy.OPENABLE_TO_COLOR):
            yield (np.asarray([current["position"]["x"],
                               current["position"]["z"],
                               current["position"]["y"]]),
                   np.asarray([target["position"]["x"],
                               target["position"]["z"],
                               target["position"]["y"]]))
