"""Centralized, typed configuration for the framework.

The reference scatters ~25 argparse flags across scripts with diverging
defaults (reference: agent.py:786-861, get_search_labels.py:232-235).
Here every tunable lives in one frozen dataclass hierarchy; the CLI layer
parses flags into these objects.  All classes are hashable so they can be
used as static arguments to `jax.jit`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole camera intrinsics for the agent's RGB-D sensor.

    Mirrors the reference's camera setup (reference:
    mass/nn/base_projection_layer.py:149-154) where the focal length is
    derived from the vertical field of view and the image height, and the
    same focal length is used for both axes.
    """

    height: int = 224
    width: int = 224
    vertical_fov_degrees: float = 90.0

    @property
    def focal_length(self) -> float:
        return self.height / 2.0 / math.tan(
            math.radians(self.vertical_fov_degrees) / 2.0)

    def downsample(self, factor: int) -> "CameraConfig":
        """Camera for a feature grid at 1/factor resolution (e.g. a conv
        backbone's stride-4 feature map, reference:
        mass/nn/applications/resnet_projection_layer.py:121-123)."""
        return dataclasses.replace(
            self, height=self.height // factor, width=self.width // factor)


@dataclasses.dataclass(frozen=True)
class MapGeometry:
    """Static shape/scale description of a voxel feature map.

    ``data`` tensors built from this geometry are laid out
    ``[map_height, map_width, map_depth, feature_size]`` where map_height
    indexes world y (top-down row, flipped), map_width indexes world x and
    map_depth indexes world z (up).  (reference:
    mass/nn/base_projection_layer.py:156-181)
    """

    map_height: int = 384
    map_width: int = 384
    map_depth: int = 96
    feature_size: int = 1
    grid_resolution: float = 0.05
    interpolation_weight: float = 0.5
    # (the JAX package's ``layout`` and ``precision`` fields are TPU
    # choices: the port always stores voxel-major [V, F] float32 and
    # splats in float32)

    @property
    def num_voxels(self) -> int:
        return self.map_height * self.map_width * self.map_depth

    @property
    def world_extent(self) -> Tuple[float, float, float]:
        return (self.map_width * self.grid_resolution,
                self.map_height * self.grid_resolution,
                self.map_depth * self.grid_resolution)


@dataclasses.dataclass(frozen=True)
class NavConfig:
    """Navigation / path-planning parameters (reference:
    mass/navigation_policy.py:26-73, agent.py:841-844)."""

    step_size: int = 5
    obstacle_padding: int = 1
    obstacle_threshold: float = 0.0
    map_slice_start: int = 20
    map_slice_stop: int = 48
    position_noise_std: float = 0.0
    rotation_noise_std: float = 0.0
    graph_update_interval: int = 20
    # cap on steps spent pursuing a single navigation goal (0 = only the
    # phase budget limits it, as in the reference)
    max_goal_steps: int = 80
    # pin the local controller to the reference's exact rules: terminate
    # on path length 1 and steer at the next path node (reference:
    # mass/navigation_policy.py:586-605) instead of the arrival radius +
    # pure-pursuit waypoint generalization (see nav/controller.py)
    reference_compat: bool = False


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Instance detection + cross-phase matching parameters (reference:
    agent.py:846-856)."""

    confidence_threshold: float = 0.0
    contour_padding: int = 0
    contour_threshold: float = 0.0
    distance_threshold: float = 0.05
    deformation_threshold: float = 0.0
    max_instances: int = 16  # static cap on instances per class on-device


@dataclasses.dataclass(frozen=True)
class AgentConfig:
    """Top-level episode-driver configuration (reference: agent.py:786-861)."""

    camera: CameraConfig = CameraConfig()
    map_height: int = 384
    map_width: int = 384
    map_depth: int = 96
    grid_resolution: float = 0.05
    nav: NavConfig = NavConfig()
    match: MatchConfig = MatchConfig()

    exploration_budget_one: int = 5
    exploration_budget_two: int = 5
    detection_threshold: float = 0.9

    ground_truth_segmentation: bool = False
    ground_truth_disagreement: bool = False
    ground_truth_semantic_search: bool = False
    semantic_search_walkthrough: bool = False
    semantic_search_unshuffle: bool = False
    # oracle-free directed exploration: goals go to the FARTHEST
    # reachable node with positive frontier (unknown-bordering-free)
    # mass nearby, instead of a uniform random node
    # (nav/grid.frontier_mass; beyond the reference's random / GT /
    # learned-CNN goal heads — selection rule measured in
    # docs/experiments.md "Frontier exploration")
    frontier_exploration: bool = False
    # oracle-free SEMANTIC exploration: unshuffle-phase goals revisit
    # the walkthrough map's own object sites (match/revisit.py) —
    # evidence lands exactly where cross-phase disagreement is
    # decidable; falls back to farthest-frontier once all sites are
    # visited.  Walkthrough-phase goals are unaffected (combine with
    # frontier_exploration for directed coverage there).
    revisit_exploration: bool = False
    # inhibition-of-return for POLICY goal sampling, in map cells
    # (0 = off): cells within this radius of the phase's earlier
    # policy goals are masked out of the softmax before sampling, so
    # a small exploration budget covers the heat map's distinct modes
    # instead of re-drawing the strongest one — the decode-time
    # analogue of the revisit head's without-replacement site walk
    # (docs/experiments.md "Conditioned policy")
    policy_inhibition_radius: float = 0.0
    use_feature_matching: bool = False
    record_found_objects: bool = False
    # dump end-of-episode voxel-map state per task for post-hoc
    # debugging (SURVEY.md §5.4; the reference hints at the practice
    # with a commented-out np.save of its maps, agent.py:417-418)
    snapshot_maps: bool = False
    # one-phase rearrangement: no walkthrough task; each observation
    # carries the goal world's render from the same pose and both maps
    # build simultaneously (reference:
    # mass/thor/segmentation_config.py:484-598)
    one_phase: bool = False
    # row-shard every voxel map over an N-device "map" mesh axis
    # (parallel/sharding.py): 0/1 = single-device maps.  The spatial
    # scaling axis for maps larger than one chip's HBM (SURVEY.md
    # §5.7-5.8); num_voxels must divide by N.
    shard_map: int = 0
    # navigate on the walkthrough semantic map instead of a dedicated
    # occupancy map: they are identical when updated in lockstep (an
    # occupancy update equals the semantic map's channel sum — see
    # tests/test_voxelmap.py::test_occupancy_equals_semantic_channel_sum),
    # which removes a third of per-step map-update work.  Set False to
    # mirror the reference's separate occupancy layer exactly.
    navigate_on_semantic: bool = True

    logdir: Optional[str] = None
    stage: str = "train"
    start_task: int = 0
    every_tasks: int = 1
    total_tasks: int = 50
    # cross-PROCESS resume: skip any task whose results/{id}.json is
    # already in logdir.  The reference only resumes within a process
    # (agent.py:657-662 advances the parsed args between watchdog
    # restarts); a fresh invocation re-runs everything.  SURVEY.md §5.3
    # calls for logdir-scan resumability, and this is it.
    resume: bool = False

    def geometry(self, feature_size: int = 1) -> MapGeometry:
        return MapGeometry(
            map_height=self.map_height, map_width=self.map_width,
            map_depth=self.map_depth, feature_size=feature_size,
            grid_resolution=self.grid_resolution)

    @property
    def navigation_map_name(self) -> str:
        """Which map layer the planner reads for traversability.  The
        SINGLE source of this rule — the sequential agent and both
        fleet paths navigate the same layer or their step-for-step
        parity (tests/test_evaluator.py) silently breaks.  One-phase
        agents navigate the LIVE world (semantic1); two-phase agents
        the walkthrough map (semantic0, whose channel sum equals the
        occupancy update when maintained in lockstep); the
        reference-exact mode keeps a dedicated occupancy layer."""
        if self.navigate_on_semantic:
            return "semantic1" if self.one_phase else "semantic0"
        return "occupancy"
