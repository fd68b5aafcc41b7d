"""The rearrangement episode driver (port of ``mass_tpu.agent.loop``).

Build the walkthrough semantic map while exploring, build a second map
in the shuffled scene, diff the maps to find displaced objects, and
navigate / pick / place to fix them.  The planner reads the
walkthrough's semantic map or (``--reference-compat``) a separate
occupancy map that phase one updates with ``semantic0`` in one multi-map
splat.  Exploration goals come from one of the goal heads: ground truth,
the semantic-search policy (``search/policy.py``), walkthrough-site
revisits in the unshuffle phase (``match/revisit.py``), the farthest
frontier, or a uniform random node.  ``--one-phase`` runs a single task
whose observations carry the goal world's render, so both maps build
from one pass (:class:`OnePhaseMapSet`).  ``--use-feature-matching``
adds a pair of dense ResNet feature maps (``feature0`` in phase one,
``feature1`` in phase two), whose pooled embeddings pair same-class
instances in the matcher.  ``video_writer_factory`` records a frame
per observation (camera view beside the navigation map's density and
both semantic maps, rendered on the maps' device), and
``config.snapshot_maps`` writes each episode's final maps; neither
changes an episode.  ``--shard-map N`` row-shards every map over N
devices (``parallel/sharding.py``), which changes nothing of an episode
either: a sharded map equals the unsharded one bit for bit.

Every numpy random draw happens in the JAX package's order, and the
policy's draws replay ``jax.random``'s threefry stream, so a seeded
episode takes the same actions in both packages.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from mass_tpu_torch import resolve_device, taxonomy
from mass_tpu_torch.agent import metrics as M
from mass_tpu_torch.agent import oracle
from mass_tpu_torch.config import AgentConfig
from mass_tpu_torch.env.gridworld import snake_case
from mass_tpu_torch.maps import (FeatureMap, MapSet, OccupancyMap,
                                 SemanticMap)
from mass_tpu_torch.match import revisit
from mass_tpu_torch.match.differences import predict_scene_differences
from mass_tpu_torch.nav.controller import NavigationController
from mass_tpu_torch.parallel.mesh import make_mesh
from mass_tpu_torch.search import policy as search_policy
from mass_tpu_torch.search import prng
from mass_tpu_torch.utils import visualization as viz
from mass_tpu_torch.utils.profiling import StageTimer

PHASE_ONE_MAPS = ["occupancy", "semantic0", "feature0"]
PHASE_TWO_MAPS = ["semantic1", "feature1"]
# in one-phase episodes these maps read the goal world's render
GOAL_FED_MAPS = frozenset({"semantic0", "feature0"})


def map_mesh(config: AgentConfig, device: torch.device, mesh=None):
    """The mesh whose ``map`` axis every map row-shards over: ``mesh``
    when the caller gives one, else for ``config.shard_map`` N > 1 an
    N-device mesh, as the JAX package builds it (N slabs on the CPU for a
    CPU ``device``, N cards on CUDA), else None."""
    if mesh is None and config.shard_map > 1:
        devices = [device] * config.shard_map if device.type == "cpu" \
            else None
        mesh = make_mesh((config.shard_map,), ("map",), devices)
    return mesh


class OnePhaseMapSet(MapSet):
    """A ``MapSet`` whose goal-state maps read the goal render that each
    one-phase observation carries (``goal_depth`` / ``goal_semantic``):
    one update of the live maps, then one of the goal-fed maps, each
    with its own binning (the goal-fed feature map reads ``goal_rgb``)."""

    def update_group(self, names, observation: Dict) -> None:
        live = [n for n in names if n not in GOAL_FED_MAPS]
        goal = [n for n in names if n in GOAL_FED_MAPS]
        super().update_group(live, observation)
        if goal and "goal_depth" in observation:
            remap = dict(observation)
            remap["depth"] = observation["goal_depth"]
            remap["semantic"] = observation["goal_semantic"]
            if "goal_rgb" in observation:
                remap["rgb"] = observation["goal_rgb"]
            super().update_group(goal, remap)


class GoalHeads:
    """The exploration-goal heads of one agent: ground truth, the
    semantic-search policy, walkthrough-site revisits, the farthest
    frontier and the uniform random node.  The sequential agent and each
    fleet episode hold one, so their draws cannot drift apart.

    Constructing it draws the policy key's seed from ``rng`` (policy or
    not, as the JAX package does, so the numpy streams stay aligned).
    """

    def __init__(self, config: AgentConfig, rng: np.random.RandomState,
                 policy=None, device=None):
        self.config = config
        self.rng = rng
        self.policy = None if policy is None else policy.to(device)
        # a checkpoint trained on [current map, walkthrough context] has
        # twice the classes as its first conv's input width
        self.conditioned = (
            policy is not None and search_policy.input_channels(policy)
            == 2 * taxonomy.NUM_CLASSES)
        self.key = prng.PRNGKey(rng.randint(1 << 30), device=device)
        self.reset()

    def reset(self) -> None:
        """Per-episode state: this phase's policy goal cells (for
        ``--policy-inhibition-radius``) and the walkthrough sites."""
        self.cells: Dict[str, List] = {"semantic0": [], "semantic1": []}
        self.sites: Optional[np.ndarray] = None
        self.used: set = set()

    def next_goal(self, controller, semantic_name: str,
                  gt_goals: List[np.ndarray], use_policy: bool,
                  revisit_ok: bool, timer: StageTimer) -> np.ndarray:
        """The next exploration goal.  The random sample is drawn first,
        whichever head wins, as in the JAX package, so every head consumes
        the same rng stream; revisits (``revisit_ok``: the unshuffle phase)
        fall back to the frontier once every site is visited."""
        goal = controller.sample_navigation_goal({})
        if gt_goals:
            return gt_goals.pop(0)
        if use_policy and self.policy is not None:
            return self.policy_goal(controller.maps, semantic_name, timer)
        if revisit_ok and self.config.revisit_exploration:
            if self.sites is None:
                with timer.stage("matching"):
                    self.sites = revisit.walkthrough_sites(
                        controller.maps["semantic0"].voxel_map,
                        self.config.match)
            site = revisit.pick_site(self.sites, self.used, self.rng)
            if site is not None:
                return site
            return controller.frontier_navigation_goal({})
        if self.config.frontier_exploration:
            return controller.frontier_navigation_goal({})
        return goal

    def policy_goal(self, maps, semantic_name: str,
                    timer: StageTimer) -> np.ndarray:
        """A cell drawn from the policy's scores of the phase map's
        top-down view, as a world point.  For a conditioned checkpoint
        the input is ``[top, ctx]``: the finished walkthrough map at the
        unshuffle call site, zeros at the walkthrough call site (no
        earlier map exists).  The reads reduce the maps (or a fleet
        slab's views) without copying them."""
        self.key, sub = prng.split(self.key)
        cells = self.cells[semantic_name]
        radius = self.config.policy_inhibition_radius
        with timer.stage("search_policy"):
            x = maps[semantic_name].voxel_map.max_over_depth()
            if self.conditioned:
                ctx = (maps["semantic0"].voxel_map.max_over_depth()
                       if semantic_name == "semantic1"
                       else torch.zeros_like(x))
                x = torch.cat([x, ctx], dim=-1)
            x = x[None]
            if radius > 0:
                logits = search_policy.goal_logits(self.policy, x)[0]
                cell = search_policy.inhibited_sample_cell(
                    logits, x.shape[1], x.shape[2], cells, radius, sub)
            else:
                cell = search_policy.sample_goal_cell(
                    self.policy, x, sub)[0].cpu().numpy()
            cells.append(cell[:2])
            return maps[semantic_name].voxel_map.map_to_world(
                torch.as_tensor(cell, dtype=torch.float32)).cpu().numpy()


class RearrangementAgent:
    """Runs rearrangement episodes from a task sampler.

    Args:
      config: full agent configuration.
      sampler: walkthrough/unshuffle alternating task source (one task per
        episode under ``config.one_phase``).
      rng: numpy generator for goal sampling and pose noise.
      device: where the maps live; ``None`` means CUDA.
      policy: semantic-search policy (``search/policy.SearchPolicy``) for
        ``semantic_search_walkthrough/unshuffle``, or None.
      feature_backbone: RGB ``[h, w, 3]`` -> ``[h/4, w/4, feature_size]``
        embedding function (``perception/resnet.make_backbone``), needed
        when ``config.use_feature_matching``.
      video_writer_factory: optional ``task_id -> writer`` with
        ``write(frame_uint8)`` / ``close()`` for episode videos.
      mesh: a ``parallel/mesh.DeviceMesh`` whose ``map`` axis every map
        row-shards over, in place of the one ``config.shard_map`` builds
        (its first device is the agent's; ``["cuda:0"] * N`` puts N slabs
        on one card).
    """

    def __init__(self, config: AgentConfig, sampler,
                 rng: Optional[np.random.RandomState] = None,
                 device=None, policy=None,
                 feature_backbone: Optional[Callable] = None,
                 feature_size: int = 256,
                 video_writer_factory: Optional[Callable] = None,
                 mesh=None):
        if config.use_feature_matching and feature_backbone is None:
            raise ValueError("feature matching needs a backbone (CLI: "
                             "--backbone-checkpoint)")
        self.config = config
        self.sampler = sampler
        self.rng = rng or np.random.RandomState(0)
        if mesh is not None and device is None:
            device = mesh.axis_devices("map")[0]
        self.device = resolve_device(device)
        self.timer = StageTimer(self.device)
        self.video_writer_factory = video_writer_factory
        self._writer = self._callback = None

        cam = config.camera
        geo_kw = dict(map_height=config.map_height,
                      map_width=config.map_width,
                      map_depth=config.map_depth,
                      grid_resolution=config.grid_resolution)
        # --shard-map: every map row-sharded over the mesh's map axis
        # (parallel/sharding.py)
        self.mesh = map_mesh(config, self.device, mesh)
        if self.mesh is not None:
            geo_kw["mesh"] = self.mesh
        map_set = OnePhaseMapSet if config.one_phase else MapSet
        self.maps = map_set(
            semantic0=SemanticMap(cam, taxonomy.NUM_CLASSES,
                                  device=self.device, **geo_kw),
            semantic1=SemanticMap(cam, taxonomy.NUM_CLASSES,
                                  device=self.device, **geo_kw))
        # the planner reads the walkthrough's semantic map (the live one
        # in one-phase episodes), or a separate occupancy map
        # (navigate_on_semantic=False, --reference-compat) that phase one
        # updates together with semantic0
        self.navigation_map = config.navigation_map_name
        if not config.navigate_on_semantic:
            self.maps["occupancy"] = OccupancyMap(cam, device=self.device,
                                                  **geo_kw)
        if config.use_feature_matching:
            for name in ("feature0", "feature1"):
                self.maps[name] = FeatureMap(cam, feature_size,
                                             feature_backbone,
                                             device=self.device, **geo_kw)
        self.phase_one = [m for m in PHASE_ONE_MAPS if m in self.maps]
        self.phase_two = [m for m in PHASE_TWO_MAPS if m in self.maps]

        self.heads = GoalHeads(config, self.rng, policy, self.device)

    # -------------------------------------------------------- phases

    def _explore(self, controller, budget: int, semantic_name: str,
                 update_maps: List[str], gt_goals: List[np.ndarray],
                 use_policy: bool, tracker,
                 revisit_ok: bool = False) -> None:
        num_goals = 0
        while not controller.task.is_done() and num_goals < budget:
            num_goals += 1
            goal = self.heads.next_goal(controller, semantic_name,
                                        gt_goals, use_policy, revisit_ok,
                                        self.timer)
            for obs in controller.navigate_to(goal, update_map=update_maps):
                self._observed(controller, obs, tracker)

    def _navigate(self, controller, goal, tracker) -> None:
        for obs in controller.navigate_to(goal, update_map=self.phase_two):
            self._observed(controller, obs, tracker)

    def _observed(self, controller, obs, tracker) -> None:
        """Per observation: the video frame, then the found-object
        track."""
        if self._callback is not None:
            self._callback(obs)
        if tracker is not None:
            loc = controller.task.agent_location()
            tracker.append(np.asarray([loc.x, loc.z]))

    def _rearrange(self, controller, object_ids_to_move,
                   objects_moved: set, tracker) -> None:
        """Detection / match / fix loop."""
        cfg = self.config
        task = controller.task
        names = task.action_names()
        fm0, fm1 = self.maps.get("feature0"), self.maps.get("feature1")

        while not task.is_done():
            candidates = (object_ids_to_move
                          if cfg.ground_truth_disagreement
                          else range(taxonomy.NUM_CLASSES))
            with self.timer.stage("matching"):
                cls, goals0, goals1 = predict_scene_differences(
                    self.maps["semantic0"].voxel_map,
                    self.maps["semantic1"].voxel_map,
                    fm0.voxel_map if fm0 else None,
                    fm1.voxel_map if fm1 else None,
                    objects_moved, candidates, cfg.match)
            if cls is None or task.is_done():
                return
            objects_moved.add(cls)

            # fix farthest-moved instances first to avoid conflicts
            d = np.linalg.norm(
                np.stack(goals0)[:, None] - np.stack(goals1)[None],
                axis=-1)
            order = np.argsort(-d.min(axis=1))
            goals0 = [goals0[i] for i in order]
            goals1 = [goals1[i] for i in order]

            cname = taxonomy.CLASS_NAMES[cls]
            pickable = taxonomy.ID_TO_PICKABLE[cls]
            grab = (f"pickup_{snake_case(cname)}" if pickable
                    else f"open_by_type_{snake_case(cname)}")

            for goal0, goal1 in zip(goals0, goals1):
                self._navigate(controller, goal1, tracker)
                if task.is_done():
                    return
                task.step(names.index(grab))
                if task.is_done():
                    return
                if not pickable:
                    continue
                self._navigate(controller, goal0, tracker)
                if task.is_done():
                    return
                task.step(names.index("drop_held_object_with_snap"))
                if task.is_done():
                    return

    # ----------------------------------------------------------- tasks

    def _start_task(self, task_id: int):
        """A fresh episode's first task, maps, controller, stage timer and
        video writer, the agent looking down (it behaves better so)."""
        self.timer = StageTimer(self.device)    # fresh per-task timing
        self.heads.reset()
        task = self.sampler.next_task()
        loc = task.agent_location()
        self.maps.reset_all((loc.x, loc.z, loc.y))
        controller = NavigationController(
            task, self.navigation_map, self.maps, self.config.nav,
            rng=self.rng, timer=self.timer)
        self._writer = (self.video_writer_factory(task_id)
                        if self.video_writer_factory else None)
        self._callback = (self._make_callback(self._writer)
                          if self._writer is not None else None)
        task.step(task.action_names().index("look_down"))
        return task, controller

    @staticmethod
    def _misplaced(task_id: int, task, record: bool):
        """The classes to move, printed, and (with ``record``) the
        misplaced objects' positions and types for the found-object
        files."""
        object_ids_to_move = {
            taxonomy.CLASS_NAMES.index(n)
            for n in oracle.scene_difference_types(task)}
        print(f"[Task={task_id}] Ground truth: " + ", ".join(
            taxonomy.CLASS_NAMES[i] for i in object_ids_to_move))
        positions = np.asarray(
            [p[0][:2] for p in oracle.scene_difference_positions(task)]) \
            if record else np.zeros((0, 2))
        types = list(oracle.scene_difference_types(task)) if record else []
        return object_ids_to_move, positions, types

    def _finish_task(self, task_id: int, task, controller, analytics,
                     object_ids_to_move, objects_moved: set,
                     tracks: Dict[str, List], positions, types) -> Dict:
        """End the episode, and write and return its results."""
        cfg = self.config
        if not task.is_done():
            task.step(task.action_names().index("done"))
        if self._writer is not None:
            self._writer.close()
            self._writer = self._callback = None
        self._final_analytics(task, analytics)
        results = task.metrics()
        results["unshuffle/objects_moved"] = [
            taxonomy.CLASS_NAMES[i] for i in objects_moved]
        results["unshuffle/objects_moved_accuracy"] = [
            1 if i in object_ids_to_move else 0 for i in objects_moved]
        results["unshuffle/objects_to_move"] = [
            taxonomy.CLASS_NAMES[i] for i in object_ids_to_move]
        results["unshuffle/objects_to_move_accuracy"] = [
            1 if i in objects_moved else 0 for i in object_ids_to_move]
        # per-phase exploration coverage: each phase's own map
        results["walkthrough/observed_cells"] = \
            controller.observed_cell_count("semantic0")
        results["unshuffle/observed_cells"] = \
            controller.observed_cell_count("semantic1")
        results["timing"] = self.timer.summary()

        if cfg.logdir:
            M.write_task_metrics(cfg.logdir, task_id, results)
            M.write_analytics(cfg.logdir, task_id, analytics)
            if cfg.record_found_objects:
                for phase, track in tracks.items():
                    M.write_found_objects(cfg.logdir, task_id, phase,
                                          track or [], positions, types)
            if cfg.snapshot_maps:
                M.write_map_snapshots(cfg.logdir, task_id, self.maps)
        return results

    def run_task(self, task_id: int) -> Dict:
        if self.config.one_phase:
            return self._run_task_one_phase(task_id)
        cfg = self.config
        walkthrough, controller = self._start_task(task_id)

        analytics = self._initial_analytics(walkthrough)
        gt_goals_walk, gt_goals_unshuffle = [], []
        if cfg.ground_truth_semantic_search:
            for cur, target in oracle.scene_difference_positions(
                    walkthrough):
                gt_goals_walk.append(target)
                gt_goals_unshuffle.append(cur)

        walk_track: Optional[List] = ([] if cfg.record_found_objects
                                      else None)
        unshuffle_track: Optional[List] = ([] if cfg.record_found_objects
                                           else None)

        # --- walkthrough exploration
        self._explore(controller, cfg.exploration_budget_one, "semantic0",
                      self.phase_one, gt_goals_walk,
                      cfg.semantic_search_walkthrough, walk_track)

        # --- phase switch
        unshuffle = self.sampler.next_task()
        controller.task = unshuffle
        unshuffle.step(unshuffle.action_names().index("look_down"))
        object_ids_to_move, positions, types = self._misplaced(
            task_id, unshuffle, cfg.record_found_objects)

        # --- unshuffle exploration (the revisit head's phase)
        self._explore(controller, cfg.exploration_budget_two, "semantic1",
                      self.phase_two, gt_goals_unshuffle,
                      cfg.semantic_search_unshuffle, unshuffle_track,
                      revisit_ok=True)

        # --- rearrangement
        objects_moved: set = set()
        self._rearrange(controller, object_ids_to_move, objects_moved,
                        unshuffle_track)
        return self._finish_task(
            task_id, unshuffle, controller, analytics, object_ids_to_move,
            objects_moved, {"walkthrough": walk_track,
                            "unshuffle": unshuffle_track},
            positions, types)

    def _run_task_one_phase(self, task_id: int) -> Dict:
        """A single-task episode: every observation carries the goal
        world's render from the same pose, so one exploration pass with
        both budgets builds both maps; rearrangement then runs as
        usual."""
        cfg = self.config
        task, controller = self._start_task(task_id)

        analytics = self._initial_analytics(task)
        gt_goals: List[np.ndarray] = []
        if cfg.ground_truth_semantic_search:
            for cur, target in oracle.scene_difference_positions(task):
                gt_goals.extend([cur, target])
        object_ids_to_move, positions, types = self._misplaced(
            task_id, task, cfg.record_found_objects)
        track: Optional[List] = [] if cfg.record_found_objects else None

        self._explore(controller,
                      cfg.exploration_budget_one + cfg.exploration_budget_two,
                      "semantic1", self.phase_one + self.phase_two, gt_goals,
                      cfg.semantic_search_unshuffle, track)

        objects_moved: set = set()
        self._rearrange(controller, object_ids_to_move, objects_moved,
                        track)
        return self._finish_task(task_id, task, controller, analytics,
                                 object_ids_to_move, objects_moved,
                                 {"unshuffle": track}, positions, types)

    def run(self) -> List[Dict]:
        """Run the configured task range, advancing the config cursor so
        crash restarts resume after completed tasks."""
        cfg = self.config
        if cfg.logdir:
            os.makedirs(os.path.join(cfg.logdir, "results"),
                        exist_ok=True)
        all_metrics = []
        while cfg.total_tasks > 0:
            task_id = cfg.start_task
            if (cfg.resume and cfg.logdir and os.path.exists(
                    os.path.join(cfg.logdir, "results",
                                 f"{task_id}.json"))):
                # cross-process resume: skip the finished task's episode
                # so later tasks see the same seed cursor
                self.sampler.skip_task()
            else:
                all_metrics.append(self.run_task(task_id))
            for _ in range(cfg.every_tasks - 1):
                self.sampler.skip_task()
            object.__setattr__(cfg, "start_task",
                               cfg.start_task + cfg.every_tasks)
            object.__setattr__(cfg, "total_tasks", cfg.total_tasks - 1)
        return all_metrics

    # ------------------------------------------------------- analytics

    @staticmethod
    def _initial_analytics(task) -> List[Dict]:
        start, goal, current = task.env.poses
        pick = set(taxonomy.PICKABLE_TO_COLOR)
        openb = set(taxonomy.OPENABLE_TO_COLOR)
        return [M.object_analytics_record(
            c, g, current, task.env.are_poses_equal, pick, openb,
            "initial") for c, g in zip(start, goal)]

    @staticmethod
    def _final_analytics(task, records: List[Dict]) -> None:
        start, goal, current = task.env.poses
        pick = set(taxonomy.PICKABLE_TO_COLOR)
        openb = set(taxonomy.OPENABLE_TO_COLOR)
        for rec, c, g in zip(records, current, goal):
            rec.update(M.object_analytics_record(
                c, g, current, task.env.are_poses_equal, pick, openb,
                "final"))
        counts: Dict[str, int] = {}
        for rec in records:
            counts[rec["type"]] = counts.get(rec["type"], 0) + 1
        for rec in records:
            rec["num_instances"] = counts[rec["type"]]

    # ----------------------------------------------------------- video

    def _make_callback(self, writer):
        """The per-observation video frame: the camera view beside the
        navigation map's density (agent and planned path drawn over it)
        and both semantic maps' class colors, as uint8."""
        cfg = self.config

        def callback(obs):
            nav = self.maps[self.navigation_map].voxel_map
            cell = nav.world_to_map(
                np.asarray(obs["position"], np.float32)).cpu().numpy()
            path_cells = None
            if "path" in obs:
                path_cells = nav.world_to_map(
                    np.asarray(obs["path"], np.float32)).cpu().numpy()
            frame = viz.episode_frame(
                np.asarray(obs["rgb"], np.float32),
                viz.render_occupancy(
                    nav, cell, obs.get("yaw", 0.0), path_cells,
                    cfg.nav.map_slice_start, cfg.nav.map_slice_stop),
                viz.render_semantic(self.maps["semantic0"].voxel_map, 0,
                                    cfg.nav.map_slice_stop),
                viz.render_semantic(self.maps["semantic1"].voxel_map, 0,
                                    cfg.nav.map_slice_stop))
            writer.write((frame * 255).astype(np.uint8))
        return callback
