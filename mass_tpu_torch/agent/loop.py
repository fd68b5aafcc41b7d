"""The two-phase rearrangement episode driver (port of
``mass_tpu.agent.loop``).

Build the walkthrough semantic map while exploring, build a second map
in the shuffled scene, diff the maps to find displaced objects, and
navigate / pick / place to fix them.  This slice of the port runs the
random and ground-truth goal heads; the policy, frontier and revisit
heads, one-phase episodes and feature matching arrive with later slices
and raise ``NotImplementedError`` naming theirs.

Every numpy random draw happens in the JAX package's order, so a seeded
episode takes the same actions in both packages.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from mass_tpu_torch import resolve_device, taxonomy
from mass_tpu_torch.agent import metrics as M
from mass_tpu_torch.agent import oracle
from mass_tpu_torch.config import AgentConfig
from mass_tpu_torch.env.gridworld import snake_case
from mass_tpu_torch.maps import MapSet, SemanticMap
from mass_tpu_torch.match.differences import predict_scene_differences
from mass_tpu_torch.nav.controller import NavigationController
from mass_tpu_torch.utils.profiling import StageTimer


def _unported(config: AgentConfig) -> Optional[str]:
    """The later slice a configuration needs, or None."""
    if config.one_phase:
        return "one-phase episodes (--one-phase) are ported in slice 2"
    if not config.navigate_on_semantic or config.nav.reference_compat:
        return ("the separate occupancy layer (--reference-compat) needs "
                "the multi-map splat kernel, ported in slice 2")
    if config.frontier_exploration or config.revisit_exploration:
        return ("frontier and revisit goal heads are ported in slice 2")
    if config.use_feature_matching:
        return "feature matching is ported in slice 3"
    if config.shard_map > 1:
        return "row-sharded maps (--shard-map) are ported in slice 4"
    if config.snapshot_maps:
        return "map snapshots (--snapshot-maps) are ported in slice 3"
    return None


class RearrangementAgent:
    """Runs rearrangement episodes from a task sampler.

    Args:
      config: full agent configuration.
      sampler: walkthrough/unshuffle alternating task source.
      rng: numpy generator for goal sampling and pose noise.
      device: where the maps live; ``None`` means CUDA.
    """

    def __init__(self, config: AgentConfig, sampler,
                 rng: Optional[np.random.RandomState] = None,
                 device=None):
        reason = _unported(config)
        if reason is not None:
            raise NotImplementedError(reason)
        self.config = config
        self.sampler = sampler
        self.rng = rng or np.random.RandomState(0)
        self.device = resolve_device(device)
        self.timer = StageTimer(self.device)

        cam = config.camera
        geo_kw = dict(map_height=config.map_height,
                      map_width=config.map_width,
                      map_depth=config.map_depth,
                      grid_resolution=config.grid_resolution)
        self.maps = MapSet(
            semantic0=SemanticMap(cam, taxonomy.NUM_CLASSES,
                                  device=self.device, **geo_kw),
            semantic1=SemanticMap(cam, taxonomy.NUM_CLASSES,
                                  device=self.device, **geo_kw))
        # the planner reads the walkthrough map (config.py:200,
        # navigate_on_semantic), so each step updates one map
        self.navigation_map = config.navigation_map_name
        self.phase_one = ["semantic0"]
        self.phase_two = ["semantic1"]
        # the JAX agent seeds its policy PRNG key here, policy or not;
        # the same draw keeps both packages' rng streams aligned
        self.rng.randint(1 << 30)

    # ------------------------------------------------------- goal heads

    def _next_goal(self, controller,
                   gt_goals: List[np.ndarray]) -> np.ndarray:
        # the random sample is drawn before the GT check, as in the JAX
        # package, so GT-goal episodes consume the same rng stream
        goal = controller.sample_navigation_goal({})
        if gt_goals:
            return gt_goals.pop(0)
        return goal

    # -------------------------------------------------------- phases

    def _explore(self, controller, budget: int, update_maps: List[str],
                 gt_goals: List[np.ndarray], tracker) -> None:
        num_goals = 0
        while not controller.task.is_done() and num_goals < budget:
            num_goals += 1
            goal = self._next_goal(controller, gt_goals)
            for _ in controller.navigate_to(goal, update_map=update_maps):
                if tracker is not None:
                    loc = controller.task.agent_location()
                    tracker.append(np.asarray([loc.x, loc.z]))

    def _navigate(self, controller, goal, tracker) -> None:
        for _ in controller.navigate_to(goal, update_map=self.phase_two):
            if tracker is not None:
                loc = controller.task.agent_location()
                tracker.append(np.asarray([loc.x, loc.z]))

    def _rearrange(self, controller, object_ids_to_move,
                   objects_moved: set, tracker) -> None:
        """Detection / match / fix loop."""
        cfg = self.config
        task = controller.task
        names = task.action_names()

        while not task.is_done():
            candidates = (object_ids_to_move
                          if cfg.ground_truth_disagreement
                          else range(taxonomy.NUM_CLASSES))
            with self.timer.stage("matching"):
                cls, goals0, goals1 = predict_scene_differences(
                    self.maps["semantic0"].voxel_map,
                    self.maps["semantic1"].voxel_map, None, None,
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

    def run_task(self, task_id: int) -> Dict:
        cfg = self.config
        self.timer = StageTimer(self.device)    # fresh per-task timing
        walkthrough = self.sampler.next_task()

        loc = walkthrough.agent_location()
        self.maps.reset_all((loc.x, loc.z, loc.y))
        controller = NavigationController(
            walkthrough, self.navigation_map, self.maps, cfg.nav,
            rng=self.rng, timer=self.timer)

        # the agent behaves better looking down
        walkthrough.step(walkthrough.action_names().index("look_down"))

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
        self._explore(controller, cfg.exploration_budget_one,
                      self.phase_one, gt_goals_walk, walk_track)

        # --- phase switch
        unshuffle = self.sampler.next_task()
        controller.task = unshuffle
        unshuffle.step(unshuffle.action_names().index("look_down"))

        object_ids_to_move = {
            taxonomy.CLASS_NAMES.index(n)
            for n in oracle.scene_difference_types(unshuffle)}
        print(f"[Task={task_id}] Ground truth: " + ", ".join(
            taxonomy.CLASS_NAMES[i] for i in object_ids_to_move))

        object_positions = np.asarray(
            [p[0][:2] for p in
             oracle.scene_difference_positions(unshuffle)]) \
            if cfg.record_found_objects else np.zeros((0, 2))
        object_types = (list(oracle.scene_difference_types(unshuffle))
                        if cfg.record_found_objects else [])

        # --- unshuffle exploration
        self._explore(controller, cfg.exploration_budget_two,
                      self.phase_two, gt_goals_unshuffle, unshuffle_track)

        # --- rearrangement
        objects_moved: set = set()
        self._rearrange(controller, object_ids_to_move, objects_moved,
                        unshuffle_track)

        if not unshuffle.is_done():
            unshuffle.step(unshuffle.action_names().index("done"))

        # --- outputs
        self._final_analytics(unshuffle, analytics)
        results = unshuffle.metrics()
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
                M.write_found_objects(cfg.logdir, task_id,
                                      "walkthrough", walk_track or [],
                                      object_positions, object_types)
                M.write_found_objects(cfg.logdir, task_id, "unshuffle",
                                      unshuffle_track or [],
                                      object_positions, object_types)
        return results

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
