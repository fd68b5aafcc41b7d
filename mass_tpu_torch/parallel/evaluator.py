"""Lockstep fleet evaluation: B full rearrangement episodes sharing one
device step per stage (port of ``mass_tpu.parallel.evaluator``).

The sequential agent (``agent/loop.py``) runs one episode at a time.
This evaluator advances B grid-world episodes in lockstep instead:

  * mapping: every live episode's frame folds into the fleet's map
    buffers in one sort and one splat launch per group of families that
    the same episodes update (``parallel/fleet.FleetMaps``);
  * planning: the live episodes that refresh their mesh this step, and
    then the rest, each plan as one batch (``nav/grid.plan_batch``), and
    each batch's plans reach the host in one copy;
  * the per-episode state machine (phases, goal budgets, matching, grab
    and drop, failed-action pruning) stays on the host and reuses
    ``NavigationController.decide_from_plan``, so each episode takes the
    sequential agent's actions given the same rng seed.

This slice runs the sequential port's configurations: two-phase
episodes with ground-truth segmentation, random or ground-truth goals,
ground-truth or predicted disagreement and ``--reference-compat``.
Policy, frontier and revisit goals, one-phase episodes, learned
segmentation and feature matching raise ``NotImplementedError`` naming
their slice.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from mass_tpu_torch import resolve_device, taxonomy
from mass_tpu_torch.agent import oracle
from mass_tpu_torch.agent.loop import PHASE_ONE_MAPS, PHASE_TWO_MAPS, \
    _unported
from mass_tpu_torch.config import AgentConfig, MapGeometry
from mass_tpu_torch.core import geometry as G
from mass_tpu_torch.env.gridworld import snake_case
from mass_tpu_torch.match.differences import predict_scene_differences
from mass_tpu_torch.nav import grid as NG
from mass_tpu_torch.nav.controller import NavigationController
from mass_tpu_torch.parallel.fleet import FleetMaps
from mass_tpu_torch.utils.profiling import StageTimer


class _FleetLayerView:
    """The map-layer face of one episode's fleet slab (what
    ``NavigationController`` and the matcher read): a view, no copy."""

    def __init__(self, fleet: FleetMaps, name: str, episode: int):
        self._fleet = fleet
        self._episode = episode
        self.voxel_map = fleet.view(name, episode)

    @property
    def bins_epoch(self):
        return self._fleet.bins_epoch(self._episode)


class _Mission:
    """One navigate-to-goal pursuit plus actions to run on arrival."""

    def __init__(self, goal, arrival_steps: List[str], max_steps: int):
        self.goal = np.asarray(goal, np.float32)
        self.arrival_steps = arrival_steps
        self.max_steps = max_steps
        self.calls = 0          # planning calls so far (refresh cadence)


WALK, UNSHUFFLE, REARRANGE, DONE = range(4)


class _Episode:
    def __init__(self, index: int, sampler, config: AgentConfig,
                 fleet: FleetMaps, rng: np.random.RandomState):
        self.index = index
        self.sampler = sampler
        self.config = config
        self.rng = rng
        self.phase = WALK
        self.goals_used = 0
        self.mission: Optional[_Mission] = None
        self._queue: List[_Mission] = []
        self.objects_moved: set = set()
        self.results: Optional[Dict] = None
        self.map_updates = 0            # frames folded into the fleet
        # the sequential agent draws its policy key here, policy or not
        rng.randint(1 << 30)
        # --record-found-objects state (written by the CLI's fleet
        # driver): the agent's (x, z) per step, as the sequential agent
        # tracks it, and the misplaced objects
        self.walk_track: List[np.ndarray] = []
        self.unshuffle_track: List[np.ndarray] = []
        self.found_positions = np.zeros((0, 2))
        self.found_types: List[str] = []

        self.task = sampler.next_task()
        loc = self.task.agent_location()
        fleet.reset(index, (loc.x, loc.z, loc.y))
        maps = {name: _FleetLayerView(fleet, name, index)
                for name in fleet.names}
        self.controller = NavigationController(
            self.task, config.navigation_map_name, maps, config.nav,
            rng=rng)
        self.task.step(self.task.action_names().index("look_down"))

        self.gt_walk: List[np.ndarray] = []
        self.gt_unshuffle: List[np.ndarray] = []
        self.object_ids_to_move: set = set()
        self.unshuffle_budget = config.exploration_budget_two
        if config.ground_truth_semantic_search:
            for cur, target in oracle.scene_difference_positions(self.task):
                self.gt_walk.append(target)
                self.gt_unshuffle.append(cur)

    # ------------------------------------------------------------ fsm

    def update_names(self) -> List[str]:
        names = PHASE_ONE_MAPS if self.phase == WALK else PHASE_TWO_MAPS
        return [n for n in names if n in self.controller.maps]

    def _next_goal(self, gt_goals: List[np.ndarray]) -> np.ndarray:
        # as the sequential agent: the random sample is always drawn (it
        # advances the rng) even when a ground-truth goal wins
        goal = self.controller.sample_navigation_goal({})
        if gt_goals:
            return gt_goals.pop(0)
        return goal

    def _enter_unshuffle(self) -> None:
        self.task = self.sampler.next_task()
        self.controller.task = self.task
        self.task.step(self.task.action_names().index("look_down"))
        self.object_ids_to_move = {
            taxonomy.CLASS_NAMES.index(n)
            for n in oracle.scene_difference_types(self.task)}
        if self.config.record_found_objects:
            pos = [p[0][:2]
                   for p in oracle.scene_difference_positions(self.task)]
            self.found_positions = (np.asarray(pos) if pos
                                    else np.zeros((0, 2)))
            self.found_types = list(oracle.scene_difference_types(self.task))
        self.phase = UNSHUFFLE
        self.goals_used = 0

    def _match_missions(self, fleet: FleetMaps, timer: StageTimer) -> bool:
        """Run the matcher and queue grab/drop missions; False when no
        difference is left (the episode finishes)."""
        cfg = self.config
        candidates = (self.object_ids_to_move
                      if cfg.ground_truth_disagreement
                      else range(taxonomy.NUM_CLASSES))
        with timer.stage("matching"):
            cls, goals0, goals1 = predict_scene_differences(
                fleet.view("semantic0", self.index),
                fleet.view("semantic1", self.index), None, None,
                self.objects_moved, candidates, cfg.match)
        if cls is None:
            return False
        self.objects_moved.add(cls)

        # fix farthest-moved instances first to avoid conflicts
        d = np.linalg.norm(
            np.stack(goals0)[:, None] - np.stack(goals1)[None], axis=-1)
        order = np.argsort(-d.min(axis=1))
        goals0 = [goals0[i] for i in order]
        goals1 = [goals1[i] for i in order]

        cname = taxonomy.CLASS_NAMES[cls]
        pickable = taxonomy.ID_TO_PICKABLE[cls]
        grab = (f"pickup_{snake_case(cname)}" if pickable
                else f"open_by_type_{snake_case(cname)}")
        steps = cfg.nav.max_goal_steps
        self._queue = []
        for goal0, goal1 in zip(goals0, goals1):
            self._queue.append(_Mission(goal1, [grab], steps))
            if pickable:
                self._queue.append(_Mission(
                    goal0, ["drop_held_object_with_snap"], steps))
        return True

    def advance(self, fleet: FleetMaps, timer: StageTimer) -> None:
        """Ensure a current mission, moving the state machine on as
        phases and budgets demand.  May finish the episode."""
        cfg = self.config
        while self.mission is None and self.phase != DONE:
            if self.task.is_done():
                if self.phase == WALK:
                    # a done walkthrough ends only the walkthrough: the
                    # sequential agent goes on to the unshuffle task
                    self._enter_unshuffle()
                    continue
                self._finish()
                return
            if self.phase == WALK:
                if self.goals_used >= cfg.exploration_budget_one:
                    self._enter_unshuffle()
                    continue
                self.goals_used += 1
                self.mission = _Mission(self._next_goal(self.gt_walk), [],
                                        cfg.nav.max_goal_steps)
            elif self.phase == UNSHUFFLE:
                if self.goals_used >= self.unshuffle_budget:
                    self.phase = REARRANGE
                    self._queue = []
                    continue
                self.goals_used += 1
                self.mission = _Mission(self._next_goal(self.gt_unshuffle),
                                        [], cfg.nav.max_goal_steps)
            else:                                        # REARRANGE
                if self._queue:
                    self.mission = self._queue.pop(0)
                    continue
                if not self._match_missions(fleet, timer):
                    self._finish()
                    return

    def complete_mission(self) -> None:
        """Arrival (or give-up): run the queued manipulation steps."""
        names = self.task.action_names()
        for step_name in self.mission.arrival_steps:
            if self.task.is_done():
                break
            self.task.step(names.index(step_name))
        self.mission = None

    def _finish(self) -> None:
        if not self.task.is_done():
            self.task.step(self.task.action_names().index("done"))
        results = self.task.metrics()
        results["unshuffle/objects_moved"] = [
            taxonomy.CLASS_NAMES[i] for i in self.objects_moved]
        results["unshuffle/objects_moved_accuracy"] = [
            1 if i in self.object_ids_to_move else 0
            for i in self.objects_moved]
        results["unshuffle/objects_to_move"] = [
            taxonomy.CLASS_NAMES[i] for i in self.object_ids_to_move]
        results["unshuffle/objects_to_move_accuracy"] = [
            1 if i in self.objects_moved else 0
            for i in self.object_ids_to_move]
        results["walkthrough/observed_cells"] = \
            self.controller.observed_cell_count("semantic0")
        results["unshuffle/observed_cells"] = \
            self.controller.observed_cell_count("semantic1")
        self.results = results
        self.phase = DONE
        self.mission = None


def _unported_fleet(config: AgentConfig, policy_params, sensor,
                    feature_backbone) -> Optional[str]:
    """The later slice a fleet configuration needs, or None."""
    if policy_params is not None:
        return ("semantic-search policy goals (--policy-checkpoint) are "
                "ported in slice 2")
    if sensor is not None:
        return "learned segmentation sensors are ported in slice 3"
    if feature_backbone is not None:
        return "feature matching is ported in slice 3"
    return _unported(config)


class FleetEvaluator:
    """Run B episodes in lockstep over shared fleet maps.

    Args:
      config: agent configuration (the sequential port's two-phase
        configurations).
      samplers: one task sampler per episode (each yields that episode's
        walkthrough, then its unshuffle task).
      seeds: per-episode rng seeds (pose noise and goal sampling); the
        sequential agent given the same seed takes the same actions.
      policy_params, sensor, feature_backbone: the JAX package's policy
        goals, learned segmentation and feature matching, which arrive
        with later slices of the port.
      device: where the maps live; ``None`` means CUDA.
    """

    def __init__(self, config: AgentConfig, samplers: List,
                 seeds: Optional[List[int]] = None, policy_params=None,
                 sensor=None, feature_backbone=None, device=None):
        reason = _unported_fleet(config, policy_params, sensor,
                                 feature_backbone)
        if reason is not None:
            raise NotImplementedError(reason)
        self.config = config
        self.device = resolve_device(device)
        B = len(samplers)
        families = {"semantic0": taxonomy.NUM_CLASSES,
                    "semantic1": taxonomy.NUM_CLASSES}
        if not config.navigate_on_semantic:
            families["occupancy"] = 1
        # ONE fleet-level timer: a stage serves the whole lockstep batch,
        # so its summary lands on episode 0's results as fleet_timing
        self.timer = StageTimer(self.device)
        with self.timer.stage("init_fleet"):
            self.fleet = FleetMaps(
                B, config.camera,
                MapGeometry(map_height=config.map_height,
                            map_width=config.map_width,
                            map_depth=config.map_depth,
                            grid_resolution=config.grid_resolution),
                families, device=self.device)
        seeds = seeds or list(range(B))
        self.episodes = [
            _Episode(i, samplers[i], config, self.fleet,
                     np.random.RandomState(seeds[i])) for i in range(B)]

    # ---------------------------------------------------------- tick

    def _plan_group(self, group: List[_Episode], obs: Dict[int, Dict],
                    refresh: bool) -> Dict[int, tuple]:
        """One batched plan for the group, read back in one copy; each
        episode's plan as (plan tuple, host arrays)."""
        cfg = self.config.nav
        nav_name = self.config.navigation_map_name

        def put(array):                     # host array, no host sync
            return G.to_device(torch.from_numpy(array), self.device)
        agents = put(np.stack([obs[ep.index]["position"] for ep in group]
                              ).astype(np.float32))
        goals = put(np.stack([ep.mission.goal[:2] for ep in group]))
        blocked = None
        evidence = [ep.controller.blocked_cells for ep in group]
        if refresh and any(b is not None for b in evidence):
            g = self.fleet.base_geometry
            zero = np.zeros((g.map_height, g.map_width), bool)
            blocked = put(np.stack([zero if b is None else b
                                    for b in evidence]))
        grid, dist, tgt, agent_cell, goal_cell = NG.plan_batch(
            NG.stack_grids([ep.controller.nav_grid for ep in group]),
            [self.fleet.view(nav_name, ep.index) for ep in group], agents,
            goals, step=cfg.step_size, padding=cfg.obstacle_padding,
            z_start=cfg.map_slice_start, z_stop=cfg.map_slice_stop,
            threshold=cfg.obstacle_threshold, refresh=refresh,
            monotone=cfg.reference_compat, blocked=blocked)
        host = NG.plan_to_host(grid, dist, tgt, agent_cell)
        plans = {}
        for k, ep in enumerate(group):
            old = ep.controller.nav_grid
            grid_k = NG.NavGrid(alive=grid.alive[k],
                                edge_right=grid.edge_right[k],
                                edge_down=grid.edge_down[k],
                                off_x=old.off_x, off_y=old.off_y,
                                pruned=grid.pruned[k])
            plans[ep.index] = ((grid_k, dist[k], tgt[k], agent_cell[k],
                                goal_cell[k]), tuple(h[k] for h in host))
        return plans

    def tick(self) -> bool:
        """One lockstep step; returns False when every episode is done."""
        with self.timer.stage("fsm"):
            for ep in self.episodes:
                if ep.phase != DONE and ep.mission is None:
                    ep.advance(self.fleet, self.timer)
            live = [ep for ep in self.episodes if ep.phase != DONE]
        if not live:
            return False

        # --- observations and poses, one batched map update
        B = len(self.episodes)
        cam = self.config.camera
        positions = np.zeros((B, 3), np.float32)
        yaws = np.zeros((B,), np.float32)
        elevations = np.zeros((B,), np.float32)
        depths = np.full((B, cam.height, cam.width, 1), 1e9, np.float32)
        classes = {name: np.zeros((B, cam.height, cam.width), np.int32)
                   for name in ("semantic0", "semantic1")}
        active = {name: np.zeros((B,), bool) for name in self.fleet.names}
        obs: Dict[int, Dict] = {}
        with self.timer.stage("observe"):
            for ep in live:
                o = dict(ep.task.get_observations())
                ep.controller.process_observations(o, update_map=None)
                obs[ep.index] = o

        record_found = self.config.record_found_objects
        for ep in live:
            o = obs[ep.index]
            if record_found:
                # one tick is one step of each live episode; the
                # rearrangement steps join the unshuffle track
                loc = ep.task.agent_location()
                track = (ep.walk_track if ep.phase == WALK
                         else ep.unshuffle_track)
                track.append(np.asarray([loc.x, loc.z]))
            positions[ep.index] = o["position"]
            yaws[ep.index] = o["yaw"]
            elevations[ep.index] = o["elevation"]
            depths[ep.index] = np.asarray(o["depth"], np.float32)
            sem = np.asarray(o["semantic"])
            if sem.ndim == 3:
                sem = sem[..., 0]
            for name in ep.update_names():
                active[name][ep.index] = True
                if name in classes:
                    classes[name][ep.index] = sem
            ep.map_updates += 1
        with self.timer.stage("mapping"):
            self.fleet.update_batch(positions, yaws, elevations, depths,
                                    classes, active=active)

        # --- batched planning, then per-episode decisions and steps
        plans: Dict[int, tuple] = {}
        with self.timer.stage("planning"):
            for refresh in (True, False):
                group = [ep for ep in live
                         if _wants_refresh(ep, self.config.nav) == refresh]
                if group:
                    plans.update(self._plan_group(group, obs, refresh))
        for ep in live:
            ep.mission.calls += 1
            plan_out, host = plans[ep.index]
            with self.timer.stage("decide"):
                action = ep.controller.decide_from_plan(
                    obs[ep.index], ep.mission.goal, plan_out, host=host)
            done = ep.task.is_done()
            exhausted = (ep.mission.max_steps and
                         ep.mission.calls > ep.mission.max_steps)
            if done or action is None or exhausted:
                ep.complete_mission()
                # a done walkthrough is a phase switch, not an episode
                # end: the next tick's advance() enters the unshuffle
                if done and ep.phase != WALK:
                    ep._finish()
                continue
            with self.timer.stage("simulator"):
                result = ep.task.step(action)
            if not result.action_success:
                ep.controller.failed_action(obs[ep.index], action)
        return True

    def run(self) -> List[Dict]:
        """Tick until every episode is done; the episodes' results, with
        the fleet's stage times on episode 0's as ``fleet_timing``."""
        with self.timer.stage("tick_loop"):
            while self.tick():
                pass
        results = [ep.results for ep in self.episodes]
        if results and results[0] is not None:
            results[0]["fleet_timing"] = self.timer.summary()
        return results


def _wants_refresh(ep: _Episode, nav_cfg) -> bool:
    # navigate_to's cadence: a mission's first plan refreshes the mesh,
    # later ones every graph_update_interval steps
    k = ep.mission.calls
    return k == 0 or (k % nav_cfg.graph_update_interval == 0)
