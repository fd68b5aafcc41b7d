"""Point-goal navigation controller over the voxel maps (port of
``mass_tpu.nav.controller``).

Per step it folds the latest RGB-D observation into the selected maps,
plans on the nav grid (device BFS, host backtrack) and emits a discrete
action from a deterministic heading rule.  Failed moves deposit
collision evidence that erodes the mesh like a mapped obstacle.  Each
planned step reads the device once: every field the backtrack needs
comes back in one batched copy.  ``NavConfig.reference_compat`` pins the
reference's rules instead: a monotone mesh, termination on a path of
one node, next-node steering, and node pruning on every failed action.

Pose conventions: world = (x, z_sim, y_sim - crouch offset); yaw =
pi/2 - rotation; elevation = -horizon; a crouching agent's camera sits
0.675 m lower.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from mass_tpu_torch.config import NavConfig
from mass_tpu_torch.core.voxelmap import HostMapToWorld
from mass_tpu_torch.env.protocol import Task
from mass_tpu_torch.nav import grid as NG
from mass_tpu_torch.utils.profiling import StageTimer

CROUCH_HEIGHT_OFFSET = 0.675


class NavigationController:
    """Wraps a task + named voxel maps; provides ``navigate_to``.

    ``maps`` is a ``MapSet`` (``mass_tpu_torch.maps``);
    ``navigation_map`` names the layer the planner reads for
    traversability.
    """

    def __init__(self, task: Task, navigation_map: str,
                 maps: Dict[str, object], config: NavConfig = NavConfig(),
                 rng: Optional[np.random.RandomState] = None,
                 timer: Optional[StageTimer] = None):
        self.task = task
        self.maps = maps
        self.navigation_map = navigation_map
        self.config = config
        self.rng = rng or np.random.RandomState(0)
        self.timer = timer or StageTimer()
        self.nav_grid: Optional[NG.NavGrid] = None
        # collision evidence [H, W] (host bool): cells the simulator
        # proved blocked (failed moves), eroded like mapped obstacles
        self.blocked_cells: Optional[np.ndarray] = None
        self._blocked_dev: Optional[torch.Tensor] = None
        self._map_to_world = HostMapToWorld()
        # rotation-oscillation breaker state (see decide_from_plan)
        self._last_rot = 0
        self._last_rot_pos = None
        # navigable_node_cells memo: (key, grid, blocked, result); the
        # grid and evidence objects are held so their ids stay unique
        self._nodes_cache = None
        self.reset_navigation_grid()

    # ------------------------------------------------------------ pose

    def process_position(self) -> np.ndarray:
        loc = self.task.agent_location()
        dy = 0.0 if loc.standing else CROUCH_HEIGHT_OFFSET
        return np.asarray([loc.x, loc.z, loc.y - dy], np.float32)

    def process_yaw(self) -> float:
        loc = self.task.agent_location()
        return float(np.pi / 2 - np.radians(loc.rotation_degrees))

    def process_elevation(self) -> float:
        return float(-np.radians(self.task.agent_location()
                                 .horizon_degrees))

    def process_observations(self, observations: Dict,
                             update_map: Union[str, List[str], None]
                             = None) -> None:
        """Attach the pose (with optional Gaussian noise; both draws
        happen even at zero noise, keeping the rng stream aligned) and
        fold the frame into the selected maps."""
        observations["position"] = (
            self.process_position() +
            self.rng.normal() * self.config.position_noise_std)
        observations["yaw"] = (
            self.process_yaw() +
            self.rng.normal() * self.config.rotation_noise_std)
        observations["elevation"] = self.process_elevation()
        if update_map is None:
            return
        names = [update_map] if isinstance(update_map, str) else \
            update_map
        with self.timer.stage("mapping"):
            self.maps.update_group(names, observations)

    # ------------------------------------------------------------ mesh

    def _occupancy_vm(self):
        return self.maps[self.navigation_map].voxel_map

    def _bins_epoch(self):
        return self.maps[self.navigation_map].bins_epoch

    def _blocked_operand(self) -> Optional[torch.Tensor]:
        if self.blocked_cells is None:
            return None
        if self._blocked_dev is None:
            self._blocked_dev = torch.as_tensor(
                self.blocked_cells, device=self._occupancy_vm().device)
        return self._blocked_dev

    def _navigable(self):
        cfg = self.config
        return NG.navigable_area(
            self._occupancy_vm(), padding=cfg.obstacle_padding,
            z_start=cfg.map_slice_start, z_stop=cfg.map_slice_stop,
            obstacle_threshold=cfg.obstacle_threshold,
            blocked=self._blocked_operand())

    def _origin_offsets(self):
        vm = self._occupancy_vm()
        g = vm.geometry
        # cell of the map origin, so the start location owns a node
        half = float(np.float32(g.grid_resolution / 2))
        origin = torch.stack([(vm.bins_x[0] + vm.bins_x[-1]) / 2 + half,
                              (vm.bins_y[0] + vm.bins_y[-1]) / 2 + half])
        cell = vm.world_to_map(origin).cpu().numpy()
        s = self.config.step_size
        return int(cell[0]) % s, int(cell[1]) % s

    def reset_navigation_grid(self) -> None:
        self.blocked_cells = None      # fresh scene, fresh evidence
        self._blocked_dev = None
        off_x, off_y = self._origin_offsets()
        self.nav_grid = NG.build_nav_grid(
            self._navigable(), off_x, off_y, step=self.config.step_size)

    def update_navigation_grid(self) -> None:
        self.nav_grid = NG.refresh_nav_grid(
            self.nav_grid, self._navigable(), step=self.config.step_size,
            monotone=self.config.reference_compat)

    # -------------------------------------------------------- planning

    def _cells_of_world(self, world_xy) -> np.ndarray:
        """Map cells of world points ``[..., >=2]`` (one device read)."""
        pts = torch.as_tensor(np.asarray(world_xy, np.float32)[..., :2])
        return self._occupancy_vm().world_to_map(pts).cpu().numpy()

    def _source_field(self, position):
        """BFS field seeded from all alive nodes near the agent (robust
        when the agent's own node was pruned or isolated)."""
        dev = self._occupancy_vm().device
        cell = torch.as_tensor(self._cells_of_world(position), device=dev)
        s = self.config.step_size
        seeds = NG.seeds_near_cell(self.nav_grid, cell, s,
                                   radius_cells=2 * s)
        if not bool(seeds.any()):
            src = NG.nearest_node(
                self.nav_grid,
                torch.zeros_like(self.nav_grid.alive, dtype=torch.int32),
                cell, s, reachable_only=False)
            seeds = torch.zeros_like(self.nav_grid.alive)
            seeds[src[1], src[0]] = True
        return NG.distance_field_from_seeds(self.nav_grid, seeds)

    def _path_from_field(self, dist: np.ndarray, tgt: np.ndarray,
                         src_cell: np.ndarray,
                         grid: NG.NavGrid) -> np.ndarray:
        """Host backtrack of a planned field into world waypoints, with
        the true source cell prepended when it is off-node."""
        vm = self._occupancy_vm()
        cells = NG.extract_path(grid, dist, tgt, self.config.step_size)
        if cells.shape[0] == 0:
            cells = np.asarray(src_cell, np.int32)[None]
        if not np.array_equal(cells[0], src_cell):
            cells = np.concatenate(
                [np.asarray(src_cell, np.int32)[None], cells], axis=0)
        cells3 = np.concatenate(
            [cells, np.zeros((cells.shape[0], 1), cells.dtype)], axis=1)
        return self._map_to_world(vm, cells3, epoch=self._bins_epoch())

    def shortest_path(self, source_world, target_world) -> np.ndarray:
        """World waypoint path source -> target on the current mesh: the
        source snaps to its nearest node, the target to the nearest
        reachable one; the true source is prepended when off-node."""
        cfg = self.config
        dev = self._occupancy_vm().device
        _, dist, tgt, agent_cell, _ = NG.plan(
            self.nav_grid, self._occupancy_vm(),
            torch.as_tensor(np.asarray(source_world, np.float32), device=dev),
            torch.as_tensor(np.asarray(target_world, np.float32), device=dev),
            step=cfg.step_size, padding=cfg.obstacle_padding,
            z_start=cfg.map_slice_start, z_stop=cfg.map_slice_stop,
            threshold=cfg.obstacle_threshold, refresh=False,
            monotone=cfg.reference_compat)
        grid = self.nav_grid._replace(
            edge_right=self.nav_grid.edge_right.cpu().numpy(),
            edge_down=self.nav_grid.edge_down.cpu().numpy())
        return self._path_from_field(dist.cpu().numpy(), tgt.cpu().numpy(),
                                     agent_cell.cpu().numpy(), grid=grid)

    def navigable_node_cells(
            self, position, with_dist: bool = False
    ) -> Union[np.ndarray, Tuple[np.ndarray, np.ndarray]]:
        """Map cells of all nodes reachable from ``position``; with
        ``with_dist`` also their BFS hop counts.  Memoized on (position,
        nav grid, evidence) — the same inputs give the same field."""
        pos = np.asarray(position, np.float32)
        key = pos.tobytes()
        cache = self._nodes_cache
        if cache is not None and cache[0] == key and \
                cache[1] is self.nav_grid and cache[2] is self.blocked_cells:
            cells, hops = cache[3]
        else:
            dist = self._source_field(pos)
            both = torch.stack([dist, self.nav_grid.alive.to(dist.dtype)])
            dist, alive = both.cpu().numpy()
            ii, jj = np.nonzero((dist < NG.INF) & (alive > 0))
            s = self.config.step_size
            xs = self.nav_grid.off_x + jj * s
            ys = self.nav_grid.off_y + ii * s
            cells = np.stack([xs, ys], axis=-1)
            hops = dist[ii, jj]
            self._nodes_cache = (key, self.nav_grid, self.blocked_cells,
                                 (cells, hops))
        return (cells, hops) if with_dist else cells

    def observed_cell_count(self, map_name: Optional[str] = None) -> int:
        """Number of map cells with any splat (end-of-episode exploration
        coverage); defaults to the nav map."""
        vm = (self._occupancy_vm() if map_name is None
              else self.maps[map_name].voxel_map)
        return int((vm.max_over_depth().amax(-1) > 0).sum())

    def sample_navigation_goal(self, observations: Dict) -> np.ndarray:
        """Uniform random reachable node, as a world point."""
        if "position" not in observations:
            observations["position"] = self.process_position()
        nodes = self.navigable_node_cells(observations["position"])
        pick = nodes[self.rng.randint(nodes.shape[0])]
        cell3 = np.asarray([pick[0], pick[1], 0], np.float32)
        return self._map_to_world(self._occupancy_vm(), cell3,
                                  epoch=self._bins_epoch())

    def frontier_navigation_goal(self, observations: Dict,
                                 radius_m: float = 1.0) -> np.ndarray:
        """Farthest frontier: of the reachable nodes with any frontier
        cell (``nav/grid.frontier_mass``) within ``radius_m``, the one
        with the most BFS hops from the agent, ties broken by one rng
        draw; with no frontier left, a uniform random node (one draw).

        Farthest rather than greatest mass: frontier nodes sit at the
        edge of known space, so the mass argmax is a short hop that
        spends a goal of the budget, where a far goal sweeps the scene
        on its way.  Frontier mass is computed without obstacle padding:
        erosion is a planning margin, and it would wipe out the thin
        free strips of a sparsely observed map."""
        if "position" not in observations:
            observations["position"] = self.process_position()
        nodes, hops = self.navigable_node_cells(
            observations["position"], with_dist=True)
        cfg = self.config
        res = self._occupancy_vm().geometry.grid_resolution
        radius = max(1, int(round(radius_m / res)))
        mass = NG.frontier_mass(
            self._occupancy_vm(), radius, padding=0,
            z_start=cfg.map_slice_start, z_stop=cfg.map_slice_stop,
            obstacle_threshold=cfg.obstacle_threshold,
            blocked=self._blocked_operand()).cpu().numpy()
        scores = mass[nodes[:, 1], nodes[:, 0]]
        cand = np.flatnonzero(scores > 0)
        if cand.size == 0:                 # fully explored: uniform
            pick = nodes[self.rng.randint(nodes.shape[0])]
        else:
            far = hops[cand].max()
            ties = cand[hops[cand] >= far]
            pick = nodes[ties[self.rng.randint(ties.shape[0])]]
        cell3 = np.asarray([pick[0], pick[1], 0], np.float32)
        return self._map_to_world(self._occupancy_vm(), cell3,
                                  epoch=self._bins_epoch())

    # ------------------------------------------------------ local policy

    @staticmethod
    def get_heading(observations: Dict, goal: np.ndarray) -> float:
        """Egocentric yaw toward ``goal``, wrapped to [-pi, pi]."""
        direction = np.asarray(goal)[:2] - \
            np.asarray(observations["position"])[:2]
        yaw = float(np.arctan2(direction[1], direction[0]) -
                    observations["yaw"])
        if abs(yaw) > np.pi:
            yaw = -np.sign(yaw) * (2 * np.pi - abs(yaw))
        return yaw

    def get_action(self, observations: Dict, goal,
                   update_map=None,
                   update_navigation_grid: bool = True) -> Optional[int]:
        """Plan + heading rule -> move_ahead / rotate_left /
        rotate_right / None-at-goal."""
        self.process_observations(observations, update_map=update_map)

        goal = np.asarray(goal, np.float32)
        cfg = self.config
        dev = self._occupancy_vm().device
        with self.timer.stage("planning"):
            plan_out = NG.plan(
                self.nav_grid, self._occupancy_vm(),
                torch.as_tensor(np.asarray(observations["position"],
                                           np.float32), device=dev),
                torch.as_tensor(goal, device=dev),
                step=cfg.step_size, padding=cfg.obstacle_padding,
                z_start=cfg.map_slice_start, z_stop=cfg.map_slice_stop,
                threshold=cfg.obstacle_threshold,
                refresh=bool(update_navigation_grid),
                monotone=cfg.reference_compat,
                blocked=(self._blocked_operand()
                         if update_navigation_grid else None))
        return self.decide_from_plan(observations, goal, plan_out)

    def decide_from_plan(self, observations: Dict, goal, plan_out,
                         host=None) -> Optional[int]:
        """Adopt the planned mesh, backtrack the field into a path and
        apply the heading rule.  ``host`` is the plan's
        :func:`~mass_tpu_torch.nav.grid.plan_to_host` arrays when the
        caller already copied a batch of plans to the host at once (the
        fleet); the mesh itself stays on the map's device."""
        goal = np.asarray(goal, np.float32)
        grid, dist, tgt, agent_cell, _ = plan_out
        with self.timer.stage("planning"):
            self.nav_grid = grid
            if host is None:
                # ONE device-to-host copy of everything the backtrack reads
                host = NG.plan_to_host(grid, dist, tgt, agent_cell)
            dist_h, tgt_h, agent_h, er, ed = host
            host_grid = grid._replace(edge_right=er, edge_down=ed)
            path = self._path_from_field(dist_h, tgt_h, agent_h,
                                         grid=host_grid)
        observations["path"] = path

        if self.config.reference_compat:
            # reference termination: the planned path has collapsed to
            # the source node; else steer at the next node, strict pi/4
            if path.shape[0] <= 1:
                observations["heading"] = 0.0
                return None
            heading = self.get_heading(observations, path[1])
            observations["heading"] = heading
            names = self.task.action_names()
            if abs(heading) <= np.pi / 4:
                return names.index("move_ahead")
            return names.index("rotate_left" if heading > 0
                               else "rotate_right")

        # arrived: standing (within a node's reach) on the closest
        # reachable node to the goal
        res = self._occupancy_vm().geometry.grid_resolution
        arrival = 0.75 * self.config.step_size * res
        pos = np.asarray(observations["position"][:2])
        end = np.asarray(path[-1][:2])
        # mesh slack: how far the best reachable node sits from the goal
        goal_slack = float(np.linalg.norm(goal[:2] - end))
        # a goal beside an obstacle (object-sized slack) may terminate
        # on slack; far snaps keep the pursuit alive
        slack_cap = (self.config.obstacle_padding +
                     2 * self.config.step_size) * res + 0.45
        if (np.linalg.norm(end - pos) <= arrival or
                (goal_slack <= slack_cap and
                 np.linalg.norm(goal[:2] - pos) <= goal_slack + arrival)):
            observations["heading"] = 0.0
            return None

        if np.allclose(observations["position"][:2], goal[:2]):
            heading = 0.0
        else:
            # pure-pursuit waypoint: the farthest-along path point within
            # a lookahead radius
            lookahead = 0.36
            waypoint = path[1] if path.shape[0] > 1 else goal
            for cand in path[1:]:
                if np.linalg.norm(np.asarray(cand[:2]) - pos) \
                        <= lookahead:
                    waypoint = cand
            if np.linalg.norm(end - pos) <= lookahead and \
                    goal_slack <= arrival:
                # steer at the goal point only when it is mesh-adjacent
                waypoint = goal
            heading = self.get_heading(observations, waypoint)
        observations["heading"] = heading

        names = self.task.action_names()
        if path.shape[0] > 1 and abs(heading) <= np.pi / 4:
            if not self._evidence_toward(observations, 0.0):
                return names.index("move_ahead")
            # the simulator already refused a move through the facing
            # cells: turn toward the waypoint side, else back off, else
            # turn away
            first = np.pi / 2 if heading >= 0 else -np.pi / 2
            if not self._evidence_toward(observations, first):
                return names.index("rotate_left" if heading >= 0
                                   else "rotate_right")
            if "move_back" in names and not self._evidence_toward(
                    observations, np.pi):
                return names.index("move_back")
            return names.index("rotate_right" if heading >= 0
                               else "rotate_left")
        if abs(heading) > np.pi / 4:
            # hysteresis band just outside pi/4: moving on the current
            # evidence-free facing still advances the plan
            if (abs(heading) <= np.pi / 4 + 0.05 and
                    path.shape[0] > 1 and
                    not self._evidence_toward(observations, 0.0)):
                return names.index("move_ahead")
            rot = 1 if heading > 0 else -1
            pos_t = tuple(np.round(pos, 3))
            if (rot == -self._last_rot and
                    pos_t == self._last_rot_pos and
                    not self._evidence_toward(observations, 0.0)):
                # left/right flip-flop at one spot: step forward instead
                self._last_rot = 0
                return names.index("move_ahead")
            self._last_rot = rot
            self._last_rot_pos = pos_t
            return names.index("rotate_left" if rot > 0
                               else "rotate_right")
        return None

    def _swept_cells(self, observations: Dict,
                     yaw_offset: float) -> np.ndarray:
        """Clipped ``(x, y)`` cells a move in direction ``yaw +
        yaw_offset`` sweeps: from just past the agent's cell out to one
        move length (~0.3 m)."""
        g = self._occupancy_vm().geometry
        pos = np.asarray(observations["position"][:2], np.float64)
        yaw = float(observations["yaw"]) + yaw_offset
        fwd = np.asarray([np.cos(yaw), np.sin(yaw)])
        res = g.grid_resolution
        radii = np.arange(res, 0.3 + res, res)
        cells = self._cells_of_world(pos[None] + radii[:, None] * fwd)
        xs = np.clip(cells[:, 0], 0, g.map_width - 1)
        ys = np.clip(cells[:, 1], 0, g.map_height - 1)
        return np.stack([xs, ys], axis=-1)

    def _evidence_toward(self, observations: Dict,
                         yaw_offset: float) -> bool:
        """True when collision evidence blocks the cells a move in
        direction ``yaw + yaw_offset`` would sweep."""
        if self.blocked_cells is None:
            return False
        cells = self._swept_cells(observations, yaw_offset)
        return bool(self.blocked_cells[cells[:, 1], cells[:, 0]].any())

    def failed_action(self, observations: Dict, action: int) -> None:
        """Record why the simulator refused the action and replan.

        Failed moves deposit collision evidence: the swept cells join
        ``blocked_cells`` and the mesh refreshes at once.  Failed
        rotations, and every failure under ``reference_compat``, prune
        the first alive path node (sticky, ``NavGrid.pruned``); a failed
        move looks past the source cell.
        """
        names = self.task.action_names()
        is_move = "rotate" not in names[action]
        if is_move and not self.config.reference_compat:
            g = self._occupancy_vm().geometry
            cells = self._swept_cells(observations, 0.0)
            blocked = (np.zeros((g.map_height, g.map_width), bool)
                       if self.blocked_cells is None
                       else self.blocked_cells.copy())
            blocked[cells[:, 1], cells[:, 0]] = True
            # a fresh array per change: the node memo and the device
            # copy both key on the object
            self.blocked_cells = blocked
            self._blocked_dev = None
            self.update_navigation_grid()
            return
        path = observations.get("path")
        if path is None or path.shape[0] == 0:
            return
        s = self.config.step_size
        off_x, off_y = self.nav_grid.off_x, self.nav_grid.off_y
        alive = self.nav_grid.alive.cpu().numpy().copy()
        ny, nx = alive.shape
        path = np.asarray(path)[1 if is_move else 0:]
        if path.shape[0] == 0:
            return
        cells = self._cells_of_world(path[:, :2])
        for cell in cells:
            j, i = (int(cell[0]) - off_x) // s, (int(cell[1]) - off_y) // s
            on_node = (int(cell[0]) - off_x) % s == 0 and \
                (int(cell[1]) - off_y) % s == 0 and \
                0 <= i < ny and 0 <= j < nx and alive[i, j]
            if on_node:
                # sticky prune: a fresh refresh cannot resurrect a node
                # the simulator refused to enter
                dev = self.nav_grid.alive.device
                alive[i, j] = False
                pruned = self.nav_grid.pruned.cpu().numpy().copy()
                pruned[i, j] = True
                self.nav_grid = self.nav_grid._replace(
                    alive=torch.as_tensor(alive, device=dev),
                    pruned=torch.as_tensor(pruned, device=dev))
                return

    # --------------------------------------------------------- rollout

    def navigate_to(self, goal, update_map=None,
                    max_steps: Optional[int] = None) -> Iterator[Dict]:
        """Generator: walk toward ``goal``, yielding each observation,
        stepping the simulator, recording failures, refreshing the mesh
        every ``graph_update_interval`` steps.  ``max_steps`` bounds one
        goal pursuit."""
        interval = self.config.graph_update_interval
        max_steps = max_steps or self.config.max_goal_steps
        with self.timer.stage("simulator"):
            observations = self.task.get_observations()
        action = self.get_action(observations, goal,
                                 update_map=update_map,
                                 update_navigation_grid=True)
        time_step = 0
        while True:
            time_step += 1
            yield observations
            if self.task.is_done() or action is None or \
                    (max_steps and time_step > max_steps):
                return
            with self.timer.stage("simulator"):
                result = self.task.step(action)
            if not result.action_success:
                self.failed_action(observations, action)
            with self.timer.stage("simulator"):
                observations = self.task.get_observations()
            action = self.get_action(
                observations, goal, update_map=update_map,
                update_navigation_grid=time_step % interval == 0)
