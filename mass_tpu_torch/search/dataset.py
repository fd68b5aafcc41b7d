"""Collect training data for the semantic-search policy (port of
``mass_tpu.search.dataset``).

Each scene is explored the way the agent explores it (ground-truth goals
first, then random ones), and after every completed goal the
z-collapsed semantic map is snapshotted as a training input for the
labelled misplaced-object cells.  Walkthrough snapshots pair with the
objects' walkthrough cells, unshuffle snapshots with their current
cells.  The maps live on ``--device`` (default ``cuda``), where each
frame's group splat launches the card's kernels: the walkthrough folds
``occupancy`` and ``semantic0`` together (the multi-map kernel), the
unshuffle ``semantic1`` alone (the single-map kernel).

    python -m mass_tpu_torch.search.dataset --logdir /tmp/search-data \\
        --total-tasks 80

Each task writes ``task-{id}.npz`` with float16 ``tops{0,1}``
``[G, H, W, C]`` and int32 ``cells{0,1}`` ``[K, 2]`` (x, y map cells), as
the JAX package does.  ``tops1`` leads with the decision-time snapshot,
so it has budget + 1 entries; ``tops0[-1]`` is the finished walkthrough
map, the context of ``search.train --conditioned``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import List

import numpy as np

from mass_tpu_torch import resolve_device, taxonomy
from mass_tpu_torch.agent import oracle
from mass_tpu_torch.config import (AgentConfig, CameraConfig, MatchConfig,
                                   NavConfig)
from mass_tpu_torch.maps import MapSet, OccupancyMap, SemanticMap
from mass_tpu_torch.nav.controller import NavigationController


def _snapshot(layer) -> np.ndarray:
    """The layer's ``[H, W, F]`` max over depth as float16 on the host."""
    return layer.voxel_map.max_over_depth().cpu().numpy().astype(np.float16)


def collect_task(sampler, config: AgentConfig, rng: np.random.RandomState,
                 device=None) -> dict:
    """Run one two-phase exploration on ``device``; return the
    snapshot and label arrays."""
    cfg = config
    cam = cfg.camera
    device = resolve_device(device)
    geo_kw = dict(map_height=cfg.map_height, map_width=cfg.map_width,
                  map_depth=cfg.map_depth,
                  grid_resolution=cfg.grid_resolution, device=device)
    maps = MapSet(
        semantic0=SemanticMap(cam, taxonomy.NUM_CLASSES, **geo_kw),
        semantic1=SemanticMap(cam, taxonomy.NUM_CLASSES, **geo_kw),
        occupancy=OccupancyMap(cam, **geo_kw))

    walkthrough = sampler.next_task()
    loc = walkthrough.agent_location()
    maps.reset_all((loc.x, loc.z, loc.y))
    controller = NavigationController(walkthrough, "occupancy", maps,
                                      cfg.nav, rng=rng)
    walkthrough.step(walkthrough.action_names().index("look_down"))

    vm = maps["semantic0"].voxel_map
    cells_walk, cells_unshuffle = [], []
    gt_walk, gt_unshuffle = [], []
    for current, target in oracle.scene_difference_positions(
            walkthrough):
        cells_walk.append(
            vm.world_to_map(target).cpu().numpy()[:2].astype(np.int32))
        cells_unshuffle.append(
            vm.world_to_map(current).cpu().numpy()[:2].astype(np.int32))
        gt_walk.append(target)
        gt_unshuffle.append(current)

    def explore(task, budget, semantic_name, update_names,
                gt_goals: List[np.ndarray],
                initial_snapshot: bool = False) -> List[np.ndarray]:
        tops = []
        gt_goals = list(gt_goals)
        if initial_snapshot:
            # decision-time state of the first goal: the nearly empty
            # post-look_down map, the conditioned head's first unshuffle
            # input
            tops.append(_snapshot(maps[semantic_name]))
        num_goals = 0
        while not task.is_done() and num_goals < budget:
            num_goals += 1
            goal = controller.sample_navigation_goal({})
            if gt_goals:
                goal = gt_goals.pop(0)
            for _ in controller.navigate_to(goal,
                                            update_map=update_names):
                pass
            tops.append(_snapshot(maps[semantic_name]))
        return tops

    tops0 = explore(walkthrough, cfg.exploration_budget_one,
                    "semantic0", ["occupancy", "semantic0"], gt_walk)

    unshuffle = sampler.next_task()
    controller.task = unshuffle
    unshuffle.step(unshuffle.action_names().index("look_down"))
    tops1 = explore(unshuffle, cfg.exploration_budget_two,
                    "semantic1", ["semantic1"], gt_unshuffle,
                    initial_snapshot=True)

    def pack(tops):
        if not tops:
            return np.zeros((0, cfg.map_height, cfg.map_width,
                             taxonomy.NUM_CLASSES), np.float16)
        return np.stack(tops)

    def pack_cells(cells):
        if not cells:
            return np.zeros((0, 2), np.int32)
        return np.stack(cells)

    return dict(tops0=pack(tops0), cells0=pack_cells(cells_walk),
                tops1=pack(tops1),
                cells1=pack_cells(cells_unshuffle))


def small_scene_config(camera_size: int = 48, map_height: int = 80,
                       map_width: int = 80, map_depth: int = 24,
                       grid_resolution: float = 0.125,
                       step_size: int = 2, obstacle_padding: int = 2,
                       map_slice_start: int = 0,
                       map_slice_stop: int = 12) -> AgentConfig:
    """Default geometry: camera 48, 80x80x24 at 0.125 m.  Keep
    step_size x resolution at the 0.25 m move and obstacle_padding x
    resolution over the 0.2 m agent radius when scaling."""
    return AgentConfig(
        camera=CameraConfig(height=camera_size, width=camera_size),
        map_height=map_height, map_width=map_width,
        map_depth=map_depth, grid_resolution=grid_resolution,
        nav=NavConfig(step_size=step_size,
                      obstacle_padding=obstacle_padding,
                      map_slice_start=map_slice_start,
                      map_slice_stop=map_slice_stop,
                      graph_update_interval=5, max_goal_steps=60),
        match=MatchConfig(contour_padding=0, confidence_threshold=0.1,
                          distance_threshold=0.2, max_instances=8),
        exploration_budget_one=3, exploration_budget_two=2)


def build_parser() -> argparse.ArgumentParser:
    from mass_tpu_torch.agent.cli import add_device_flags

    p = argparse.ArgumentParser("search-policy dataset collector")
    p.add_argument("--logdir", type=str, required=True)
    p.add_argument("--start-task", type=int, default=0)
    p.add_argument("--total-tasks", type=int, default=80)
    p.add_argument("--camera-size", type=int, default=48)
    p.add_argument("--map-height", type=int, default=80)
    p.add_argument("--map-width", type=int, default=80)
    p.add_argument("--map-depth", type=int, default=24)
    p.add_argument("--grid-resolution", type=float, default=0.125)
    p.add_argument("--step-size", type=int, default=2)
    p.add_argument("--obstacle-padding", type=int, default=2)
    p.add_argument("--map-slice-start", type=int, default=0)
    p.add_argument("--map-slice-stop", type=int, default=12)
    p.add_argument("--max-steps", type=int, default=250)
    p.add_argument("--room-size", type=float, default=6.0,
                   help="room side in metres (match the evaluation "
                        "scenes' --room-size)")
    p.add_argument("--num-rooms", type=int, default=1,
                   help="interior-wall rooms per scene (match the "
                        "evaluation scenes' --num-rooms)")
    p.add_argument("--num-objects", type=int, default=2)
    p.add_argument("--num-misplaced", type=int, default=1)
    p.add_argument("--exploration-goals", type=int, default=None,
                   help="override the per-phase goal budgets (more "
                        "snapshots per scene)")
    p.add_argument("--seed", type=int, default=0)
    add_device_flags(p)
    return p


def main(argv=None):
    from mass_tpu_torch.agent.cli import resolve_device_flags
    from mass_tpu_torch.env.rearrange import GridWorldTaskSampler

    args = build_parser().parse_args(argv)
    device = resolve_device(resolve_device_flags(args))
    config = small_scene_config(
        args.camera_size, map_height=args.map_height,
        map_width=args.map_width, map_depth=args.map_depth,
        grid_resolution=args.grid_resolution, step_size=args.step_size,
        obstacle_padding=args.obstacle_padding,
        map_slice_start=args.map_slice_start,
        map_slice_stop=args.map_slice_stop)
    if args.exploration_goals:
        config = dataclasses.replace(
            config, exploration_budget_one=args.exploration_goals,
            exploration_budget_two=args.exploration_goals)
    os.makedirs(args.logdir, exist_ok=True)
    for task_id in range(args.start_task,
                         args.start_task + args.total_tasks):
        out = os.path.join(args.logdir, f"task-{task_id}.npz")
        if os.path.exists(out):
            continue
        sampler = GridWorldTaskSampler(
            [task_id], camera=config.camera, max_steps=args.max_steps,
            num_objects=args.num_objects,
            num_misplaced=args.num_misplaced, num_opened=0,
            room=(args.room_size, 2.5, args.room_size),
            num_rooms=args.num_rooms)
        rng = np.random.RandomState(args.seed + task_id)
        data = collect_task(sampler, config, rng, device)
        np.savez_compressed(out, **data)
        print(f"task {task_id}: {len(data['tops0'])}+"
              f"{len(data['tops1'])} snapshots, "
              f"{len(data['cells0'])} labels", flush=True)


if __name__ == "__main__":
    main()
