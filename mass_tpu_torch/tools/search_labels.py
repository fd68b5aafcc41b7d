"""Dump semantic-search training labels: ground-truth goal positions in
map cells (port of ``mass_tpu.tools.search_labels``).

Per task, the map-frame cells of the misplaced objects' walkthrough and
unshuffle positions, written as ``walkthrough-labels-{id}.npy`` and
``unshuffle-labels-{id}.npy`` (int32 ``[K, 3]``, the JAX package's
files).  Only the grid's bin edges are built, on ``--device`` (default
``cuda``): a full 384x384x96x54 map would be 3 GB a task for nothing.

    python -m mass_tpu_torch.tools.search_labels --total-tasks 20 \\
        --logdir /tmp/labels [--backend thor]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from mass_tpu_torch import resolve_device
from mass_tpu_torch.agent import oracle
from mass_tpu_torch.config import CameraConfig, MapGeometry
from mass_tpu_torch.core.voxelmap import _bins, world_to_cells


def dump_labels(sampler, geometry: MapGeometry, logdir: str,
                start_task: int, total_tasks: int, device=None) -> int:
    """Write the label files of ``total_tasks`` tasks from ``sampler``;
    returns the number of tasks that had a misplaced object."""
    device = resolve_device(device)
    os.makedirs(logdir, exist_ok=True)
    written = 0
    for task_id in range(start_task, start_task + total_tasks):
        walkthrough = sampler.next_task()
        unshuffle = sampler.next_task()
        loc = walkthrough.agent_location()
        bins = _bins((loc.x, loc.z, loc.y), geometry, device)

        def cell(world):
            coords = torch.as_tensor(np.asarray(world)).to(device,
                                                            torch.float32)
            return world_to_cells(bins, coords).cpu().numpy().astype(
                np.int32)

        walk_cells, unshuffle_cells = [], []
        for current, target in oracle.scene_difference_positions(
                unshuffle):
            walk_cells.append(cell(target))
            unshuffle_cells.append(cell(current))
        if walk_cells:
            np.save(os.path.join(
                logdir, f"walkthrough-labels-{task_id}.npy"),
                np.stack(walk_cells))
            np.save(os.path.join(
                logdir, f"unshuffle-labels-{task_id}.npy"),
                np.stack(unshuffle_cells))
            written += 1
    return written


def main(argv=None):
    from mass_tpu_torch.agent.cli import (add_device_flags,
                                          resolve_device_flags)

    p = argparse.ArgumentParser("search-label dumper")
    p.add_argument("--logdir", type=str, required=True)
    p.add_argument("--start-task", type=int, default=0)
    p.add_argument("--total-tasks", type=int, default=20)
    p.add_argument("--backend", type=str, default="gridworld",
                   choices=["gridworld", "thor"])
    p.add_argument("--map-height", type=int, default=384)
    p.add_argument("--map-width", type=int, default=384)
    p.add_argument("--map-depth", type=int, default=96)
    p.add_argument("--grid-resolution", type=float, default=0.05)
    p.add_argument("--camera-size", type=int, default=224)
    add_device_flags(p)
    args = p.parse_args(argv)

    if args.backend == "thor":
        from mass_tpu_torch.env.thor import ThorTaskSampler
        sampler = ThorTaskSampler(screen_size=args.camera_size)
    else:
        from mass_tpu_torch.env.rearrange import GridWorldTaskSampler
        sampler = GridWorldTaskSampler(
            list(range(args.start_task,
                       args.start_task + args.total_tasks)),
            camera=CameraConfig(height=args.camera_size,
                                width=args.camera_size))
    geometry = MapGeometry(args.map_height, args.map_width, args.map_depth,
                           grid_resolution=args.grid_resolution)
    n = dump_labels(sampler, geometry, args.logdir, args.start_task,
                    args.total_tasks, resolve_device_flags(args))
    print(f"wrote labels for {n} tasks to {args.logdir}")


if __name__ == "__main__":
    main()
