"""Command-line entry point for rearrangement episodes on the port
(port of ``mass_tpu.agent.cli``).

Takes ``mass_tpu.agent.cli``'s flags with the same names and defaults
and writes the same ``results/{id}.json``.  Flags whose code arrives in
a later slice of the port stop with an error naming that slice.  The
episode runs on ``--device`` (default ``cuda``); ``--fleet-size B``
above 1 runs the tasks B at a time in lockstep over shared fleet maps
(``parallel/evaluator.py``), each task with the rng seed ``--seed`` +
task.

    python -m mass_tpu_torch.agent.cli --backend gridworld \\
        --ground-truth-segmentation --ground-truth-disagreement \\
        --total-tasks 1 --logdir /tmp/run
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np

from mass_tpu_torch.agent.loop import RearrangementAgent
from mass_tpu_torch.agent.reliability import run_with_restart
from mass_tpu_torch.config import (AgentConfig, CameraConfig, MatchConfig,
                                   NavConfig)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("mass_tpu_torch rearrangement agent")
    p.add_argument("--logdir", type=str, default="./mass-tpu-logs")
    p.add_argument("--backend", type=str, default="gridworld",
                   choices=["gridworld", "thor"])
    p.add_argument("--device", type=str, default=None,
                   choices=["cuda", "cpu"],
                   help="where the maps live and the kernels run (default "
                        "cuda); with no GPU the run stops unless this is "
                        "cpu")
    p.add_argument("--platform", type=str, default=None, choices=["cpu"],
                   help="mass_tpu's spelling of --device cpu, accepted so "
                        "its command lines run unchanged; conflicts with "
                        "--device cuda")

    p.add_argument("--stage", type=str, default="train")
    p.add_argument("--start-task", type=int, default=0)
    p.add_argument("--every-tasks", type=int, default=1)
    p.add_argument("--total-tasks", type=int, default=50)
    p.add_argument("--resume", action="store_true",
                   help="skip tasks whose results/{id}.json already "
                        "exists in --logdir")

    # grid-world scene content
    p.add_argument("--num-objects", type=int, default=5)
    p.add_argument("--num-misplaced", type=int, default=2)
    p.add_argument("--num-opened", type=int, default=1)
    p.add_argument("--duplicate-class-pairs", type=int, default=0)
    p.add_argument("--room-size", type=float, default=6.0)
    p.add_argument("--num-rooms", type=int, default=1)

    p.add_argument("--ground-truth-segmentation", action="store_true")
    p.add_argument("--detector-checkpoint", type=str, default=None)
    p.add_argument("--detector-arch", type=str, default="maskrcnn",
                   choices=["maskrcnn", "unet"])
    p.add_argument("--detector-num-classes", type=int, default=None)
    p.add_argument("--ground-truth-disagreement", action="store_true")
    p.add_argument("--ground-truth-semantic-search", action="store_true")
    p.add_argument("--semantic-search-walkthrough", action="store_true")
    p.add_argument("--semantic-search-unshuffle", action="store_true")
    p.add_argument("--frontier-exploration", action="store_true")
    p.add_argument("--revisit-exploration", action="store_true")
    p.add_argument("--policy-inhibition-radius", type=float, default=0.0)
    p.add_argument("--use-feature-matching", action="store_true")
    p.add_argument("--record-found-objects", action="store_true")
    p.add_argument("--snapshot-maps", action="store_true")
    p.add_argument("--one-phase", action="store_true")
    p.add_argument("--reference-compat", action="store_true")

    p.add_argument("--exploration-budget-one", type=int, default=5)
    p.add_argument("--exploration-budget-two", type=int, default=5)
    p.add_argument("--max-steps", type=int, default=250,
                   help="per-phase step budget (gridworld backend)")
    p.add_argument("--detection-threshold", type=float, default=0.9)

    p.add_argument("--map-height", type=int, default=384)
    p.add_argument("--map-width", type=int, default=384)
    p.add_argument("--map-depth", type=int, default=96)
    p.add_argument("--grid-resolution", type=float, default=0.05)
    p.add_argument("--map-slice-start", type=int, default=20)
    p.add_argument("--map-slice-stop", type=int, default=48)
    p.add_argument("--vertical-fov", type=float, default=90.0)
    p.add_argument("--camera-size", type=int, default=224)
    p.add_argument("--map-precision", type=str, default="default",
                   choices=["default", "highest"],
                   help="ignored: mass_tpu's TPU matmul precision, "
                        "accepted so its command lines run unchanged; "
                        "the port splats in float32")

    p.add_argument("--obstacle-threshold", type=float, default=0.0)
    p.add_argument("--obstacle-padding", type=int, default=1)
    p.add_argument("--step-size", type=int, default=5)
    p.add_argument("--max-goal-steps", type=int, default=80)

    p.add_argument("--contour-padding", type=int, default=0)
    p.add_argument("--contour-threshold", type=float, default=0.0)
    p.add_argument("--confidence-threshold", type=float, default=0.0)
    p.add_argument("--distance-threshold", type=float, default=0.05)
    # parsed but unused, as in mass_tpu (the reference never reads it)
    p.add_argument("--deformation-threshold", type=float, default=0.0)

    p.add_argument("--position-noise-std", type=float, default=0.0)
    p.add_argument("--rotation-noise-std", type=float, default=0.0)

    p.add_argument("--policy-checkpoint", type=str, default=None)
    p.add_argument("--backbone-checkpoint", type=str, default=None)
    p.add_argument("--videos", action="store_true")
    p.add_argument("--fleet-size", type=int, default=1)
    p.add_argument("--shard-map", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    return p


def unported_flags(args) -> Optional[str]:
    """Why these flags cannot run on this slice of the port, or None."""
    checks = [
        (args.backend == "thor", "--backend thor", 3),
        (not args.ground_truth_segmentation,
         "learned segmentation (no --ground-truth-segmentation)", 3),
        (args.policy_checkpoint is not None, "--policy-checkpoint", 2),
        (args.frontier_exploration, "--frontier-exploration", 2),
        (args.revisit_exploration, "--revisit-exploration", 2),
        (args.use_feature_matching, "--use-feature-matching", 3),
        (args.one_phase, "--one-phase", 2),
        (args.shard_map > 1, "--shard-map", 4),
        (args.videos, "--videos", 3),
        (args.snapshot_maps, "--snapshot-maps", 3),
    ]
    for hit, flag, slice_no in checks:
        if hit:
            return (f"{flag} is not ported yet: it arrives with slice "
                    f"{slice_no} of mass_tpu_torch (ROADMAP.md); run "
                    f"mass_tpu.agent.cli for it")
    return None


def config_from_args(args) -> AgentConfig:
    """The episode configuration the flags name.  ``--reference-compat``
    pins the reference's rules: a separate occupancy map to navigate
    on, the reference controller, and no per-goal step cap."""
    if args.reference_compat:
        args.max_goal_steps = 0
    return AgentConfig(
        navigate_on_semantic=not args.reference_compat,
        camera=CameraConfig(height=args.camera_size,
                            width=args.camera_size,
                            vertical_fov_degrees=args.vertical_fov),
        map_height=args.map_height, map_width=args.map_width,
        map_depth=args.map_depth, grid_resolution=args.grid_resolution,
        nav=NavConfig(step_size=args.step_size,
                      obstacle_padding=args.obstacle_padding,
                      obstacle_threshold=args.obstacle_threshold,
                      map_slice_start=args.map_slice_start,
                      map_slice_stop=args.map_slice_stop,
                      position_noise_std=args.position_noise_std,
                      rotation_noise_std=args.rotation_noise_std,
                      max_goal_steps=args.max_goal_steps,
                      reference_compat=args.reference_compat),
        match=MatchConfig(
            confidence_threshold=args.confidence_threshold,
            contour_padding=args.contour_padding,
            contour_threshold=args.contour_threshold,
            distance_threshold=args.distance_threshold,
            deformation_threshold=args.deformation_threshold),
        exploration_budget_one=args.exploration_budget_one,
        exploration_budget_two=args.exploration_budget_two,
        detection_threshold=args.detection_threshold,
        ground_truth_segmentation=args.ground_truth_segmentation,
        ground_truth_disagreement=args.ground_truth_disagreement,
        ground_truth_semantic_search=args.ground_truth_semantic_search,
        semantic_search_walkthrough=args.semantic_search_walkthrough,
        semantic_search_unshuffle=args.semantic_search_unshuffle,
        policy_inhibition_radius=args.policy_inhibition_radius,
        record_found_objects=args.record_found_objects,
        logdir=args.logdir, stage=args.stage,
        start_task=args.start_task, every_tasks=args.every_tasks,
        total_tasks=args.total_tasks, resume=args.resume)


def make_sampler(args, config: AgentConfig, seeds=None):
    """The grid-world task sampler over ``seeds`` (default: the task
    range the flags name)."""
    from mass_tpu_torch.env.rearrange import GridWorldTaskSampler
    if seeds is None:
        seeds = range(args.start_task, args.start_task
                      + args.total_tasks * args.every_tasks + 1)
    return GridWorldTaskSampler(
        list(seeds), camera=config.camera, max_steps=args.max_steps,
        num_objects=args.num_objects, num_misplaced=args.num_misplaced,
        num_opened=args.num_opened,
        duplicate_class_pairs=args.duplicate_class_pairs,
        room=(args.room_size, 2.5, args.room_size),
        num_rooms=args.num_rooms)


def run_fleet(args, config: AgentConfig, device: str):
    """Lockstep fleet evaluation over the task range: batches of
    ``--fleet-size`` episodes, each from a sampler of its own task's seed
    with the rng seed ``--seed`` + task, so an episode equals the
    sequential agent's on that sampler and seed."""
    from mass_tpu_torch.agent import metrics as M
    from mass_tpu_torch.parallel.evaluator import FleetEvaluator

    tasks = [args.start_task + k * args.every_tasks
             for k in range(args.total_tasks)]

    def run_batch(batch):
        evaluator = FleetEvaluator(
            config, [make_sampler(args, config, [s]) for s in batch],
            seeds=[args.seed + s for s in batch], device=device)
        results = evaluator.run()
        for task, ep, result in zip(batch, evaluator.episodes, results):
            if not config.logdir:
                continue
            M.write_task_metrics(config.logdir, task, result)
            if config.record_found_objects:
                for phase, track in (("walkthrough", ep.walk_track),
                                     ("unshuffle", ep.unshuffle_track)):
                    M.write_found_objects(
                        config.logdir, task, phase, track,
                        ep.found_positions, ep.found_types)
        return results

    results = []
    for lo in range(0, len(tasks), args.fleet_size):
        # one batch's fleet buffers are freed before the next is made
        results.extend(run_batch(tasks[lo:lo + args.fleet_size]))
    return results


def resolve_device_flags(args) -> str:
    """The one device the ``--device`` / ``--platform`` pair names."""
    if args.platform is not None and args.device not in (None,
                                                         args.platform):
        raise SystemExit(f"--platform {args.platform} conflicts with "
                         f"--device {args.device}")
    return args.device or args.platform or "cuda"


def main(argv=None):
    args = build_parser().parse_args(argv)
    reason = unported_flags(args)
    if reason is not None:
        raise SystemExit(reason)
    device = resolve_device_flags(args)
    os.makedirs(args.logdir, exist_ok=True)
    name = (f"{args.start_task}-"
            f"{args.start_task + args.total_tasks * args.every_tasks}")
    with open(os.path.join(args.logdir, f"params-{name}.json"),
              "w") as f:
        json.dump(vars(args), f, indent=4)

    config = config_from_args(args)

    def run():
        if args.fleet_size > 1:
            return run_fleet(args, config, device)
        agent = RearrangementAgent(
            config, make_sampler(args, config),
            rng=np.random.RandomState(args.seed), device=device)
        return agent.run()

    metrics = run_with_restart(run)
    if metrics:
        keys = ("unshuffle/prop_fixed_strict", "unshuffle/success")
        means = {k: float(np.mean([m[k] for m in metrics]))
                 for k in keys}
        print(json.dumps(means, indent=2))
    return metrics


if __name__ == "__main__":
    main()
