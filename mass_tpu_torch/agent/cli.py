"""Command-line entry point for rearrangement episodes on the port
(port of ``mass_tpu.agent.cli``).

Takes ``mass_tpu.agent.cli``'s flags with the same names and defaults
and writes the same ``results/{id}.json``.  ``--shard-map N`` row-shards
every map over N devices: N cards on CUDA, N slabs on the CPU with
``--device cpu``.  The episode runs on ``--device`` (default ``cuda``);
``--fleet-size B`` above 1 runs the tasks B at a time in lockstep over
shared fleet maps (``parallel/evaluator.py``), each task with the rng
seed ``--seed`` + task.  ``--backend thor`` runs the AI2-THOR
rearrangement stack through ``env/thor.py`` (where it is installed),
a fleet over B persistent THOR samplers.  ``--videos`` writes
``videos/{id}.mp4`` per sequential episode (cv2, codec mp4v, 10 fps);
``--snapshot-maps`` writes ``results/maps-{id}.npz``, sequential and in
the fleet.  ``--use-feature-matching`` reads the stage-1 ResNet from
``--backbone-checkpoint <.pth>`` (``mass_tpu_torch/checkpoints/
backbone-rand.pth`` is the JAX package's ``init_backbone()``).  Without
``--ground-truth-segmentation`` the semantic image comes from the
learned detector of ``--detector-checkpoint <.pth>``: a detectron2 or
torchvision Mask R-CNN, or with ``--detector-arch unet`` the port's UNet
(``python -m tests.torch_checkpoints`` exports the JAX package's orbax
detectors and writes random Mask R-CNN weights).

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


def add_device_flags(p: argparse.ArgumentParser) -> None:
    """``--device`` and its alias ``--platform cpu`` (the JAX package's
    spelling), shared by the port's entry points."""
    p.add_argument("--device", type=str, default=None,
                   choices=["cuda", "cpu"],
                   help="where the maps live and the kernels run (default "
                        "cuda); with no GPU the run stops unless this is "
                        "cpu")
    p.add_argument("--platform", type=str, default=None, choices=["cpu"],
                   help="mass_tpu's spelling of --device cpu, accepted so "
                        "its command lines run unchanged; conflicts with "
                        "--device cuda")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("mass_tpu_torch rearrangement agent")
    p.add_argument("--logdir", type=str, default="./mass-tpu-logs")
    p.add_argument("--backend", type=str, default="gridworld",
                   choices=["gridworld", "thor"])
    add_device_flags(p)

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
    p.add_argument("--snapshot-maps", action="store_true",
                   help="write each episode's final voxel maps "
                        "(results/maps-{id}.npz: float16 grids and their "
                        "bins), sequential and in the fleet")
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
    p.add_argument("--videos", action="store_true",
                   help="write videos/{id}.mp4 per sequential episode "
                        "(cv2, codec mp4v, 10 fps); fleets write none, as "
                        "in mass_tpu")
    p.add_argument("--fleet-size", type=int, default=1)
    p.add_argument("--shard-map", type=int, default=0,
                   help="row-shard every voxel map over N devices "
                        "(parallel/sharding.py): N cards on cuda, N slabs "
                        "with --device cpu; num_voxels must divide by N")
    p.add_argument("--seed", type=int, default=0)
    return p


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
        frontier_exploration=args.frontier_exploration,
        revisit_exploration=args.revisit_exploration,
        policy_inhibition_radius=args.policy_inhibition_radius,
        use_feature_matching=args.use_feature_matching,
        record_found_objects=args.record_found_objects,
        snapshot_maps=args.snapshot_maps,
        one_phase=args.one_phase, shard_map=args.shard_map,
        logdir=args.logdir, stage=args.stage,
        start_task=args.start_task, every_tasks=args.every_tasks,
        total_tasks=args.total_tasks, resume=args.resume)


def thor_sampler(args):
    """One THOR rearrangement sampler of the flags' stage and camera
    (ground-truth frames: a learned sensor replaces ``semantic`` after
    it)."""
    from mass_tpu_torch.env.thor import ThorTaskSampler
    return ThorTaskSampler(
        stage=args.stage, ground_truth=True,
        detection_threshold=args.detection_threshold,
        screen_size=args.camera_size, one_phase=args.one_phase)


def make_sampler(args, config: AgentConfig, seeds=None, sensor=None):
    """The task sampler of ``--backend``: THOR's, or the grid world's over
    ``seeds`` (default: the task range the flags name); its tasks'
    ``semantic`` replaced by ``sensor``'s when one is given (the learned
    segmentation of a sequential run)."""
    if args.backend == "thor":
        sampler = thor_sampler(args)
    else:
        from mass_tpu_torch.env.rearrange import GridWorldTaskSampler
        if seeds is None:
            seeds = range(args.start_task, args.start_task
                          + args.total_tasks * args.every_tasks + 1)
        sampler = GridWorldTaskSampler(
            list(seeds), camera=config.camera, max_steps=args.max_steps,
            one_phase=args.one_phase,
            num_objects=args.num_objects, num_misplaced=args.num_misplaced,
            num_opened=args.num_opened,
            duplicate_class_pairs=args.duplicate_class_pairs,
            room=(args.room_size, 2.5, args.room_size),
            num_rooms=args.num_rooms)
    if sensor is not None:
        from mass_tpu_torch.perception.segmentation import \
            SegmentationSampler
        sampler = SegmentationSampler(sampler, sensor)
    return sampler


def _export_of(path: str) -> str:
    """Where the port ships the ``.pth`` export of an orbax tree."""
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "checkpoints", os.path.basename(os.path.normpath(path)) + ".pth")


def load_policy(path: Optional[str], device):
    """The search policy of ``--policy-checkpoint``: a reference-layout
    ``.pth`` state dict.  The JAX package's orbax trees are not read
    here; each shipped tree has its export under
    ``mass_tpu_torch/checkpoints/``."""
    if path is None:
        return None
    if not path.endswith(".pth"):
        raise SystemExit(
            f"--policy-checkpoint {path} is not a .pth state dict: the port "
            f"reads the reference policy.pth layout, not orbax trees; pass "
            f"the exported {_export_of(path)}")
    from mass_tpu_torch.search.policy import load_reference_policy
    return load_reference_policy(path, device)


def load_backbone(args, device):
    """The stage-1 ResNet of ``--use-feature-matching``: a
    torchvision-named ``.pth`` state dict from ``--backbone-checkpoint``
    (None without the flag).  The JAX package downloads torchvision's
    weights when no checkpoint is given; the port reads only files."""
    if not args.use_feature_matching:
        return None
    path = args.backbone_checkpoint
    if path is None:
        raise SystemExit(
            "--use-feature-matching needs ResNet stage-1 weights: pass "
            "--backbone-checkpoint <.pth> (a torchvision resnet50 state "
            "dict, or mass_tpu_torch/checkpoints/backbone-rand.pth, the "
            "JAX package's init_backbone())")
    if not path.endswith(".pth"):
        raise SystemExit(
            f"--backbone-checkpoint {path} is not a .pth state dict: the "
            f"port reads torchvision-named state dicts, not orbax trees; "
            f"pass the exported {_export_of(path)}")
    from mass_tpu_torch.perception.resnet import load_backbone_checkpoint
    return load_backbone_checkpoint(path, device)[0]


def load_segmentation_sensor(args, device):
    """The learned-segmentation sensor when ground truth is off (None
    with ``--ground-truth-segmentation``; reference: the Mask R-CNN
    branch of segmentation_config.py:207-218): a Mask R-CNN ``.pth``
    (detectron2 or torchvision, the class count read from the file) with
    mask fusion at ``--detection-threshold``, or under ``--detector-arch
    unet`` the port's UNet state dict.  The JAX package's orbax trees are
    not read here; the message names their export."""
    if args.ground_truth_segmentation:
        return None
    path = args.detector_checkpoint
    if path is None:
        raise SystemExit(
            "without --ground-truth-segmentation a learned detector is "
            "required: pass --detector-checkpoint <.pth> (a detectron2 or "
            "torchvision Mask R-CNN, or a UNet with --detector-arch unet; "
            "the reference's equivalent is mass/thor/model_final.pth)")
    if not path.endswith(".pth"):
        raise SystemExit(
            f"--detector-checkpoint {path} is not a .pth: the port reads "
            f"torch state dicts, not orbax trees; export it with python -m "
            f"tests.torch_checkpoints --detector {path} --arch "
            f"{args.detector_arch} (writes {_export_of(path)})")
    if args.detector_arch == "unet":
        from mass_tpu_torch.perception.detector import (
            load_segmenter, make_segmentation_sensor)
        return make_segmentation_sensor(load_segmenter(path, device))
    from mass_tpu_torch.perception.maskrcnn import load_detector
    from mass_tpu_torch.perception.segmentation import DetectorSegmentation
    detector, _ = load_detector(path, args.camera_size,
                                args.detector_num_classes, device)
    return DetectorSegmentation(detector, args.detection_threshold)


def make_video_factory(args):
    """``task_id -> writer`` of ``videos/{task_id}.mp4`` under
    ``--logdir`` with ``--videos``, else None."""
    if not args.videos:
        return None

    def factory(task_id: int):
        path = os.path.join(args.logdir, "videos", f"{task_id}.mp4")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        return VideoWriter(path)
    return factory


class VideoWriter:
    """An mp4 through cv2 (codec mp4v, 10 fps; cv2 rather than imageio,
    which GPU hosts may lack), opened at the first frame, whose size it
    takes.
    Frames are RGB uint8; cv2 writes BGR.  A writer that does not open,
    or a frame of another size (which cv2 would drop without a word),
    stops the run."""

    CODEC = "mp4v"
    FPS = 10

    def __init__(self, path: str):
        self.path = path
        self.frames = 0
        self._writer = None
        self._size = None

    def write(self, frame: np.ndarray) -> None:
        import cv2
        size = (frame.shape[1], frame.shape[0])
        if self._writer is None:
            self._writer = cv2.VideoWriter(
                self.path, cv2.VideoWriter_fourcc(*self.CODEC), self.FPS,
                size)
            if not self._writer.isOpened():
                raise RuntimeError(f"cv2.VideoWriter could not open "
                                   f"{self.path} with codec {self.CODEC}")
            self._size = size
        if size != self._size:
            raise ValueError(f"{self.path}: a {size} frame in a video of "
                             f"{self._size} frames")
        self._writer.write(np.ascontiguousarray(frame[..., ::-1]))
        self.frames += 1

    def close(self) -> None:
        if self._writer is not None:
            self._writer.release()


def run_fleet(args, config: AgentConfig, device: str, policy=None,
              backbone=None, sensor=None):
    """Lockstep fleet evaluation over the task range: batches of
    ``--fleet-size`` episodes with the rng seed ``--seed`` + task, so an
    episode equals the sequential agent's on that sampler and seed.  The
    grid world gives each episode a sampler of its own task's seed; THOR
    keeps ``--fleet-size`` persistent samplers (one simulator each) and
    skips each slot's task-spec iterator ahead to its next task between
    batches.  Results carry ``task_id``, the task's index.  A learned
    ``sensor`` runs inside the evaluator, on the whole fleet's frames at
    once (the samplers stay ground truth)."""
    from mass_tpu_torch.agent import metrics as M
    from mass_tpu_torch.parallel.evaluator import FleetEvaluator

    tasks = [args.start_task + k * args.every_tasks
             for k in range(args.total_tasks)]

    if args.backend == "thor":
        slots = [thor_sampler(args)
                 for _ in range(min(args.fleet_size, max(len(tasks), 1)))]
        consumed = [0] * len(slots)         # task specs each slot has used

        def samplers_of(batch):
            for i, task in enumerate(batch):
                while consumed[i] < task:   # skip to this task
                    slots[i].skip_task()
                    consumed[i] += 1
                consumed[i] += 1            # the episode uses it
            return slots[:len(batch)]
    else:
        def samplers_of(batch):
            return [make_sampler(args, config, [s]) for s in batch]

    def run_batch(batch):
        evaluator = FleetEvaluator(
            config, samplers_of(batch),
            seeds=[args.seed + s for s in batch], policy=policy,
            sensor=sensor, feature_backbone=backbone, device=device)
        results = evaluator.run()
        for task, ep, result in zip(batch, evaluator.episodes, results):
            result["task_id"] = task
            if not config.logdir:
                continue
            M.write_task_metrics(config.logdir, task, result)
            if config.record_found_objects:
                tracks = [("unshuffle", ep.unshuffle_track)]
                if not config.one_phase:    # one-phase: no walkthrough
                    tracks.insert(0, ("walkthrough", ep.walk_track))
                for phase, track in tracks:
                    M.write_found_objects(config.logdir, task, phase, track,
                                          ep.found_positions,
                                          ep.found_types)
            if config.snapshot_maps:
                fleet = evaluator.fleet
                M.write_map_snapshots(
                    config.logdir, task,
                    {n: fleet.view(n, ep.index) for n in fleet.buffers})
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
    device = resolve_device_flags(args)
    backbone = load_backbone(args, device)
    sensor = load_segmentation_sensor(args, device)
    os.makedirs(args.logdir, exist_ok=True)
    name = (f"{args.start_task}-"
            f"{args.start_task + args.total_tasks * args.every_tasks}")
    with open(os.path.join(args.logdir, f"params-{name}.json"),
              "w") as f:
        json.dump(vars(args), f, indent=4)

    config = config_from_args(args)
    policy = load_policy(args.policy_checkpoint, device)

    def run():
        if args.fleet_size > 1:
            return run_fleet(args, config, device, policy, backbone, sensor)
        agent = RearrangementAgent(
            config, make_sampler(args, config, sensor=sensor),
            rng=np.random.RandomState(args.seed), device=device,
            policy=policy, feature_backbone=backbone,
            video_writer_factory=make_video_factory(args))
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
