"""THOR task-sampler construction (port of
``mass_tpu.env._thor_config``; the heavy dependencies are imported only
when a sampler is built).

Builds a two-phase ``RearrangeTaskSampler`` with RGB + depth sensors
under CloudRendering, the way the reference's experiment config does
(reference: mass/thor/segmentation_config.py:372-481 —
``stagewise_task_sampler_args`` + ``make_sampler_fn`` with
force_cache_reset, epochs=1, only_one_unshuffle_per_walkthrough).
Segmentation is produced by the framework's perception layer from the
simulator's GT frames or a detector, not by a sensor subclass.
"""

from __future__ import annotations

from typing import Any


def build_task_sampler(stage: str = "train", process_ind: int = 0,
                       total_processes: int = 1,
                       ground_truth: bool = True,
                       detection_threshold: float = 0.9,
                       screen_size: int = 224,
                       one_phase: bool = False,
                       **extra: Any):
    from ai2thor.platform import CloudRendering
    from baseline_configs.rearrange_base import (
        RearrangeBaseExperimentConfig as Base)
    from rearrange.sensors import (DepthRearrangeSensor,
                                   RGBRearrangeSensor)
    from rearrange.tasks import RearrangeTaskSampler

    sensors = [
        RGBRearrangeSensor(
            height=screen_size, width=screen_size,
            use_resnet_normalization=False, uuid="rgb"),
        DepthRearrangeSensor(
            height=screen_size, width=screen_size, uuid="depth"),
    ]

    stage_seeds = Base.stagewise_task_sampler_args(
        stage=stage, process_ind=process_ind,
        total_processes=total_processes, devices=[0])

    thor_controller_kwargs = {
        **Base.THOR_CONTROLLER_KWARGS,
        "platform": CloudRendering,
        "renderDepthImage": True,
        "renderSemanticSegmentation": ground_truth,
        "renderInstanceSegmentation": not ground_truth,
    }

    return RearrangeTaskSampler.from_fixed_dataset(
        # one-phase = unshuffle-only tasks (reference:
        # OnePhaseSegmentationConfig, segmentation_config.py:484-598)
        run_walkthrough_phase=not one_phase,
        run_unshuffle_phase=True,
        stage=stage,
        scenes_to_allowed_rearrange_inds=stage_seeds.get(
            "scenes_to_allowed_rearrange_inds"),
        rearrange_env_kwargs=dict(
            force_cache_reset=True,
            **Base.REARRANGE_ENV_KWARGS,
            controller_kwargs=thor_controller_kwargs),
        seed=stage_seeds.get("seed"),
        sensors=sensors,
        max_steps=Base.MAX_STEPS,
        discrete_actions=Base.actions(),
        require_done_action=Base.REQUIRE_DONE_ACTION,
        force_axis_aligned_start=Base.FORCE_AXIS_ALIGNED_START,
        epochs=1,
        only_one_unshuffle_per_walkthrough=True,
        **extra)
