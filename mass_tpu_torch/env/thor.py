"""AI2-THOR rearrangement gateway (port of ``mass_tpu.env.thor``;
host-side, import-gated).

Adapts the external allenai rearrangement stack (``ai2thor``,
``allenact``, ``rearrange`` — the reference's L0, SURVEY.md §1) to the
framework's Task protocol.  The simulator stays a sequential host
process exactly as in the reference (reference:
mass/thor/segmentation_config.py:372-481 builds the task sampler;
mass/navigation_policy.py wraps the task); everything device-side is
unchanged between THOR and the procedural grid world.

The THOR packages (``ai2thor``, ``rearrange``, ``baseline_configs``)
are imported only when a sampler is built, so the module imports on any
host; ``python -m mass_tpu_torch.agent.cli --backend thor`` runs it where
they are installed.  Ground-truth frames arrive as colour images and are
colour-matched to classes on the host
(``perception/segmentation.GroundTruthSegmentation``).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from mass_tpu_torch.env.protocol import AgentPose, StepResult
from mass_tpu_torch.perception.segmentation import GroundTruthSegmentation


def thor_available() -> bool:
    try:  # noqa: SIM105
        import ai2thor  # noqa: F401
        import rearrange  # noqa: F401
        return True
    except ImportError:
        return False


class ThorTask:
    """Task-protocol adapter over one walkthrough/unshuffle THOR task.

    ``one_phase`` tasks additionally surface the GOAL world's render
    from the same pose as ``goal_rgb`` / ``goal_depth`` /
    ``goal_semantic`` — THOR's one-phase task steps the walkthrough env
    in lockstep, which is what the reference's dual Unshuffled*/
    SemanticRearrange sensors read (reference:
    mass/thor/segmentation_config.py:484-598, uuids "semantic" /
    "unshuffled_semantic"); here the goal frames come straight off
    ``walkthrough_env.last_event`` so the grid-world one-phase
    observation contract (env/rearrange.Phase) is matched exactly."""

    def __init__(self, task, segmentation=None, one_phase: bool = False):
        self._task = task
        self._segmentation = segmentation or GroundTruthSegmentation()
        self._one_phase = one_phase
        self.env = task.env  # exposes .poses / .are_poses_equal

    def get_observations(self) -> Dict[str, Any]:
        obs = self._task.get_observations()
        out = dict(rgb=np.asarray(obs["rgb"], np.float32),
                   depth=np.asarray(obs["depth"], np.float32))
        if "semantic" in obs:
            out["semantic"] = np.asarray(obs["semantic"], np.int32)
        else:
            event = self._active_env().last_event
            out["semantic_colors"] = np.asarray(
                event.semantic_segmentation_frame)
            out["semantic"] = self._segmentation(out)
        if self._one_phase:
            wenv = getattr(self._task, "walkthrough_env", None)
            if wenv is not None:
                ev = wenv.last_event
                out["goal_rgb"] = (np.asarray(ev.frame, np.float32)
                                   / 255.0)
                out["goal_depth"] = np.asarray(
                    ev.depth_frame, np.float32)[..., None]
                goal = dict(rgb=out["goal_rgb"],
                            semantic_colors=np.asarray(
                                ev.semantic_segmentation_frame))
                out["goal_semantic"] = self._segmentation(goal)
        return out

    def _active_env(self):
        task = self._task
        if hasattr(task, "walkthrough_env") and \
                type(task).__name__ == "WalkthroughTask":
            return task.walkthrough_env
        return getattr(task, "unshuffle_env",
                       getattr(task, "walkthrough_env", task.env))

    def step(self, action: int) -> StepResult:
        result = self._task.step(action)
        return StepResult(
            action_success=bool(result.info.get("action_success", True)),
            info=dict(result.info))

    def is_done(self) -> bool:
        return self._task.is_done()

    def action_names(self) -> List[str]:
        return list(self._task.action_names())

    def agent_location(self) -> AgentPose:
        loc = self._task.env.get_agent_location()
        return AgentPose(
            x=float(loc["x"]), y=float(loc["y"]), z=float(loc["z"]),
            rotation_degrees=float(loc["rotation"]),
            horizon_degrees=float(loc["horizon"]),
            standing=bool(loc.get("standing", True)))

    def metrics(self) -> Dict[str, Any]:
        return self._task.metrics()


class ThorTaskSampler:
    """Framework-sampler facade over ``RearrangeTaskSampler``.

    Built from the same stagewise arguments the reference uses
    (reference: agent.py:132-143).  Requires the rearrangement packages
    and a display/CloudRendering-capable host.
    """

    def __init__(self, stage: str = "train", detection_threshold: float
                 = 0.9, ground_truth: bool = True,
                 segmentation=None, **sampler_kwargs):
        if not thor_available():
            raise ImportError(
                "ai2thor / rearrange packages are not installed; use "
                "the grid-world sampler (mass_tpu_torch.env.rearrange) or "
                "install the THOR rearrangement stack")
        from mass_tpu_torch.env._thor_config import build_task_sampler
        self._sampler = build_task_sampler(
            stage=stage, ground_truth=ground_truth,
            detection_threshold=detection_threshold, **sampler_kwargs)
        self._segmentation = segmentation
        self._one_phase = bool(sampler_kwargs.get("one_phase", False))

    def __len__(self):
        return self._sampler.length

    def next_task(self) -> ThorTask:
        return ThorTask(self._sampler.next_task(), self._segmentation,
                        one_phase=self._one_phase)

    def skip_task(self) -> None:
        next(self._sampler.task_spec_iterator)

    def reset(self) -> None:
        self._sampler.reset()
