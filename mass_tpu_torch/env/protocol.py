"""The environment contract the framework runs against.

Everything above the simulator touches only this protocol — the shape
of the reference's AI2-THOR task objects (task.get_observations /
step / is_done / action_names / env.get_agent_location; reference:
mass/navigation_policy.py:75-171, rearrange.tasks.RearrangeTaskSampler)
— so the agent runs identically against the Unity-backed THOR gateway
(env/thor.py), the procedural grid world (env/gridworld.py), or a
recorded trajectory (env/replay.py).  Simulators are host-side and
sequential; keeping them behind this seam is what lets the device
pipeline batch and stay jitted.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Protocol, runtime_checkable


@dataclasses.dataclass
class AgentPose:
    """Agent location in simulator conventions (THOR: y is up, rotation
    clockwise degrees, horizon positive = looking down)."""

    x: float
    y: float
    z: float
    rotation_degrees: float
    horizon_degrees: float
    standing: bool = True

    def as_location_dict(self) -> Dict[str, Any]:
        return dict(x=self.x, y=self.y, z=self.z,
                    rotation=self.rotation_degrees,
                    horizon=self.horizon_degrees,
                    standing=self.standing)


@dataclasses.dataclass
class StepResult:
    action_success: bool
    info: Dict[str, Any] = dataclasses.field(default_factory=dict)


@runtime_checkable
class Task(Protocol):
    """One rearrangement phase (walkthrough or unshuffle)."""

    def get_observations(self) -> Dict[str, Any]:
        """Observation dict: ``rgb`` [h, w, 3] float 0-1, ``depth``
        [h, w, 1] float meters, ``semantic`` [h, w, 1] int class ids."""
        ...

    def step(self, action: int) -> StepResult:
        ...

    def is_done(self) -> bool:
        ...

    def action_names(self) -> List[str]:
        ...

    def agent_location(self) -> AgentPose:
        ...
