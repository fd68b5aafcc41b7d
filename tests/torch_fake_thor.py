"""Fakes of the AI2-THOR rearrangement stack for the port (no JAX).

``ai2thor``, ``rearrange`` and ``baseline_configs`` are installed nowhere
here, so ``mass_tpu_torch.env.thor`` is driven against stand-ins of
exactly the surface it touches (the ``RearrangeTaskSampler``
construction arguments, sensor uuids, observations, steps and poses),
as ``tests/test_thor_contract.py`` and ``tests/test_thor_fleet.py`` do
for the JAX package:

  * ``ContractSampler`` yields ``ContractTask``: 4x4 frames, a fixed
    pose, colour-coded ground truth;
  * ``GridBackedSampler`` runs real grid-world episodes
    (``mass_tpu_torch.env.rearrange``) behind THOR's surface: ground
    truth arrives as a class-colour ``semantic_segmentation_frame``,
    poses as ``get_agent_location()`` dicts, steps as
    ``info["action_success"]``, so a ``--backend thor`` run must score
    as the ``--backend gridworld`` run of the same scenes.

``installed(sampler_cls)`` puts the fake modules into ``sys.modules``
for the duration of a ``with`` block.  ``chip_smoke.py`` imports this
module, so it imports nothing of JAX or ``mass_tpu``.
"""

from __future__ import annotations

import contextlib
import sys
import types

import numpy as np

from mass_tpu_torch import taxonomy
from mass_tpu_torch.config import CameraConfig
from mass_tpu_torch.env.rearrange import GridWorldTaskSampler

# scene content of every grid-backed task spec (the CLI's grid-world
# scene flags do not reach the THOR backend)
SCENE_KW = dict(num_objects=2, num_misplaced=1, num_opened=0)


# ------------------------------------------------------------- contract


class ContractEnv:
    def __init__(self):
        self.poses = ([], [], [])
        self.last_event = types.SimpleNamespace(
            semantic_segmentation_frame=self.frame())

    @staticmethod
    def frame():
        colors = taxonomy.class_colors_array(normalized=False).astype(
            np.uint8)
        frame = np.zeros((4, 4, 3), np.uint8)
        frame[0, 0] = colors[7]
        frame[1, 1] = colors[12]
        frame[2, 2] = (9, 9, 9)      # unknown color -> class 0
        return frame

    def get_agent_location(self):
        return dict(x=1.5, y=0.9, z=-2.0, rotation=90.0, horizon=30.0,
                    standing=False)

    def are_poses_equal(self, a, b):
        return True


class ContractTask:
    def __init__(self, with_semantic=False):
        self.env = ContractEnv()
        self._with_semantic = with_semantic
        self.stepped = []

    def get_observations(self):
        obs = {"rgb": np.zeros((4, 4, 3), np.float32),
               "depth": np.ones((4, 4, 1), np.float32)}
        if self._with_semantic:
            obs["semantic"] = np.full((4, 4, 1), 3, np.int32)
        return obs

    def step(self, action):
        self.stepped.append(action)
        return types.SimpleNamespace(info={"action_success": False,
                                           "extra": 1})

    def is_done(self):
        return False

    def action_names(self):
        return ["done", "move_ahead"]

    def metrics(self):
        return {"unshuffle/success": 0.0}


class ContractSampler:
    captured = None

    def __init__(self, **kwargs):
        ContractSampler.captured = kwargs
        self.length = 4
        self.task_spec_iterator = iter(range(10))
        self.reset_calls = 0

    @classmethod
    def from_fixed_dataset(cls, **kwargs):
        return cls(**kwargs)

    def next_task(self):
        return ContractTask()

    def reset(self):
        self.reset_calls += 1


# ---------------------------------------------------------- grid-backed


class GridEnv:
    """THOR's external env surface over one grid-world episode phase."""

    def __init__(self, phase):
        self._phase = phase

    @property
    def poses(self):
        return self._phase.env.poses

    def are_poses_equal(self, a, b):
        return self._phase.env.are_poses_equal(a, b)

    def get_agent_location(self):
        return self._phase.env.get_agent_location()

    @property
    def last_event(self):
        # the ground-truth frame as THOR renders it: class colours
        sem = self._phase.get_observations()["semantic"][..., 0]
        colors = taxonomy.class_colors_array(normalized=False)
        return types.SimpleNamespace(
            semantic_segmentation_frame=colors[sem].astype(np.uint8))


class GridTask:
    """What ``rearrange.tasks`` yields: THOR's external task surface."""

    def __init__(self, phase):
        self._phase = phase
        self.env = GridEnv(phase)

    def get_observations(self):
        o = self._phase.get_observations()
        return {"rgb": o["rgb"], "depth": o["depth"]}

    def step(self, action):
        r = self._phase.step(action)
        return types.SimpleNamespace(
            info={"action_success": r.action_success})

    def is_done(self):
        return self._phase.is_done()

    def action_names(self):
        return self._phase.action_names()

    def metrics(self):
        return self._phase.metrics()


class SpecIterator:
    """The ``task_spec_iterator`` contract: ``next()`` skips one task
    spec."""

    def __init__(self, grid):
        self._grid = grid

    def __next__(self):
        self._grid.skip_task()


class GridBackedSampler:
    """``RearrangeTaskSampler`` stand-in running real grid-world episodes
    of the seeds ``SEEDS`` (each spec: the walkthrough task, then its
    unshuffle task) at the sensors' camera size."""

    SEEDS = range(16)

    def __init__(self, **kwargs):
        cam = kwargs["sensors"][0].height
        self.grid = GridWorldTaskSampler(
            list(self.SEEDS), camera=CameraConfig(cam, cam),
            max_steps=kwargs["max_steps"], **SCENE_KW)
        self.task_spec_iterator = SpecIterator(self.grid)
        self.length = 2 * len(self.SEEDS)

    @classmethod
    def from_fixed_dataset(cls, **kwargs):
        return cls(**kwargs)

    def next_task(self):
        return GridTask(self.grid.next_task())

    def reset(self):
        self.grid.reset()


# -------------------------------------------------------------- modules


class Base:
    """``baseline_configs.rearrange_base.RearrangeBaseExperimentConfig``."""

    THOR_CONTROLLER_KWARGS = {"quality": "Very Low"}
    REARRANGE_ENV_KWARGS = {"mode": "default"}
    MAX_STEPS = 250
    REQUIRE_DONE_ACTION = True
    FORCE_AXIS_ALIGNED_START = True

    @staticmethod
    def stagewise_task_sampler_args(stage, process_ind, total_processes,
                                    devices):
        return {"scenes_to_allowed_rearrange_inds": {"s": [0]},
                "seed": 17}

    @staticmethod
    def actions():
        return ("done", "move_ahead")


def modules(sampler_cls) -> dict:
    """The fake ``ai2thor``, ``rearrange`` and ``baseline_configs``
    modules by name, ``rearrange.tasks.RearrangeTaskSampler`` being
    ``sampler_cls``."""
    def sensor(kind):
        def ctor(**kwargs):
            return types.SimpleNamespace(kind=kind, **kwargs)
        return ctor

    ai2thor = types.ModuleType("ai2thor")
    platform = types.ModuleType("ai2thor.platform")
    platform.CloudRendering = object()
    ai2thor.platform = platform

    rearrange = types.ModuleType("rearrange")
    sensors = types.ModuleType("rearrange.sensors")
    sensors.RGBRearrangeSensor = sensor("rgb")
    sensors.DepthRearrangeSensor = sensor("depth")
    tasks = types.ModuleType("rearrange.tasks")
    tasks.RearrangeTaskSampler = sampler_cls
    rearrange.sensors = sensors
    rearrange.tasks = tasks

    bc = types.ModuleType("baseline_configs")
    rb = types.ModuleType("baseline_configs.rearrange_base")
    rb.RearrangeBaseExperimentConfig = Base
    bc.rearrange_base = rb
    return {"ai2thor": ai2thor, "ai2thor.platform": platform,
            "rearrange": rearrange, "rearrange.sensors": sensors,
            "rearrange.tasks": tasks, "baseline_configs": bc,
            "baseline_configs.rearrange_base": rb}


@contextlib.contextmanager
def installed(sampler_cls):
    """The fake stack in ``sys.modules`` inside the block, whatever was
    there before restored after it."""
    fakes = modules(sampler_cls)
    saved = {name: sys.modules.get(name) for name in fakes}
    sys.modules.update(fakes)
    ContractSampler.captured = None
    try:
        yield
    finally:
        for name, module in saved.items():
            if module is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = module
