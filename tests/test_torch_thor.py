"""The port's THOR gateway (``mass_tpu_torch.env.thor``,
``env/_thor_config.py``) and ``--backend thor`` against fakes of the
rearrangement stack (``tests/torch_fake_thor.py``): the cases of
``tests/test_thor_contract.py`` and ``tests/test_thor_fleet.py`` on the
port, the gateway's observations beside the JAX package's on the same
fake, and a fleet whose slot samplers' own task ids differ from the task
index, which its results must carry as ``task_id``."""

import json

import numpy as np
import pytest

from mass_tpu_torch import taxonomy
from mass_tpu_torch.env.protocol import AgentPose
from tests import torch_fake_thor as F
from tests.torch_one_thread import one_thread  # noqa: F401


@pytest.fixture
def fake_thor():
    with F.installed(F.ContractSampler):
        yield


@pytest.fixture
def fake_thor_grid():
    with F.installed(F.GridBackedSampler):
        yield


def test_sampler_construction_args(fake_thor):
    from mass_tpu.env.thor import ThorTaskSampler as JaxSampler
    from mass_tpu_torch.env.thor import ThorTaskSampler

    JaxSampler(stage="val", ground_truth=True, screen_size=128)
    want = F.ContractSampler.captured
    sampler = ThorTaskSampler(stage="val", ground_truth=True,
                              screen_size=128)
    cap = F.ContractSampler.captured
    assert cap["run_walkthrough_phase"] is True
    assert cap["run_unshuffle_phase"] is True
    assert cap["stage"] == "val"
    assert cap["seed"] == 17
    assert cap["max_steps"] == 250
    assert cap["discrete_actions"] == ("done", "move_ahead")
    ck = cap["rearrange_env_kwargs"]["controller_kwargs"]
    assert ck["renderSemanticSegmentation"] is True
    assert ck["renderInstanceSegmentation"] is False
    assert ck["renderDepthImage"] is True
    rgb, depth = cap["sensors"]
    assert (rgb.kind, rgb.uuid, rgb.height) == ("rgb", "rgb", 128)
    assert (depth.kind, depth.uuid, depth.width) == ("depth", "depth",
                                                     128)
    assert len(sampler) == 4
    assert cap == want               # the JAX gateway's arguments


def test_one_phase_sampler_args(fake_thor):
    from mass_tpu_torch.env.thor import ThorTaskSampler
    ThorTaskSampler(one_phase=True)
    assert F.ContractSampler.captured["run_walkthrough_phase"] is False
    assert F.ContractSampler.captured["run_unshuffle_phase"] is True


def test_task_adaptation_gt_colors(fake_thor):
    from mass_tpu.env.thor import ThorTaskSampler as JaxSampler
    from mass_tpu_torch.env.thor import ThorTaskSampler

    task = ThorTaskSampler().next_task()
    obs = task.get_observations()
    assert obs["rgb"].dtype == np.float32
    assert obs["depth"].shape == (4, 4, 1)
    sem = obs["semantic"][..., 0]
    assert sem[0, 0] == 7 and sem[1, 1] == 12
    assert sem[2, 2] == 0                   # unknown -> OccupiedSpace
    want = JaxSampler().next_task().get_observations()
    assert sorted(obs) == sorted(want)
    for key in obs:
        assert obs[key].dtype == np.asarray(want[key]).dtype, key
        np.testing.assert_array_equal(obs[key], want[key], key)

    result = task.step(1)
    assert result.action_success is False
    assert result.info["extra"] == 1

    loc = task.agent_location()
    assert isinstance(loc, AgentPose)
    assert (loc.x, loc.z, loc.rotation_degrees) == (1.5, -2.0, 90.0)
    assert loc.horizon_degrees == 30.0 and loc.standing is False
    assert task.metrics() == {"unshuffle/success": 0.0}
    assert task.action_names() == ["done", "move_ahead"]


def test_skip_and_reset(fake_thor):
    from mass_tpu_torch.env.thor import ThorTaskSampler
    sampler = ThorTaskSampler()
    sampler.skip_task()
    assert next(sampler._sampler.task_spec_iterator) == 1
    sampler.reset()
    assert sampler._sampler.reset_calls == 1


def test_one_phase_goal_observations(fake_thor):
    """One-phase tasks surface the goal world's render from the same
    pose as goal_rgb / goal_depth / goal_semantic, as the JAX gateway
    does; two-phase tasks never pay the goal render."""
    import types

    from mass_tpu.env.thor import ThorTaskSampler as JaxSampler
    from mass_tpu_torch.env.thor import ThorTaskSampler

    colors = taxonomy.class_colors_array(normalized=False).astype(
        np.uint8)
    goal_sem = np.zeros((4, 4, 3), np.uint8)
    goal_sem[3, 3] = colors[21]
    goal_event = types.SimpleNamespace(
        frame=np.full((4, 4, 3), 128, np.uint8),
        depth_frame=np.full((4, 4), 2.5, np.float32),
        semantic_segmentation_frame=goal_sem)

    observations = []
    for cls in (ThorTaskSampler, JaxSampler):
        task = cls(one_phase=True).next_task()
        task._task.walkthrough_env = types.SimpleNamespace(
            last_event=goal_event)
        observations.append(task.get_observations())
    obs, want = observations
    assert obs["goal_rgb"].dtype == np.float32
    np.testing.assert_allclose(obs["goal_rgb"], 128 / 255.0)
    assert obs["goal_depth"].shape == (4, 4, 1)
    np.testing.assert_allclose(obs["goal_depth"][..., 0], 2.5)
    gsem = obs["goal_semantic"][..., 0]
    assert gsem[3, 3] == 21 and gsem[0, 0] == 0
    for key in ("goal_rgb", "goal_depth", "goal_semantic"):
        np.testing.assert_array_equal(obs[key], want[key], key)
    two = ThorTaskSampler().next_task()
    assert "goal_rgb" not in two.get_observations()


def test_pose_conventions_crouch_and_horizon(fake_thor):
    """The port controller's pose over the gateway: yaw = pi/2 - rot,
    elevation = -horizon, crouching agents subtract the 0.675 m camera
    offset, at the horizon's extremes too."""
    from mass_tpu_torch.env.thor import ThorTaskSampler
    from mass_tpu_torch.nav.controller import (CROUCH_HEIGHT_OFFSET,
                                               NavigationController)

    task = ThorTaskSampler().next_task()
    ctrl = object.__new__(NavigationController)   # pose methods only
    ctrl.task = task

    for rot, horizon, standing in ((0.0, 60.0, True),
                                   (90.0, -30.0, False),
                                   (270.0, 0.0, False)):
        task._task.env.get_agent_location = lambda: dict(
            x=1.5, y=0.9, z=-2.0, rotation=rot, horizon=horizon,
            standing=standing)
        pos = ctrl.process_position()
        yaw = ctrl.process_yaw()
        elev = ctrl.process_elevation()
        np.testing.assert_allclose(
            yaw, np.pi / 2 - np.radians(rot), atol=1e-6)
        np.testing.assert_allclose(elev, -np.radians(horizon),
                                   atol=1e-6)
        expect_y = 0.9 - (0.0 if standing else CROUCH_HEIGHT_OFFSET)
        np.testing.assert_allclose(pos, [1.5, -2.0, expect_y],
                                   atol=1e-6)


def test_crash_restart_resumes_mid_episode(fake_thor):
    """A simulator crash mid-run restarts the experiment and skips the
    tasks already completed."""
    from mass_tpu_torch.agent.reliability import (SimulatorCrashError,
                                                  run_with_restart)
    from mass_tpu_torch.env.thor import ThorTaskSampler

    completed = []
    attempts = {"n": 0}

    def experiment():
        attempts["n"] += 1
        sampler = ThorTaskSampler()
        for task_id in range(4):
            if task_id in completed:
                sampler.skip_task()
                continue
            task = sampler.next_task()
            task.get_observations()
            if attempts["n"] == 1 and task_id == 2:
                raise SimulatorCrashError("unity hung mid-episode")
            task.step(1)
            completed.append(task_id)
        return completed

    out = run_with_restart(experiment)
    assert attempts["n"] == 2
    assert out == [0, 1, 2, 3]          # no task lost, none duplicated


COMMON = [
    "--device", "cpu", "--camera-size", "48",
    "--map-height", "80", "--map-width", "80", "--map-depth", "24",
    "--grid-resolution", "0.125", "--map-slice-start", "0",
    "--map-slice-stop", "12", "--step-size", "2",
    "--obstacle-padding", "2", "--max-goal-steps", "60",
    "--exploration-budget-one", "1", "--exploration-budget-two", "1",
    "--ground-truth-segmentation", "--ground-truth-disagreement",
    "--ground-truth-semantic-search",
    "--confidence-threshold", "0.1", "--distance-threshold", "0.2",
    "--start-task", "0", "--total-tasks", "3",
]
GRID = ["--backend", "gridworld",
        "--num-objects", str(F.SCENE_KW["num_objects"]),
        "--num-misplaced", str(F.SCENE_KW["num_misplaced"]),
        "--num-opened", str(F.SCENE_KW["num_opened"])]
KEYS = ("unshuffle/prop_fixed", "unshuffle/prop_fixed_strict",
        "unshuffle/success", "unshuffle/num_fixed",
        "unshuffle/num_initially_misplaced", "unshuffle/objects_moved")


def _results(logdir, task_id):
    with open(logdir / "results" / f"{task_id}.json") as f:
        return json.load(f)


def test_thor_fleet_slot_skip_ahead(fake_thor_grid, monkeypatch, tmp_path):
    """Persistent gateway slots skip to their task: with --every-tasks 2
    and fleet 2 over tasks (0, 2, 4), slot 0 serves specs 0 then 4 and
    slot 1 spec 2 (the grid-backed sampler's cursor); results carry the
    task index."""
    from mass_tpu_torch.agent import cli
    from mass_tpu_torch.parallel import evaluator as ev

    captured = []

    class _StubEvaluator:
        def __init__(self, config, samplers, seeds=None, **kw):
            captured.append([s._sampler.grid._cursor for s in samplers])
            self._samplers = self.episodes = samplers
            for s in samplers:      # consume the spec like an episode
                s.next_task()
                s.next_task()

        def run(self):
            return [{"unshuffle/prop_fixed_strict": 0.0,
                     "unshuffle/success": 0.0}
                    for _ in self._samplers]

    monkeypatch.setattr(ev, "FleetEvaluator", _StubEvaluator)
    args = cli.build_parser().parse_args(
        COMMON + ["--backend", "thor", "--fleet-size", "2",
                  "--every-tasks", "2", "--logdir", str(tmp_path)])
    results = cli.run_fleet(args, cli.config_from_args(args), "cpu")

    assert captured == [[0, 2], [4]]
    assert [r["task_id"] for r in results] == [0, 2, 4]


def test_thor_fleet_cli_matches_sequential_gateway(fake_thor_grid,
                                                   tmp_path):
    """--backend thor, sequential and --fleet-size 2 over 3 tasks (the
    skip-ahead batch included): each task's outcome equals the sequential
    gateway run's and the plain grid world's on the same scenes (the
    gateway is lossless), and the sequential gateway run equals the grid
    world's on every field."""
    from mass_tpu_torch.agent import cli

    thor = COMMON + ["--backend", "thor"]
    cli.main(thor + ["--logdir", str(tmp_path / "fleet"),
                     "--fleet-size", "2"])
    cli.main(thor + ["--logdir", str(tmp_path / "seq")])
    cli.main(COMMON + GRID + ["--logdir", str(tmp_path / "grid")])

    for s in range(3):
        got = _results(tmp_path / "fleet", s)
        want = _results(tmp_path / "seq", s)
        plain = _results(tmp_path / "grid", s)
        assert got["task_id"] == s
        for k in KEYS:
            assert got[k] == want[k], (s, k, got[k], want[k])
            assert got[k] == plain[k], (s, k, got[k], plain[k])
        assert ({k: v for k, v in want.items() if k != "timing"}
                == {k: v for k, v in plain.items() if k != "timing"})
    assert any(_results(tmp_path / "fleet", s)["unshuffle/num_fixed"]
               for s in range(3))


class _OffsetSampler(F.GridBackedSampler):
    """Task specs whose grid-world episodes report their own task ids,
    100 past the task index."""

    SEEDS = range(100, 116)


def test_thor_fleet_stamps_task_index(tmp_path):
    """A THOR fleet reports each episode under its task index, where the
    simulator's own metrics name another id (here the grid world's seed,
    100 + the index): results/{task}.json carries task_id == task."""
    from mass_tpu_torch.agent import cli

    flags = COMMON[:-4] + ["--backend", "thor", "--start-task", "0",
                           "--total-tasks", "2"]
    with F.installed(_OffsetSampler):
        metrics = cli.main(flags + ["--fleet-size", "2", "--logdir",
                                    str(tmp_path / "fleet")])
        cli.main(flags + ["--logdir", str(tmp_path / "seq")])
    assert [m["task_id"] for m in metrics] == [0, 1]
    for s in range(2):
        assert _results(tmp_path / "fleet", s)["task_id"] == s
        assert _results(tmp_path / "seq", s)["task_id"] == 100 + s
