"""The port's lockstep fleet (parallel/evaluator.py, ``--fleet-size``)
held against the port's sequential agent on the same seeds (results
apart from timing, every action and every map update equal) and against
the JAX package's FleetEvaluator; its CLI route and its refusals."""

import json
import os

import numpy as np
import pytest
import torch

from mass_tpu_torch.ops import splat as SP
from mass_tpu_torch.parallel import fleet as TF
from tests.test_torch_agent import jax_node_memo_held

SEEDS = [2, 4]
GEO = dict(map_height=80, map_width=80, map_depth=24, grid_resolution=0.125)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Episodes of these small maps run faster on one CPU thread, and
    several test workers on one host would otherwise each spread their
    small ops over every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
# the fleet's stage times (on episode 0's results)
FLEET_KEYS = ("fleet_timing",)


def _config(pkg: str, compat: bool = False, **kw):
    """tests/test_evaluator.py's settings with budgets 1+1; ``compat``
    adds the --reference-compat rules and a separate occupancy map."""
    if pkg == "jax":
        from mass_tpu.config import AgentConfig, CameraConfig, MatchConfig, \
            NavConfig
    else:
        from mass_tpu_torch.config import AgentConfig, CameraConfig, \
            MatchConfig, NavConfig
    return AgentConfig(
        camera=CameraConfig(height=48, width=48), **GEO,
        nav=NavConfig(step_size=2, obstacle_padding=2, map_slice_start=0,
                      map_slice_stop=12, graph_update_interval=5,
                      max_goal_steps=0 if compat else 60,
                      reference_compat=compat),
        match=MatchConfig(contour_padding=0, confidence_threshold=0.1,
                          distance_threshold=0.2, max_instances=8),
        navigate_on_semantic=not compat, exploration_budget_one=1,
        exploration_budget_two=1, ground_truth_segmentation=True,
        ground_truth_disagreement=True, start_task=0, total_tasks=1, **kw)


def _recording_sampler(pkg: str, seed: int, actions: list,
                       max_steps: int = 250):
    """A singleton sampler whose tasks append every action taken."""
    if pkg == "jax":
        from mass_tpu.config import CameraConfig
        from mass_tpu.env.rearrange import GridWorldTaskSampler
    else:
        from mass_tpu_torch.config import CameraConfig
        from mass_tpu_torch.env.rearrange import GridWorldTaskSampler
    sampler = GridWorldTaskSampler([seed],
                                   camera=CameraConfig(height=48, width=48),
                                   max_steps=max_steps, num_objects=2,
                                   num_misplaced=1, num_opened=0)
    next_task = sampler.next_task

    def recording_next_task():
        task = next_task()
        step = task.step

        def recorded(action):
            actions.append(int(action))
            return step(action)
        task.step = recorded
        return task
    sampler.next_task = recording_next_task
    return sampler


def _fleet(pkg: str, cfg, max_steps: int = 250):
    """(results, actions per episode, evaluator) of one fleet over
    SEEDS, rng seeds 100 + seed."""
    if pkg == "jax":
        from mass_tpu.parallel.evaluator import FleetEvaluator
        kw = {}
    else:
        from mass_tpu_torch.parallel.evaluator import FleetEvaluator
        kw = {"device": "cpu"}
    actions = [[] for _ in SEEDS]
    samplers = [_recording_sampler(pkg, s, a, max_steps)
                for s, a in zip(SEEDS, actions)]
    evaluator = FleetEvaluator(cfg, samplers, seeds=[100 + s for s in SEEDS],
                               **kw)
    with jax_node_memo_held():
        return evaluator.run(), actions, evaluator


def _drift(got: dict, want: dict) -> dict:
    keys = (set(got) | set(want)) - {"timing", *FLEET_KEYS}
    return {k: (got.get(k), want.get(k)) for k in keys
            if got.get(k) != want.get(k)}


@pytest.mark.parametrize("compat", [False, True], ids=["default", "compat"])
def test_fleet_episodes_equal_sequential_agent(compat, monkeypatch):
    """B = 2 fleet episodes on the CPU equal the sequential port agent on
    the same seeds: results apart from timing, every action, and the
    number of map updates.  Under --reference-compat, phase one's
    occupancy and semantic0 share one splat (the multi-map kernel on a
    card); by default no splat holds two families."""
    from mass_tpu_torch.agent.loop import RearrangementAgent

    splats = []
    apply = TF.apply_onehot_group

    def counted(vms, *args):
        splats.append(len(vms))
        return apply(vms, *args)
    monkeypatch.setattr(TF, "apply_onehot_group", counted)
    max_steps = 120 if compat else 250
    cfg = _config("torch", compat)
    launches = (SP.LAUNCHES, SP.MULTI_LAUNCHES)
    results, actions, evaluator = _fleet("torch", cfg, max_steps)
    assert (SP.LAUNCHES, SP.MULTI_LAUNCHES) == launches     # CPU: plain
    assert "fleet_timing" in results[0]
    ticks = evaluator.timer.counts["mapping"]
    assert ticks <= len(splats) <= 2 * ticks
    for s, got, got_actions, ep in zip(SEEDS, results, actions,
                                       evaluator.episodes):
        want_actions = []
        agent = RearrangementAgent(
            cfg, _recording_sampler("torch", s, want_actions, max_steps),
            rng=np.random.RandomState(100 + s), device="cpu")
        want = agent.run_task(0)
        assert not _drift(got, want), s
        assert got_actions == want_actions and len(got_actions) > 20
        assert ep.map_updates == want["timing"]["mapping"]["count"]
    assert (2 in splats) == compat
    assert max(splats) == (2 if compat else 1)
    assert np.mean([r["unshuffle/prop_fixed"] for r in results]) > 0


def test_fleet_matches_jax_fleet_evaluator():
    """The port's fleet and the JAX package's FleetEvaluator on the same
    samplers and seeds: results apart from the fleet's stage times, and
    every action, equal."""
    got, got_actions, _ = _fleet("torch", _config("torch"))
    ref, ref_actions, _ = _fleet("jax", _config("jax"))
    assert got_actions == ref_actions
    for g, r in zip(got, ref):
        assert not _drift(g, r)


SMALL = ["--ground-truth-segmentation", "--ground-truth-disagreement",
         "--camera-size", "16", "--map-height", "32", "--map-width", "32",
         "--map-depth", "8", "--grid-resolution", "0.25", "--step-size", "1",
         "--obstacle-padding", "1", "--map-slice-start", "0",
         "--map-slice-stop", "4", "--exploration-budget-one", "1",
         "--exploration-budget-two", "1", "--max-steps", "20",
         "--num-objects", "2", "--num-misplaced", "1", "--num-opened", "0",
         "--record-found-objects", "--device", "cpu"]


def test_cli_fleet_writes_results(tmp_path):
    """--fleet-size 2 on the CPU runs tasks 2 and 3 in lockstep and
    writes both results files and the found-object records; task 3's
    equal those of the sequential CLI on task 3 with --seed 3 (the
    fleet's seed for it)."""
    from mass_tpu_torch.agent import cli

    fleet_dir, seq_dir = tmp_path / "fleet", tmp_path / "seq"
    metrics = cli.main(SMALL + ["--fleet-size", "2", "--start-task", "2",
                                "--total-tasks", "2", "--logdir",
                                str(fleet_dir)])
    assert [m["task_id"] for m in metrics] == [2, 3]
    cli.main(SMALL + ["--start-task", "3", "--total-tasks", "1", "--seed",
                      "3", "--logdir", str(seq_dir)])
    for task in (2, 3):
        assert (fleet_dir / "results" / f"{task}.json").exists()
        for phase in ("walkthrough", "unshuffle"):
            name = f"objects-found-{phase}-{task}"
            assert (fleet_dir / "results" / f"{name}.npy").exists()
            assert (fleet_dir / "results" / f"{name}-types.json").exists()
    with open(fleet_dir / "results" / "3.json") as f:
        got = json.load(f)
    with open(seq_dir / "results" / "3.json") as f:
        want = json.load(f)
    assert got["task_id"] == 3 and not _drift(got, want)
    for phase in ("walkthrough", "unshuffle"):
        name = f"objects-found-{phase}-3.npy"
        np.testing.assert_array_equal(
            np.load(fleet_dir / "results" / name),
            np.load(seq_dir / "results" / name))


@pytest.mark.parametrize("change,slice_no", [
    ({"policy_params": {}}, 2),
    ({"sensor": object()}, 3),
    ({"feature_backbone": object()}, 3),
    ({"one_phase": True}, 2),
    ({"frontier_exploration": True}, 2),
    ({"revisit_exploration": True}, 2),
    ({"use_feature_matching": True}, 3),
    ({"shard_map": 4}, 4),
    ({"snapshot_maps": True}, 3),
])
def test_fleet_refuses_later_slices(change, slice_no):
    from mass_tpu_torch.parallel.evaluator import FleetEvaluator

    args = {k: v for k, v in change.items()
            if k in ("policy_params", "sensor", "feature_backbone")}
    cfg = _config("torch", **{k: v for k, v in change.items()
                              if k not in args})
    with pytest.raises(NotImplementedError, match=f"slice {slice_no}"):
        FleetEvaluator(cfg, [object(), object()], device="cpu", **args)


def test_fleet_refuses_to_fall_back_to_cpu(monkeypatch, tmp_path):
    from mass_tpu_torch.agent import cli
    from mass_tpu_torch.parallel.evaluator import FleetEvaluator

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FleetEvaluator(_config("torch"), [object(), object()])
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(SMALL[:-2] + ["--fleet-size", "2", "--total-tasks", "2",
                               "--logdir", str(tmp_path)])
    assert not os.path.exists(tmp_path / "results")
