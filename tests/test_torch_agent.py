"""The port's slice end to end: a two-phase episode through both agents
(results and per-step actions equal), the CLI's flag surface, and the
frozen-protocol random arm through the port's CLI."""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def jax_node_memo_held():
    """Hold every nav grid and evidence object that the JAX controller's
    node memo keys on.  That memo keys on the ``id()`` of objects it does
    not hold, so a freed grid's id can pass to a new grid and hit a stale
    entry (ROADMAP.md queue 3), which makes the reference episode depend
    on the allocator.  Held keys keep every id unique for the episode, as
    the port's memo (which holds its keys) always does."""
    from mass_tpu.nav.controller import NavigationController

    original = NavigationController.navigable_node_cells
    held = []

    def navigable_node_cells(self, *args, **kwargs):
        held.append((self.nav_grid, self.blocked_cells))
        return original(self, *args, **kwargs)
    NavigationController.navigable_node_cells = navigable_node_cells
    try:
        yield
    finally:
        NavigationController.navigable_node_cells = original


def _episode(pkg: str, gt_search: bool = False):
    """One episode at the verify recipe's agent-level settings (camera
    48, 80x80x24 at 0.125 m), random or ground-truth goals, exploration
    budgets 1+1; returns (results, actions)."""
    if pkg == "jax":
        from mass_tpu.agent.loop import RearrangementAgent
        from mass_tpu.config import AgentConfig, CameraConfig, NavConfig
        from mass_tpu.env.rearrange import GridWorldTaskSampler
        extra = {}
    else:
        from mass_tpu_torch.agent.loop import RearrangementAgent
        from mass_tpu_torch.config import AgentConfig, CameraConfig, \
            NavConfig
        from mass_tpu_torch.env.rearrange import GridWorldTaskSampler
        extra = {"device": "cpu"}
    cam = CameraConfig(height=48, width=48)
    cfg = AgentConfig(
        camera=cam, map_height=80, map_width=80, map_depth=24,
        grid_resolution=0.125,
        nav=NavConfig(step_size=2, obstacle_padding=2, map_slice_start=0,
                      map_slice_stop=12, max_goal_steps=80),
        ground_truth_segmentation=True, ground_truth_disagreement=True,
        ground_truth_semantic_search=gt_search,
        exploration_budget_one=1, exploration_budget_two=1,
        start_task=0, total_tasks=1)
    sampler = GridWorldTaskSampler([2], camera=cam, num_objects=2,
                                   num_misplaced=1, num_opened=0)
    actions = []
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
    agent = RearrangementAgent(cfg, sampler, rng=np.random.RandomState(0),
                               **extra)
    with jax_node_memo_held():
        return agent.run_task(0), actions


@pytest.mark.parametrize("gt_search", [False, True])
def test_episode_matches_jax_agent(gt_search):
    from mass_tpu_torch.ops import splat as SP

    launches = SP.LAUNCHES
    got, got_actions = _episode("torch", gt_search)
    ref, ref_actions = _episode("jax", gt_search)
    assert SP.LAUNCHES == launches          # CPU maps: plain version
    assert got_actions == ref_actions and len(got_actions) > 20
    drift = {k: (ref[k], got.get(k)) for k in ref
             if k != "timing" and ref[k] != got.get(k)}
    assert not drift
    assert got["unshuffle/prop_fixed"] == 1.0
    assert got["timing"]["mapping"]["count"] > 0


def _controller_after_failures(pkg: str):
    """A controller one planned step into an episode, after a failed
    rotation (prunes a path node) and a failed move (collision
    evidence); returns its nav grid masks and evidence as numpy."""
    if pkg == "jax":
        from mass_tpu.config import CameraConfig, NavConfig
        from mass_tpu.env.rearrange import GridWorldTaskSampler
        from mass_tpu.maps import MapSet, SemanticMap
        from mass_tpu.nav.controller import NavigationController
        kw = {}
    else:
        from mass_tpu_torch.config import CameraConfig, NavConfig
        from mass_tpu_torch.env.rearrange import GridWorldTaskSampler
        from mass_tpu_torch.maps import MapSet, SemanticMap
        from mass_tpu_torch.nav.controller import NavigationController
        kw = {"device": "cpu"}
    cam = CameraConfig(height=48, width=48)
    task = GridWorldTaskSampler([2], camera=cam, num_objects=2,
                                num_misplaced=1, num_opened=0).next_task()
    maps = MapSet(semantic0=SemanticMap(
        cam, 54, map_height=80, map_width=80, map_depth=24,
        grid_resolution=0.125, **kw))
    loc = task.agent_location()
    maps.reset_all((loc.x, loc.z, loc.y))
    ctl = NavigationController(
        task, "semantic0", maps,
        NavConfig(step_size=2, obstacle_padding=2, map_slice_start=0,
                  map_slice_stop=12), rng=np.random.RandomState(0))
    obs = task.get_observations()
    goal = ctl.process_position() + np.asarray([1.5, 0.5, 0.0], np.float32)
    names = task.action_names()
    ctl.get_action(obs, goal, update_map=["semantic0"])
    ctl.failed_action(obs, names.index("rotate_left"))
    ctl.failed_action(obs, names.index("move_ahead"))
    g = ctl.nav_grid
    return (np.asarray(g.alive), np.asarray(g.pruned),
            np.asarray(g.edge_right), np.asarray(g.edge_down),
            np.asarray(ctl.blocked_cells), np.asarray(obs["path"]))


def test_failed_actions_match_jax():
    got = _controller_after_failures("torch")
    ref = _controller_after_failures("jax")
    assert got[1].sum() == 1 and got[4].any()      # a prune, some evidence
    for a, b in zip(got[:5], ref[:5]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[5], ref[5], atol=1e-6)


# a tiny CLI run on the CPU: 16x16 camera, 32x32x8 maps, budgets 1+1
SMALL = ["--ground-truth-segmentation", "--ground-truth-disagreement",
         "--camera-size", "16", "--map-height", "32", "--map-width", "32",
         "--map-depth", "8", "--grid-resolution", "0.25", "--step-size", "1",
         "--obstacle-padding", "1", "--map-slice-start", "0",
         "--map-slice-stop", "4", "--exploration-budget-one", "1",
         "--exploration-budget-two", "1", "--max-steps", "20",
         "--num-objects", "2", "--num-misplaced", "1", "--num-opened", "0",
         "--record-found-objects", "--device", "cpu"]
GRIDWORLD_POLICY = os.path.join(REPO, "mass_tpu_torch", "checkpoints",
                                "policy-gridworld.pth")
BACKBONE = os.path.join(REPO, "mass_tpu_torch", "checkpoints",
                        "backbone-rand.pth")


@pytest.mark.parametrize("flags,slice_no", [
    (["--backend", "thor"], None),
    # learned segmentation without a detector: stops naming the flag
    ([], "a learned detector is required"),
    (["--policy-checkpoint", GRIDWORLD_POLICY,
      "--semantic-search-unshuffle"], None),
    (["--frontier-exploration"], None),
    (["--revisit-exploration"], None),
    (["--use-feature-matching", "--backbone-checkpoint", BACKBONE], None),
    (["--one-phase"], None),
    # eight row slabs of every map on the CPU (parallel/sharding.py)
    (["--shard-map", "8"], None),
    (["--snapshot-maps"], None),
    (["--videos"], None),
])
def test_cli_rejects_flags_of_later_slices(flags, slice_no, tmp_path):
    """Every flag of the JAX CLI runs on the port (``slice_no`` None): a
    CPU run writes results/2.json, ``--shard-map 8`` with every map in
    eight row slabs, ``--snapshot-maps`` the episode's maps, ``--videos``
    its mp4 (a frame per observation), and ``--backend thor`` (on the
    grid-backed fake of the THOR stack) the first episode of THOR's own
    task specs; a run that lacks what a flag needs stops before anything
    is written (a string ``slice_no`` is the message expected)."""
    from mass_tpu_torch.agent import cli
    from tests import torch_fake_thor

    if slice_no is None:
        thor = "thor" in flags
        with torch_fake_thor.installed(torch_fake_thor.GridBackedSampler):
            metrics = cli.main(SMALL + flags + [
                "--start-task", "2", "--total-tasks", "1",
                "--logdir", str(tmp_path)])
        with open(tmp_path / "results" / "2.json") as f:
            assert json.load(f)["task_id"] == (0 if thor else 2)
        if "--snapshot-maps" in flags:
            with np.load(tmp_path / "results" / "maps-2.npz") as z:
                assert z["semantic0"].shape == (32, 32, 8, 54)
                assert z["semantic0"].dtype == np.float16
                assert np.count_nonzero(z["semantic1"]) > 0
                assert z["semantic1_bins_z"].shape == (9,)
        if "--videos" in flags:
            import cv2
            video = cv2.VideoCapture(str(tmp_path / "videos" / "2.mp4"))
            frames = 0
            while video.read()[0]:
                frames += 1
            video.release()
            steps = metrics[0]["timing"]["mapping"]["count"]
            assert frames == steps > 0      # one frame an observation
        return
    base = [] if flags == [] else ["--ground-truth-segmentation"]
    match = (slice_no if isinstance(slice_no, str)
             else f"slice {slice_no}")
    with pytest.raises(SystemExit, match=match):
        cli.main(base + flags + ["--logdir", str(tmp_path), "--device",
                                 "cpu"])
    assert not os.listdir(tmp_path)


def test_cli_feature_matching_needs_a_pth_backbone(tmp_path):
    """--use-feature-matching without --backbone-checkpoint stops naming
    the flag (the JAX package would download torchvision's weights); an
    orbax tree is refused with the name of its export; nothing is
    written."""
    from mass_tpu_torch.agent import cli

    with pytest.raises(SystemExit, match="--backbone-checkpoint"):
        cli.main(SMALL + ["--use-feature-matching", "--logdir",
                          str(tmp_path)])
    with pytest.raises(SystemExit, match="backbone-rand.pth"):
        cli.main(SMALL + ["--use-feature-matching", "--backbone-checkpoint",
                          "/tmp/backbone-rand", "--logdir", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_cli_refuses_orbax_policy_and_names_its_export(tmp_path):
    from mass_tpu_torch.agent import cli

    orbax = os.path.join(REPO, "checkpoints", "policy-gridworld")
    with pytest.raises(SystemExit, match="policy-gridworld.pth"):
        cli.main(SMALL + ["--policy-checkpoint", orbax, "--logdir",
                          str(tmp_path)])
    assert not os.path.exists(tmp_path / "results")


def test_cli_takes_mass_tpu_flags_and_defaults():
    from mass_tpu.agent import cli as jcli
    from mass_tpu_torch.agent import cli as tcli

    parse = tcli.build_parser().parse_args
    ref = vars(jcli.build_parser().parse_args([]))
    got = vars(parse([]))
    assert {k: got[k] for k in ref} == ref
    assert tcli.resolve_device_flags(parse([])) == "cuda"
    for flags in (["--platform", "cpu"], ["--device", "cpu"],
                  ["--platform", "cpu", "--device", "cpu"]):
        assert tcli.resolve_device_flags(parse(flags)) == "cpu"
    with pytest.raises(SystemExit, match="conflicts"):
        tcli.resolve_device_flags(parse(["--platform", "cpu",
                                         "--device", "cuda"]))


def test_agent_refuses_to_fall_back_to_cpu(monkeypatch, tmp_path):
    from mass_tpu_torch.agent import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--ground-truth-segmentation", "--total-tasks", "1",
                  "--camera-size", "16", "--map-height", "16",
                  "--map-width", "16", "--map-depth", "8",
                  "--logdir", str(tmp_path)])


def test_resume_skips_completed_tasks(tmp_path):
    """--resume skips tasks whose results exist and keeps the sampler's
    seed cursor where an uninterrupted run would have it (the port of
    tests/test_agent_e2e.py's check)."""
    from mass_tpu_torch.agent.loop import RearrangementAgent
    from mass_tpu_torch.config import AgentConfig, CameraConfig
    from mass_tpu_torch.env.rearrange import GridWorldTaskSampler

    cam = CameraConfig(height=16, width=16)
    cfg = AgentConfig(camera=cam, map_height=16, map_width=16,
                      map_depth=8, logdir=str(tmp_path), start_task=0,
                      total_tasks=3, resume=True)
    sampler = GridWorldTaskSampler(list(range(4)), camera=cam,
                                   max_steps=60, num_objects=2,
                                   num_misplaced=1, num_opened=0)
    agent = RearrangementAgent(cfg, sampler, device="cpu")
    os.makedirs(tmp_path / "results", exist_ok=True)
    for done in (0, 2):
        with open(tmp_path / "results" / f"{done}.json", "w") as f:
            json.dump({"unshuffle/prop_fixed_strict": 1.0}, f)
    ran = []

    def fake_run_task(task_id):
        agent.sampler.next_task()
        agent.sampler.next_task()
        ran.append((task_id, agent.sampler.current_episode.task_id))
        return {"task": task_id}

    agent.run_task = fake_run_task
    assert agent.run() == [{"task": 1}]
    assert ran == [(1, 1)]
    assert cfg.start_task == 3 and cfg.total_tasks == 0


# tests/test_frozen_protocol.py's flags, for the committed random arm
PROTOCOL = [
    "--backend", "gridworld", "--platform", "cpu",
    "--camera-size", "48", "--map-height", "160", "--map-width", "160",
    "--map-depth", "24", "--grid-resolution", "0.125",
    "--step-size", "2", "--obstacle-padding", "2",
    "--map-slice-start", "0", "--map-slice-stop", "12",
    "--room-size", "12", "--num-rooms", "3",
    "--num-objects", "5", "--num-misplaced", "2",
    "--exploration-budget-one", "2", "--exploration-budget-two", "2",
    "--max-goal-steps", "60", "--ground-truth-segmentation",
    "--ground-truth-disagreement", "--record-found-objects",
    "--start-task", "0", "--total-tasks", "1",
]


@pytest.mark.slow
def test_frozen_protocol_random_arm_through_port(tmp_path):
    from mass_tpu_torch.agent import cli

    with open(os.path.join(REPO, "experiments", "mr22", "random", "results",
                           "0.json")) as f:
        committed = json.load(f)
    cli.main(PROTOCOL + ["--device", "cpu", "--logdir", str(tmp_path)])
    with open(tmp_path / "results" / "0.json") as f:
        fresh = json.load(f)
    drift = {k: (committed[k], fresh.get(k)) for k in committed
             if k != "timing" and fresh.get(k) != committed[k]}
    assert not drift
