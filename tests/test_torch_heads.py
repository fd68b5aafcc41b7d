"""The goal heads on the port: frontier mass and the frontier goal,
walkthrough-site revisits, and whole episodes with the frontier, revisit,
policy and one-phase heads, each held against the JAX package on the
same inputs (their B = 2 fleets: tests/test_torch_heads_fleet.py); and
(slow) task 0 of the frozen protocol's committed arms through the port's
CLI."""

import json
import os

import numpy as np
import pytest
import torch

from tests.test_torch_agent import PROTOCOL, jax_node_memo_held
from tests.torch_checkpoints import load_orbax, pth_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Episodes of these small maps run faster on one CPU thread, and
    several test workers on one host would otherwise each spread their
    small ops over every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pkg(pkg: str):
    """(config module, GridWorldTaskSampler, extra agent kwargs)."""
    if pkg == "jax":
        from mass_tpu import config
        from mass_tpu.env.rearrange import GridWorldTaskSampler
        return config, GridWorldTaskSampler, {}
    from mass_tpu_torch import config
    from mass_tpu_torch.env.rearrange import GridWorldTaskSampler
    return config, GridWorldTaskSampler, {"device": "cpu"}


def _mapped_scene(pkg: str, steps: int = 6):
    """A controller whose semantic0 map holds the first ``steps`` frames
    of task 2 (turning in place, then a failed move for collision
    evidence)."""
    C, Sampler, kw = _pkg(pkg)
    if pkg == "jax":
        from mass_tpu.maps import MapSet, SemanticMap
        from mass_tpu.nav.controller import NavigationController
    else:
        from mass_tpu_torch.maps import MapSet, SemanticMap
        from mass_tpu_torch.nav.controller import NavigationController
    cam = C.CameraConfig(height=48, width=48)
    task = Sampler([2], camera=cam, num_objects=3, num_misplaced=1,
                   num_opened=0).next_task()
    maps = MapSet(semantic0=SemanticMap(
        cam, 54, map_height=80, map_width=80, map_depth=24,
        grid_resolution=0.125, **kw))
    loc = task.agent_location()
    maps.reset_all((loc.x, loc.z, loc.y))
    ctl = NavigationController(
        task, "semantic0", maps,
        C.NavConfig(step_size=2, obstacle_padding=2, map_slice_start=0,
                    map_slice_stop=12), rng=np.random.RandomState(5))
    names = task.action_names()
    task.step(names.index("look_down"))
    for k in range(steps):
        obs = task.get_observations()
        ctl.process_observations(obs, update_map=["semantic0"])
        task.step(names.index("rotate_left" if k % 3 else "move_ahead"))
    ctl.update_navigation_grid()
    ctl.failed_action(obs, names.index("move_ahead"))
    return ctl


def test_frontier_mass_is_exact():
    from mass_tpu.nav import grid as JG
    from mass_tpu_torch.nav import grid as TG

    got_ctl, ref_ctl = _mapped_scene("torch"), _mapped_scene("jax")
    assert got_ctl.blocked_cells.any()
    for radius, padding, blocked in ((8, 0, True), (3, 2, False),
                                     (1, 0, False)):
        got = TG.frontier_mass(
            got_ctl._occupancy_vm(), radius, padding=padding, z_start=0,
            z_stop=12, blocked=(got_ctl._blocked_operand() if blocked
                                else None)).numpy()
        ref = np.asarray(JG.frontier_mass(
            ref_ctl._occupancy_vm(), radius, padding=padding, z_start=0,
            z_stop=12, blocked=(ref_ctl._blocked_operand() if blocked
                                else None)))
        assert got.dtype == ref.dtype == np.float32
        assert got.max() > 0
        np.testing.assert_array_equal(got, ref)


def test_frontier_goal_matches_jax():
    """Three frontier goals in a row (each one rng draw, or two with the
    random sample first as the agent draws it) give JAX's goals, and
    leave both rngs in the same state."""
    got_ctl, ref_ctl = _mapped_scene("torch"), _mapped_scene("jax")
    for ctl_pair in ((got_ctl, ref_ctl),) * 3:
        got = [c.sample_navigation_goal({}) for c in ctl_pair]
        np.testing.assert_array_equal(got[0], got[1])
        got = [c.frontier_navigation_goal({}) for c in ctl_pair]
        np.testing.assert_array_equal(got[0], got[1])
    assert got_ctl.rng.randint(1 << 30) == ref_ctl.rng.randint(1 << 30)


def test_walkthrough_sites_and_picks_match_jax(monkeypatch):
    """Sites of a walkthrough map with five blobs of one pickable class,
    three of an openable one and two of structure (never a site), from an
    instance cap of 2 that doubles while an actionable class is truncated
    (2, 4, 8); then every pick and the rng after them."""
    from mass_tpu.config import MatchConfig as JMatchConfig
    from mass_tpu.match import revisit as JR
    from mass_tpu_torch.config import MatchConfig
    from mass_tpu_torch.match import revisit as TR
    from tests.test_torch_match import OPEN, PICK, _maps

    blobs = [(2, 5, x, x + 3, 1, 4, PICK, 0.6 + 0.05 * k)
             for k, x in enumerate((2, 10, 20, 30, 40))]
    blobs += [(15, 19, x, x + 4, 0, 5, OPEN, 0.8) for x in (2, 20, 38)]
    blobs += [(30, 34, x, x + 4, 0, 6, 0, 0.9) for x in (2, 30)]
    (jvm, tvm), _ = _maps(blobs, [])
    caps = []
    find = TR.find_all_classes

    def counted(vm, **kw):
        caps.append(kw["max_instances"])
        return find(vm, **kw)
    monkeypatch.setattr(TR, "find_all_classes", counted)
    match = dict(confidence_threshold=0.05, contour_padding=0,
                 max_instances=2)
    got = TR.walkthrough_sites(tvm, MatchConfig(**match))
    ref = JR.walkthrough_sites(jvm, JMatchConfig(**match))
    assert caps == [2, 4, 8]
    assert got.dtype == ref.dtype == np.float32
    assert got.shape == ref.shape == (8, 3)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    rngs = np.random.RandomState(9), np.random.RandomState(9)
    used = set(), set()
    for _ in range(len(got)):
        a = TR.pick_site(got, used[0], rngs[0])
        b = JR.pick_site(ref, used[1], rngs[1])
        np.testing.assert_allclose(a, b, atol=1e-5)
    assert TR.pick_site(got, used[0], rngs[0]) is None
    assert JR.pick_site(ref, used[1], rngs[1]) is None
    assert used[0] == used[1] == set(range(len(got)))
    assert rngs[0].randint(1 << 30) == rngs[1].randint(1 << 30)


# the head configurations: A, frontier walkthrough with revisit
# unshuffle; B, the conditioned policy on both phases with inhibition; C,
# one-phase with the plain policy and Gumbel-max sampling
HEADS = {
    "A": (dict(frontier_exploration=True, revisit_exploration=True), None),
    "B": (dict(frontier_exploration=True, semantic_search_walkthrough=True,
               semantic_search_unshuffle=True, policy_inhibition_radius=8),
          "policy-conditioned-multiroom"),
    "C": (dict(one_phase=True, semantic_search_unshuffle=True),
          "policy-gridworld"),
}


def _config(pkg: str, heads: dict, compat: bool = False):
    """tests/test_torch_agent.py's episode settings, budgets 2+2;
    ``compat`` adds the --reference-compat rules and an occupancy map."""
    C = _pkg(pkg)[0]
    return C.AgentConfig(
        camera=C.CameraConfig(height=48, width=48), map_height=80,
        map_width=80, map_depth=24, grid_resolution=0.125,
        nav=C.NavConfig(step_size=2, obstacle_padding=2, map_slice_start=0,
                        map_slice_stop=12, max_goal_steps=0 if compat
                        else 80, reference_compat=compat),
        navigate_on_semantic=not compat, ground_truth_segmentation=True,
        ground_truth_disagreement=True, exploration_budget_one=2,
        exploration_budget_two=2, start_task=0, total_tasks=1, **heads)


def _sampler(pkg: str, seed: int, actions: list, one_phase: bool,
             max_steps: int = 250):
    """A singleton sampler whose tasks append every action taken."""
    C, Sampler, _ = _pkg(pkg)
    sampler = Sampler([seed], camera=C.CameraConfig(height=48, width=48),
                      max_steps=max_steps, num_objects=2, num_misplaced=1,
                      num_opened=0, one_phase=one_phase)
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


def _policy(pkg: str, name):
    if name is None:
        return {}
    if pkg == "jax":
        return {"policy_params": load_orbax(name)}
    from mass_tpu_torch.search.policy import load_reference_policy
    return {"policy": load_reference_policy(pth_path(name), "cpu")}


def _episode(pkg: str, head: str, compat: bool = False, seed: int = 2,
             rng_seed: int = 0, max_steps: int = 250):
    """(results, actions) of one small episode of ``head``."""
    if pkg == "jax":
        from mass_tpu.agent.loop import RearrangementAgent
    else:
        from mass_tpu_torch.agent.loop import RearrangementAgent
    heads, policy = HEADS[head]
    actions = []
    agent = RearrangementAgent(
        _config(pkg, heads, compat),
        _sampler(pkg, seed, actions, heads.get("one_phase", False),
                 max_steps),
        rng=np.random.RandomState(rng_seed), **_pkg(pkg)[2],
        **_policy(pkg, policy))
    with jax_node_memo_held():
        return agent.run_task(0), actions


def _drift(got: dict, want: dict) -> dict:
    keys = (set(got) | set(want)) - {"timing", "fleet_timing"}
    return {k: (got.get(k), want.get(k)) for k in keys
            if got.get(k) != want.get(k)}


@pytest.mark.parametrize("head,compat", [("A", False), ("A", True),
                                         ("B", False), ("C", False)],
                         ids=["A", "A-compat", "B", "C"])
def test_head_episode_matches_jax_agent(head, compat):
    """Results and every action of a small episode equal the JAX
    agent's; the policy heads time their goals under search_policy."""
    got, got_actions = _episode("torch", head, compat)
    ref, ref_actions = _episode("jax", head, compat)
    assert got_actions == ref_actions and len(got_actions) > 20
    assert not _drift(got, ref)
    assert ("search_policy" in got["timing"]) == (head != "A")


def _checkpoint(name: str):
    return ["--policy-checkpoint", pth_path(name)]


# experiments/mr22/queue_r5.sh's flags of each committed arm
ARMS = {
    "frontier": ["--frontier-exploration"],
    "revisit": ["--frontier-exploration", "--revisit-exploration"],
    "gt": ["--ground-truth-semantic-search"],
    "cond-ihr": ["--frontier-exploration", "--semantic-search-unshuffle",
                 *_checkpoint("policy-conditioned-multiroom"),
                 "--policy-inhibition-radius", "8"],
    "plain-ihr": ["--frontier-exploration", "--semantic-search-unshuffle",
                  *_checkpoint("policy-multiroom"),
                  "--policy-inhibition-radius", "8"],
    "cond-iid": ["--frontier-exploration", "--semantic-search-unshuffle",
                 *_checkpoint("policy-conditioned-multiroom")],
}


@pytest.mark.slow
@pytest.mark.parametrize("arm", sorted(ARMS))
def test_frozen_protocol_arm_through_port(arm, tmp_path):
    """Task 0 of each committed experiments/mr22 arm, under
    tests/test_frozen_protocol.py's protocol, through the port's CLI on
    the CPU: every field but timing equals the committed record."""
    from mass_tpu_torch.agent import cli

    with open(os.path.join(REPO, "experiments", "mr22", arm, "results",
                           "0.json")) as f:
        committed = json.load(f)
    cli.main(PROTOCOL + ARMS[arm] + ["--device", "cpu", "--logdir",
                                     str(tmp_path)])
    with open(tmp_path / "results" / "0.json") as f:
        fresh = json.load(f)
    drift = {k: (committed[k], fresh.get(k)) for k in committed
             if k != "timing" and fresh.get(k) != committed[k]}
    assert not drift
