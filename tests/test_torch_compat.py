"""The --reference-compat path through the port held against the JAX
package: the CLI preset, the monotone mesh on a one-channel occupancy
map, the compat controller's decisions and prunes, and a short compat
episode (results and every action equal)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mass_tpu.nav import grid as JNG
from mass_tpu_torch.nav import grid as TNG
from tests.test_torch_agent import jax_node_memo_held

CAM = 48
GEO = dict(map_height=80, map_width=80, map_depth=24, grid_resolution=0.125)


def _t(a):
    return torch.tensor(np.asarray(a))


def _nav_config(pkg: str, **kw):
    if pkg == "jax":
        from mass_tpu.config import NavConfig
    else:
        from mass_tpu_torch.config import NavConfig
    return NavConfig(step_size=2, obstacle_padding=2, map_slice_start=0,
                     map_slice_stop=12, max_goal_steps=0,
                     reference_compat=True, **kw)


def test_cli_preset_pins_reference_behavior():
    """tests/test_reference_compat.py::test_preset_pins_reference_behavior
    on the port's CLI, and the same configuration as mass_tpu's."""
    from mass_tpu.agent import cli as jcli
    from mass_tpu_torch.agent import cli as tcli

    args = ["--reference-compat", "--logdir", "/tmp/x"]
    cfg = tcli.config_from_args(tcli.build_parser().parse_args(args))
    assert cfg.nav.reference_compat
    assert not cfg.navigate_on_semantic     # separate occupancy layer
    assert cfg.nav.max_goal_steps == 0      # only phase budgets limit
    assert cfg.navigation_map_name == "occupancy"
    ref = jcli.config_from_args(jcli.build_parser().parse_args(args))
    assert cfg.nav == _nav_like(ref.nav, cfg.nav)
    default = tcli.config_from_args(tcli.build_parser().parse_args(
        ["--logdir", "/tmp/x"]))
    assert default.navigate_on_semantic and not \
        default.nav.reference_compat
    # every flag runs on the port: --shard-map parses as mass_tpu's does
    sharded = args + ["--ground-truth-segmentation", "--shard-map", "4"]
    assert tcli.config_from_args(tcli.build_parser().parse_args(
        sharded)).shard_map == jcli.config_from_args(
        jcli.build_parser().parse_args(sharded)).shard_map == 4


def _nav_like(jax_nav, port_nav):
    """mass_tpu's NavConfig as the port's class (same field names)."""
    import dataclasses
    return type(port_nav)(**{f.name: getattr(jax_nav, f.name)
                             for f in dataclasses.fields(port_nav)})


def _occupancy_pair(seed):
    """A one-channel occupancy map in both packages, equal state."""
    from mass_tpu.config import MapGeometry as JMapGeometry
    from mass_tpu.core.voxelmap import VoxelMap as JVoxelMap
    from mass_tpu_torch import convert
    from mass_tpu_torch.config import MapGeometry

    rng = np.random.RandomState(seed)
    geo = dict(map_height=24, map_width=24, map_depth=4, feature_size=1,
               grid_resolution=0.25)
    grid = np.where(rng.rand(24, 24, 4, 1) > 0.97,
                    rng.rand(24, 24, 4, 1), 0).astype(np.float32)
    jvm = JVoxelMap.create(JMapGeometry(layout="cmajor", **geo),
                           (0.5, -0.25, 0.0)).with_grid(jnp.asarray(grid))
    tvm = convert.voxelmap_from_jax(
        np.asarray(jvm.data), np.asarray(jvm.bins_x),
        np.asarray(jvm.bins_y), np.asarray(jvm.bins_z),
        MapGeometry(**geo), device="cpu")
    return rng, jvm, tvm


def test_occupancy_navigable_area_matches_jax():
    """navigable_area on the F = 1 occupancy map (cmajor [8, V] in JAX,
    carried across by convert) equals JAX's."""
    rng, jvm, tvm = _occupancy_pair(0)
    blocked = rng.rand(24, 24) > 0.97
    for padding in (0, 2):
        for thr in (0.0, 0.5):
            ref = JNG.navigable_area(jvm, padding=padding, z_start=1,
                                     z_stop=4, obstacle_threshold=thr,
                                     blocked=jnp.asarray(blocked))
            out = TNG.navigable_area(tvm, padding=padding, z_start=1,
                                     z_stop=4, obstacle_threshold=thr,
                                     blocked=_t(blocked))
            np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
            assert not np.asarray(ref).all()


def test_monotone_plan_matches_jax():
    """plan(..., monotone=True) on a pruned mesh over the occupancy map:
    the mesh, field, snaps and cells equal JAX's, and monotone refreshes
    never resurrect a node (while the default rule may)."""
    rng, jvm, tvm = _occupancy_pair(1)
    nav = np.asarray(JNG.navigable_area(jvm, padding=1, z_start=0,
                                        z_stop=4))
    jg = JNG.build_nav_grid(jnp.asarray(nav), 1, 0, step=2)
    alive = np.asarray(jg.alive).copy()
    alive[rng.rand(*alive.shape) > 0.85] = False
    jg = jg._replace(alive=jnp.asarray(alive))
    tg = TNG.build_nav_grid(_t(nav), 1, 0, step=2)._replace(alive=_t(alive))
    kw = dict(step=2, padding=1, z_start=0, z_stop=4, threshold=0.0,
              refresh=True)
    for _ in range(4):
        agent = rng.uniform(-2.5, 3.5, 3).astype(np.float32)
        goal = rng.uniform(-2.5, 3.5, 3).astype(np.float32)
        ref = JNG.plan(jg, jvm, jnp.asarray(agent), jnp.asarray(goal),
                       monotone=True, **kw)
        out = TNG.plan(tg, tvm, _t(agent), _t(goal), monotone=True, **kw)
        for name in ("alive", "edge_right", "edge_down", "pruned"):
            np.testing.assert_array_equal(getattr(out[0], name).numpy(),
                                          np.asarray(getattr(ref[0], name)))
        for a, b in zip(out[1:], ref[1:]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert not (out[0].alive.numpy() & ~alive).any()
    fresh = TNG.plan(tg, tvm, _t(agent), _t(goal), monotone=False, **kw)
    assert (fresh[0].alive.numpy() & ~alive).any()


def _compat_controller(pkg: str):
    """A compat controller on the walkthrough of seed 2, navigating the
    occupancy map that the first frame (with semantic0) was folded into."""
    if pkg == "jax":
        from mass_tpu.config import CameraConfig
        from mass_tpu.env.rearrange import GridWorldTaskSampler
        from mass_tpu.maps import MapSet, OccupancyMap, SemanticMap
        from mass_tpu.nav.controller import NavigationController
        kw = {}
    else:
        from mass_tpu_torch.config import CameraConfig
        from mass_tpu_torch.env.rearrange import GridWorldTaskSampler
        from mass_tpu_torch.maps import MapSet, OccupancyMap, SemanticMap
        from mass_tpu_torch.nav.controller import NavigationController
        kw = {"device": "cpu"}
    cam = CameraConfig(height=CAM, width=CAM)
    task = GridWorldTaskSampler([2], camera=cam, num_objects=2,
                                num_misplaced=1, num_opened=0).next_task()
    maps = MapSet(semantic0=SemanticMap(cam, 54, **GEO, **kw),
                  occupancy=OccupancyMap(cam, **GEO, **kw))
    loc = task.agent_location()
    maps.reset_all((loc.x, loc.z, loc.y))
    ctl = NavigationController(task, "occupancy", maps, _nav_config(pkg),
                               rng=np.random.RandomState(0))
    return task, ctl


def _compat_decisions(pkg: str):
    """Actions, headings and paths of the compat rule toward fixed goals
    (one at the agent's own node, so the path collapses), then the mesh
    after a failed rotation and a failed move (each prunes a node)."""
    task, ctl = _compat_controller(pkg)
    names = task.action_names()
    here = ctl.process_position()
    out = []
    for offset in ((1.5, 0.5), (-1.0, 1.25), (0.25, -2.0), (0.0, 0.0)):
        obs = task.get_observations()
        goal = here + np.asarray([*offset, 0.0], np.float32)
        action = ctl.get_action(obs, goal,
                                update_map=["occupancy", "semantic0"])
        out.append((action, obs["heading"], np.asarray(obs["path"])))
    # the reference's shortest_path on the monotone mesh, no refresh
    out.append((None, 0.0, ctl.shortest_path(
        here, here + np.asarray([-1.5, -1.0, 0.0], np.float32))))
    obs = task.get_observations()
    ctl.get_action(obs, here + np.asarray([1.5, 0.5, 0.0], np.float32),
                   update_map=["occupancy", "semantic0"])
    ctl.failed_action(obs, names.index("rotate_left"))
    ctl.failed_action(obs, names.index("move_ahead"))
    g = ctl.nav_grid
    masks = [np.asarray(x) for x in (g.alive, g.pruned, g.edge_right,
                                     g.edge_down)]
    return out, masks, ctl.blocked_cells


def test_compat_decisions_and_failed_actions_match_jax():
    got, got_masks, got_blocked = _compat_decisions("torch")
    ref, ref_masks, ref_blocked = _compat_decisions("jax")
    assert [a for a, _, _ in got] == [a for a, _, _ in ref]
    assert got[-2][0] is None                     # collapsed path: arrive
    assert got[-1][2].shape[0] > 2
    assert any(a is not None for a, _, _ in got)
    for (_, gh, gp), (_, rh, rp) in zip(got, ref):
        assert abs(gh - rh) <= 1e-6
        np.testing.assert_allclose(gp, rp, atol=1e-6, rtol=0)
    for a, b in zip(got_masks, ref_masks):
        np.testing.assert_array_equal(a, b)
    assert got_masks[1].sum() == 2                # both failures pruned
    assert got_blocked is None and ref_blocked is None   # no evidence


def _compat_episode(pkg: str):
    """One compat episode at the verify recipe's agent settings (camera
    48, 80x80x24 at 0.125 m), budgets 1+1 and 120 steps per phase;
    returns (results, actions, the agent)."""
    if pkg == "jax":
        from mass_tpu.agent.loop import RearrangementAgent
        from mass_tpu.config import AgentConfig, CameraConfig
        from mass_tpu.env.rearrange import GridWorldTaskSampler
        extra = {}
    else:
        from mass_tpu_torch.agent.loop import RearrangementAgent
        from mass_tpu_torch.config import AgentConfig, CameraConfig
        from mass_tpu_torch.env.rearrange import GridWorldTaskSampler
        extra = {"device": "cpu"}
    cam = CameraConfig(height=CAM, width=CAM)
    cfg = AgentConfig(
        camera=cam, **GEO, nav=_nav_config(pkg),
        navigate_on_semantic=False, ground_truth_segmentation=True,
        ground_truth_disagreement=True, exploration_budget_one=1,
        exploration_budget_two=1, start_task=0, total_tasks=1)
    sampler = GridWorldTaskSampler([2], camera=cam, max_steps=120,
                                   num_objects=2, num_misplaced=1,
                                   num_opened=0)
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
        return agent.run_task(0), actions, agent


def test_compat_episode_matches_jax_agent():
    from mass_tpu_torch.ops import splat as SP

    launches = (SP.LAUNCHES, SP.MULTI_LAUNCHES)
    got, got_actions, agent = _compat_episode("torch")
    ref, ref_actions, jagent = _compat_episode("jax")
    assert (SP.LAUNCHES, SP.MULTI_LAUNCHES) == launches   # CPU: plain
    assert agent.phase_one == jagent.phase_one == ["occupancy", "semantic0"]
    assert agent.navigation_map == "occupancy"
    assert got_actions == ref_actions and len(got_actions) > 20
    drift = {k: (ref[k], got.get(k)) for k in ref
             if k != "timing" and ref[k] != got.get(k)}
    assert not drift
    assert got["timing"]["mapping"]["count"] > 0
    occ = agent.maps["occupancy"].voxel_map
    assert occ.data.shape[1] == 1 and float(occ.data.sum()) > 0
    np.testing.assert_allclose(
        occ.grid().numpy(),
        np.asarray(jagent.maps["occupancy"].voxel_map.grid()),
        atol=1e-5, rtol=0)


def test_compat_cli_runs_on_cpu(tmp_path):
    """The --reference-compat flag runs through the port's CLI with
    --device cpu and writes results."""
    from mass_tpu_torch.agent import cli

    metrics = cli.main([
        "--ground-truth-segmentation", "--ground-truth-disagreement",
        "--reference-compat", "--camera-size", "16", "--map-height", "32",
        "--map-width", "32", "--map-depth", "8", "--grid-resolution", "0.25",
        "--step-size", "1", "--obstacle-padding", "1",
        "--map-slice-start", "0", "--map-slice-stop", "4",
        "--exploration-budget-one", "1", "--exploration-budget-two", "1",
        "--max-steps", "20", "--num-objects", "2", "--num-misplaced", "1",
        "--num-opened", "0", "--total-tasks", "1", "--device", "cpu",
        "--logdir", str(tmp_path)])
    assert len(metrics) == 1
    assert (tmp_path / "results" / "0.json").exists()
    assert metrics[0]["timing"]["mapping"]["count"] > 0
