"""The port's trajectory replay (``mass_tpu_torch.env.replay``) against
the JAX package's on the CPU: the cases of ``tests/test_replay.py`` on
the port, each beside the JAX function on the same episode, and the two
packages' digests of one capture.  Frames, streams, poses and actions are
exact; map sums and maxima agree within rtol 1e-5 (the splat's summation
order), and the maps themselves within atol 1e-5 voxel by voxel.  The
non-zero counts can differ by voxels that hold a lone 1e-9-weight
corner: the port's strict float32 geometry and XLA's (which contracts
products into fused multiply-adds under ``jit``) can put a corner in
neighbouring voxels, and a capture's maps stay at the origin while the
agent walks past their edge, where records are clamped (ROADMAP.md
queue 3, geometry precision)."""

import numpy as np
import pytest

from mass_tpu.env import replay as JR
from mass_tpu.env.rearrange import GridWorldTaskSampler as JSampler
from mass_tpu.config import CameraConfig as JCamera
from mass_tpu_torch import taxonomy
from mass_tpu_torch.config import CameraConfig, NavConfig
from mass_tpu_torch.convert import voxelmap_to_numpy
from mass_tpu_torch.env import replay as R
from mass_tpu_torch.env.rearrange import GridWorldTaskSampler
from mass_tpu_torch.env.replay import ReplayTask, TrajectoryRecorder
from mass_tpu_torch.maps import MapSet, SemanticMap
from mass_tpu_torch.nav.controller import NavigationController
from tests.torch_one_thread import one_thread  # noqa: F401

CAM = CameraConfig(height=32, width=32)
GEO = dict(map_height=64, map_width=64, map_depth=16,
           grid_resolution=0.125)
GEO_FLAGS = ["--camera-size", "32", "--map-height", "64",
             "--map-width", "64", "--map-depth", "16",
             "--grid-resolution", "0.125", "--ground-truth-segmentation"]
MAP_RTOL = 1e-5


def _controller(task):
    maps = MapSet(semantic0=SemanticMap(CAM, taxonomy.NUM_CLASSES,
                                        device="cpu", **GEO))
    loc = task.agent_location()
    maps.reset_all((loc.x, loc.z, loc.y))
    controller = NavigationController(
        task, "semantic0", maps,
        NavConfig(step_size=2, obstacle_padding=1, map_slice_start=0,
                  map_slice_stop=8), rng=np.random.RandomState(0))
    return maps, controller


def _drive(task, steps=30):
    """Deterministic rollout folding frames into a semantic map (the JAX
    test's ``_drive``); returns the map's [V, F] data and the actions."""
    maps, controller = _controller(task)
    names = task.action_names()
    pattern = [names.index("move_ahead")] * 3 + \
        [names.index("rotate_left")]
    taken = []
    for i in range(steps):
        obs = task.get_observations()
        controller.process_observations(obs, update_map=["semantic0"])
        action = pattern[i % len(pattern)]
        task.step(action)
        taken.append(action)
    obs = task.get_observations()
    controller.process_observations(obs, update_map=["semantic0"])
    return voxelmap_to_numpy(maps["semantic0"].voxel_map)["data"], taken


def test_record_then_replay_reproduces_map(tmp_path):
    """A live episode recorded by the port replays into the same map, and
    the port's capture equals the JAX recorder's capture of the same
    episode frame for frame."""
    from tests.test_replay import _drive as jax_drive

    rec = TrajectoryRecorder(GridWorldTaskSampler([7], camera=CAM)
                             .next_task())
    live_map, actions = _drive(rec)
    path = rec.save(str(tmp_path / "episode.npz"))

    replay = ReplayTask(path)
    assert len(replay) == len(actions)
    replay_map, _ = _drive(replay, steps=len(actions))
    np.testing.assert_array_equal(replay_map, live_map)
    assert float(live_map.sum()) > 0

    jrec = JR.TrajectoryRecorder(JSampler([7], camera=JCamera(32, 32))
                                 .next_task())
    jax_map, jax_actions = jax_drive(jrec)
    assert jax_actions == actions
    jpath = jrec.save(str(tmp_path / "jax.npz"))
    assert R.diff_captures(path, jpath) == []
    assert JR.diff_captures(jpath, path) == []
    want = np.asarray(jax_map)
    if want.shape != live_map.shape:    # JAX's channel-major [Fpad, V]
        want = want[:taxonomy.NUM_CLASSES].T
    np.testing.assert_allclose(live_map, want, atol=1e-5)


def test_replay_strict_divergence(tmp_path):
    sampler = GridWorldTaskSampler([7], camera=CAM)
    rec = TrajectoryRecorder(sampler.next_task())
    names = rec.action_names()
    rec.get_observations()
    rec.step(names.index("move_ahead"))
    rec.step(names.index("rotate_left"))
    path = rec.save(str(tmp_path / "e.npz"))

    replay = ReplayTask(path)
    replay.step(names.index("move_ahead"))          # matches
    with pytest.raises(ValueError, match="divergence"):
        replay.step(names.index("move_ahead"))      # recorded: rotate
    loose = ReplayTask(path, strict=False)
    assert loose.step(names.index("done")).action_success in (True,
                                                              False)
    # the JAX package's replay of the port's file diverges alike
    jreplay = JR.ReplayTask(path)
    jreplay.step(names.index("move_ahead"))
    with pytest.raises(ValueError, match="divergence"):
        jreplay.step(names.index("move_ahead"))


def _digests_agree(got, want):
    """Port and JAX digests of one capture: everything but the maps'
    statistics exact, map sums and maxima within ``MAP_RTOL``."""
    assert set(got) == set(want)
    for key in ("frames", "frame_keys", "streams", "poses_sum", "actions"):
        assert got[key] == want[key], key
    for name in ("map_occupancy", "map_semantic"):
        for stat in ("sum", "max"):
            np.testing.assert_allclose(got[name][stat], want[name][stat],
                                       rtol=MAP_RTOL, err_msg=name)


def test_capture_verify_diff_cli(tmp_path, capsys):
    """capture -> digest -> diff through the port's entry point, the grid
    world standing in for THOR; the port's capture equals the JAX
    package's and its digest agrees with JAX's."""
    out_a = str(tmp_path / "a.npz")
    out_b = str(tmp_path / "b.npz")
    R.main(["capture", "--out", out_a, "--frames", "12"] + GEO_FLAGS)
    R.main(["capture", "--out", out_b, "--frames", "12"] + GEO_FLAGS)
    capsys.readouterr()

    # identical seeds and script -> identical captures
    assert R.diff_captures(out_a, out_b) == []
    R.main(["diff", out_a, out_b])
    assert "IDENTICAL" in capsys.readouterr().out

    flags = GEO_FLAGS + ["--device", "cpu"]
    d1 = R.replay_digest(out_a, flags)
    d2 = R.replay_digest(out_b, flags)
    assert d1 == d2
    assert d1["map_semantic"]["nonzero"] > 0
    assert d1["map_occupancy"]["sum"] > 0
    assert len(d1["actions"]) == 12

    out_j = str(tmp_path / "jax.npz")
    JR.main(["capture", "--out", out_j, "--frames", "12",
             "--platform", "cpu"] + GEO_FLAGS)
    capsys.readouterr()
    assert R.diff_captures(out_a, out_j) == []
    _digests_agree(d1, JR.replay_digest(out_j, GEO_FLAGS))

    # a different scene diverges loudly, in the capture and the digest
    out_c = str(tmp_path / "c.npz")
    R.main(["capture", "--out", out_c, "--frames", "12",
            "--start-task", "3"] + GEO_FLAGS)
    capsys.readouterr()
    assert R.diff_captures(out_a, out_c) != []
    d3 = R.replay_digest(out_c, flags)
    assert d3["streams"]["semantic"] != d1["streams"]["semantic"]


def test_pose_to_map_args_matches_controller():
    """The replay pose transform is the port controller's bit for bit,
    and the JAX package's."""
    task = GridWorldTaskSampler([7], camera=CAM).next_task()
    _, controller = _controller(task)
    for action in ("move_ahead", "rotate_left", "look_down", "crouch"):
        pose = task.agent_location()
        position, yaw, elevation = R.pose_to_map_args(pose)
        np.testing.assert_array_equal(position,
                                      controller.process_position())
        assert yaw == controller.process_yaw()
        assert elevation == controller.process_elevation()
        jpos, jyaw, jelev = JR.pose_to_map_args(pose)
        np.testing.assert_array_equal(position, jpos)
        assert (yaw, elevation) == (jyaw, jelev)
        if action in task.action_names():
            task.step(task.action_names().index(action))


def test_replay_pose_and_done_streams(tmp_path):
    sampler = GridWorldTaskSampler([7], camera=CAM)
    live = sampler.next_task()
    rec = TrajectoryRecorder(live)
    names = rec.action_names()
    p0 = rec.agent_location()
    rec.get_observations()
    rec.step(names.index("move_ahead"))
    p1_live = live.agent_location()
    path = rec.save(str(tmp_path / "e.npz"))

    for replay in (ReplayTask(path), JR.ReplayTask(path)):
        assert not replay.is_done()
        r0 = replay.agent_location()
        assert (r0.x, r0.z, r0.rotation_degrees) == (p0.x, p0.z,
                                                     p0.rotation_degrees)
        replay.step(names.index("move_ahead"))
        r1 = replay.agent_location()
        assert (r1.x, r1.z) == (p1_live.x, p1_live.z)
        assert not replay.is_done()


def test_digest_matches_jax_on_one_capture(tmp_path):
    """One 40-frame capture at camera 48 into 80x80x24 maps at 0.125 m:
    the port's digest on the CPU against the JAX package's, its maps
    against JAX's voxel by voxel, and two single-map updates a frame (the
    occupancy and the semantic map, each on its own)."""
    import mass_tpu.maps.layers as JL
    from mass_tpu_torch.maps import layers as L

    flags = ["--camera-size", "48", "--map-height", "80", "--map-width",
             "80", "--map-depth", "24", "--grid-resolution", "0.125",
             "--ground-truth-segmentation", "--start-task", "2"]
    path = str(tmp_path / "ep.npz")
    R.main(["capture", "--out", path, "--frames", "39"] + flags)
    calls, maps, jax_maps = [], {}, {}
    update_group = L.MapSet.update_group

    def counted(layers, names, observation):
        calls.append(tuple(names))
        maps.update(layers)
        return update_group(layers, names, observation)
    updates = {cls: cls.update_from_observation
               for cls in (JL.OccupancyMap, JL.SemanticMap)}

    def held(cls, name):
        def update(layer, observation):
            jax_maps[name] = layer
            return updates[cls](layer, observation)
        return update
    L.MapSet.update_group = counted
    JL.OccupancyMap.update_from_observation = held(JL.OccupancyMap,
                                                   "occupancy")
    JL.SemanticMap.update_from_observation = held(JL.SemanticMap,
                                                  "semantic")
    try:
        got = R.replay_digest(path, flags + ["--device", "cpu"])
        want = JR.replay_digest(path, flags)
    finally:
        L.MapSet.update_group = update_group
        for cls, update in updates.items():
            cls.update_from_observation = update
    assert got["frames"] == 40
    assert calls == [("occupancy",), ("semantic",)] * 40
    _digests_agree(got, want)
    for name, layer in maps.items():
        port = voxelmap_to_numpy(layer.voxel_map)["data"]
        ref = np.asarray(jax_maps[name].voxel_map.data)
        if ref.shape != port.shape:     # JAX's channel-major [Fpad, V]
            ref = ref[:port.shape[1]].T
        np.testing.assert_allclose(port, ref, atol=1e-5, err_msg=name)
        assert got[f"map_{name}"]["nonzero"] > 0
