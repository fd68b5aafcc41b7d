"""The port's map rendering (``mass_tpu_torch.utils.visualization``) and
``--videos`` against the JAX package on the CPU.

The render functions take maps built from the same seeded grids in both
packages (``with_grid``): float panels agree within 1e-6 (the port takes
the L2 norm in torch's summation order), the class panels exactly.  A
small video episode hands the writer the same number of frames as JAX's,
each uint8 frame within one level of JAX's (``(frame * 255).astype``
truncates, so an ulp in a density can move a pixel by a level), and the
flag changes no result."""

import numpy as np
import pytest
import torch

from mass_tpu.core.voxelmap import VoxelMap as JVoxelMap
from mass_tpu.config import MapGeometry as JGeometry
from mass_tpu.utils import visualization as JV
from mass_tpu_torch.config import MapGeometry
from mass_tpu_torch.core.voxelmap import VoxelMap
from mass_tpu_torch.utils import visualization as V
from tests.test_torch_agent import jax_node_memo_held
from tests.torch_one_thread import one_thread  # noqa: F401

PANEL_TOL = 1e-6
ORIGIN = (1.0, -0.5, 0.75)


def _grid(seed: int, features: int, shape=(24, 20, 10)) -> np.ndarray:
    """A sparse seeded grid: about a fifth of the voxels hold values,
    some rows of them tied at their maximum (argmax takes the first)."""
    rng = np.random.RandomState(seed)
    grid = rng.rand(*shape, features).astype(np.float32)
    grid *= rng.rand(*shape, 1) < 0.2
    grid[3, 4, 2] = 0.5                      # a column of ties
    return grid


def _maps(grid: np.ndarray):
    h, w, d, f = grid.shape
    geo = dict(map_height=h, map_width=w, map_depth=d,
               grid_resolution=0.25, feature_size=f)
    jvm = JVoxelMap.create(JGeometry(**geo), ORIGIN).with_grid(grid)
    vm = VoxelMap.create(MapGeometry(**geo), ORIGIN, "cpu").with_grid(
        torch.from_numpy(grid))
    return jvm, vm


@pytest.mark.parametrize("features", [1, 54])
def test_render_occupancy_matches_jax(features):
    jvm, vm = _maps(_grid(0, features))
    path = np.asarray([[2, 3], [10, 8], [15, 18]])
    for kwargs in (dict(), dict(position_cell=np.asarray([7, 11]),
                                yaw=0.9, path_cells=path, z_start=2,
                                z_stop=8)):
        got = V.render_occupancy(vm, **kwargs)
        want = JV.render_occupancy(jvm, **kwargs)
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape == (24, 20, 3)
        np.testing.assert_allclose(got, want, atol=PANEL_TOL, rtol=0)
    empty = V.render_occupancy(VoxelMap.create(vm.geometry, device="cpu"))
    np.testing.assert_array_equal(empty, 1.0)


def test_render_semantic_matches_jax():
    jvm, vm = _maps(_grid(1, 54))
    for kwargs in (dict(), dict(z_start=1, z_stop=6,
                                boxes=[(2, 3, 5, 4), (10, 12, 6, 8)])):
        got = V.render_semantic(vm, **kwargs)
        want = JV.render_semantic(jvm, **kwargs)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_render_feature_query_matches_jax():
    jvm, vm = _maps(_grid(2, 16))
    queries = np.random.RandomState(3).randn(3, 16).astype(np.float32)
    got = V.render_feature_query(vm, queries, z_start=0, z_stop=8,
                                 temperature=10.0)
    want = JV.render_feature_query(jvm, queries, z_start=0, z_stop=8,
                                   temperature=10.0)
    assert got.shape == want.shape == (24, 20, 3)
    np.testing.assert_allclose(got, want, atol=PANEL_TOL, rtol=0)


def test_episode_frame_and_agent_match_jax():
    rgb = np.random.RandomState(4).rand(48, 48, 3).astype(np.float32)
    panels = [np.random.RandomState(5 + k).rand(24, 20, 3).astype(
        np.float32) for k in range(3)]
    np.testing.assert_array_equal(V.episode_frame(rgb, *panels),
                                  JV.episode_frame(rgb, *panels))
    a = np.ones((30, 30, 3), np.float32)
    b = a.copy()
    np.testing.assert_array_equal(V.draw_agent(a, 14.0, 9.0, 2.1),
                                  JV.draw_agent(b, 14.0, 9.0, 2.1))


class _Recorder:
    """A video writer that keeps the frames it is handed."""

    def __init__(self, sink: list):
        self.frames = sink
        self.closed = False

    def write(self, frame):
        self.frames.append(np.array(frame))

    def close(self):
        self.closed = True


def _video_episode(pkg: str, videos: bool):
    """The agent test's small episode (camera 48, 80x80x24 at 0.125 m,
    budgets 1 + 1, task 2), cut to 12 steps a phase (JAX's renders re-trace
    for every path length), with or without a recording writer; returns
    (results, frames, writers)."""
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
        exploration_budget_one=1, exploration_budget_two=1,
        start_task=0, total_tasks=1)
    frames, writers = [], []

    def factory(task_id):
        writers.append(_Recorder(frames))
        return writers[-1]
    agent = RearrangementAgent(
        cfg, GridWorldTaskSampler([2], camera=cam, max_steps=12,
                                  num_objects=2, num_misplaced=1,
                                  num_opened=0),
        rng=np.random.RandomState(0),
        video_writer_factory=factory if videos else None, **extra)
    with jax_node_memo_held():
        results = agent.run_task(2)
    return results, frames, writers


def test_video_frames_match_jax_and_change_no_result():
    got, frames, writers = _video_episode("torch", True)
    plain, none, _ = _video_episode("torch", False)
    want, jax_frames, _ = _video_episode("jax", True)
    assert none == [] and len(writers) == 1 and writers[0].closed
    assert len(frames) == len(jax_frames) > 0
    for k, (a, b) in enumerate(zip(frames, jax_frames)):
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape, k
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, k
    assert a.shape == (48, 48 * 4, 3)
    outcome = {k: v for k, v in got.items() if k != "timing"}
    assert outcome == {k: v for k, v in plain.items() if k != "timing"}
    assert outcome == {k: v for k, v in want.items() if k != "timing"}
