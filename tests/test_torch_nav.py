"""mass_tpu_torch.ops.pool and nav.grid held against the JAX package:
nav masks, distance fields, node indices and paths exactly; pooled
floats to 1e-6."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mass_tpu.nav import grid as JNG
from mass_tpu.ops import pool as JP
from mass_tpu_torch.nav import grid as TNG
from mass_tpu_torch.ops import pool as TP


def _t(a):
    return torch.tensor(np.asarray(a))


def _navigable(seed, h=23, w=19):
    """Rooms with walls, a door and scattered clutter."""
    rng = np.random.RandomState(seed)
    nav = rng.rand(h, w) > 0.08
    nav[:, w // 2] = False
    nav[h // 3, w // 2] = True
    nav[2 * h // 3, :] = False
    nav[2 * h // 3, 3] = True
    return nav


def _grids(nav, step, off=(1, 0)):
    j = JNG.build_nav_grid(jnp.asarray(nav), off[0], off[1], step=step)
    t = TNG.build_nav_grid(_t(nav), off[0], off[1], step=step)
    return j, t


def _assert_grid_equal(tg, jg):
    for name in ("alive", "edge_right", "edge_down", "pruned"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(jg, name)))
    assert (tg.off_x, tg.off_y) == (int(jg.off_x), int(jg.off_y))


@pytest.mark.parametrize("dtype", [np.bool_, np.int32, np.float32])
@pytest.mark.parametrize("radius", [1, 3])
def test_max_pool2d_same(dtype, radius):
    x = np.random.RandomState(0).rand(2, 13, 17)
    x = (x > 0.8).astype(dtype) if dtype == np.bool_ else \
        (x * 100).astype(dtype)
    np.testing.assert_array_equal(
        TP.max_pool2d_same(_t(x), radius).numpy(),
        np.asarray(JP.max_pool2d_same(jnp.asarray(x), radius)))


def test_avg_pool3d_same():
    x = np.random.RandomState(1).rand(2, 9, 8, 7).astype(np.float32)
    np.testing.assert_allclose(
        TP.avg_pool3d_same(_t(x), 1).numpy(),
        np.asarray(JP.avg_pool3d_same(jnp.asarray(x), 1)), atol=1e-6)


def test_navigable_area_matches_jax():
    from mass_tpu.config import MapGeometry as JMapGeometry
    from mass_tpu.core.voxelmap import VoxelMap as JVoxelMap
    from mass_tpu_torch import convert
    from mass_tpu_torch.config import MapGeometry

    rng = np.random.RandomState(2)
    geo = dict(map_height=24, map_width=20, map_depth=6, feature_size=4,
               grid_resolution=0.1)
    grid = np.where(rng.rand(24, 20, 6, 4) > 0.97,
                    rng.rand(24, 20, 6, 4), 0).astype(np.float32)
    jvm = JVoxelMap.create(JMapGeometry(**geo)).with_grid(jnp.asarray(grid))
    tvm = convert.voxelmap_from_jax(
        np.asarray(jvm.data), np.asarray(jvm.bins_x),
        np.asarray(jvm.bins_y), np.asarray(jvm.bins_z),
        MapGeometry(**geo), device="cpu")
    blocked = rng.rand(24, 20) > 0.97
    for padding in (0, 2):
        for blk in (None, blocked):
            ref = JNG.navigable_area(
                jvm, padding=padding, z_start=1, z_stop=5,
                blocked=None if blk is None else jnp.asarray(blk))
            out = TNG.navigable_area(
                tvm, padding=padding, z_start=1, z_stop=5,
                blocked=None if blk is None else _t(blk))
            np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("step", [2, 3])
def test_build_and_refresh_match_jax(step):
    nav = _navigable(3)
    jg, tg = _grids(nav, step)
    _assert_grid_equal(tg, jg)
    nav2 = _navigable(4)
    pruned = np.zeros_like(np.asarray(jg.alive))
    pruned[1, 1] = True
    jg = jg._replace(pruned=jnp.asarray(pruned))
    tg = tg._replace(pruned=_t(pruned))
    for monotone in (False, True):
        _assert_grid_equal(
            TNG.refresh_nav_grid(tg, _t(nav2), step=step, monotone=monotone),
            JNG.refresh_nav_grid(jg, jnp.asarray(nav2), step=step,
                                 monotone=monotone))


def test_distance_fields_and_paths_match_jax():
    jg, tg = _grids(_navigable(5), 2)
    ny, nx = np.asarray(jg.alive).shape
    for src in ((0, 0), (nx - 1, ny - 1), (nx // 2, 3)):
        jd = np.asarray(JNG.distance_field(jg, jnp.int32(src[0]),
                                           jnp.int32(src[1])))
        td = TNG.distance_field(tg, *src).numpy()
        np.testing.assert_array_equal(td, jd)
        reach = np.argwhere(jd < int(JNG.INF))
        for i, j in reach[::7]:
            np.testing.assert_array_equal(
                TNG.extract_path(tg._replace(
                    edge_right=tg.edge_right.numpy(),
                    edge_down=tg.edge_down.numpy()), td, (j, i), 2),
                JNG.extract_path(jg, jd, (j, i), 2))


def test_seeds_and_nearest_node_tie_order():
    jg, tg = _grids(np.ones((12, 12), bool), 2, off=(0, 0))
    dist = np.zeros(np.asarray(jg.alive).shape, np.int32)
    # (3, 3) is equidistant from four nodes: the first in row-major wins
    for cell in ((3, 3), (5, 1), (11, 11), (0, 7)):
        ref = JNG.nearest_node(jg, jnp.asarray(dist), jnp.asarray(cell), 2,
                               reachable_only=True)
        out = TNG.nearest_node(tg, _t(dist), _t(cell), 2,
                               reachable_only=True)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(
            TNG.seeds_near_cell(tg, _t(cell), 2, 4).numpy(),
            np.asarray(JNG.seeds_near_cell(jg, jnp.asarray(cell), 2, 4)))


def test_plan_matches_jax():
    from mass_tpu.config import MapGeometry as JMapGeometry
    from mass_tpu.core.voxelmap import VoxelMap as JVoxelMap
    from mass_tpu_torch import convert
    from mass_tpu_torch.config import MapGeometry

    rng = np.random.RandomState(6)
    geo = dict(map_height=24, map_width=24, map_depth=4, feature_size=3,
               grid_resolution=0.25)
    grid = np.where(rng.rand(24, 24, 4, 3) > 0.98, 1.0, 0.0).astype(
        np.float32)
    jvm = JVoxelMap.create(JMapGeometry(**geo), (0.5, -0.25, 0.0)) \
        .with_grid(jnp.asarray(grid))
    tvm = convert.voxelmap_from_jax(
        np.asarray(jvm.data), np.asarray(jvm.bins_x),
        np.asarray(jvm.bins_y), np.asarray(jvm.bins_z),
        MapGeometry(**geo), device="cpu")
    nav = np.asarray(JNG.navigable_area(jvm, padding=1, z_start=0,
                                        z_stop=4))
    jg = JNG.build_nav_grid(jnp.asarray(nav), 1, 0, step=2)
    tg = TNG.build_nav_grid(_t(nav), 1, 0, step=2)
    kw = dict(step=2, padding=1, z_start=0, z_stop=4, threshold=0.0)
    for _ in range(5):
        agent = rng.uniform(-2.5, 3.5, 3).astype(np.float32)
        goal = rng.uniform(-2.5, 3.5, 3).astype(np.float32)
        for refresh in (False, True):
            ref = JNG.plan(jg, jvm, jnp.asarray(agent), jnp.asarray(goal),
                           refresh=refresh, **kw)
            out = TNG.plan(tg, tvm, _t(agent), _t(goal), refresh=refresh,
                           **kw)
            _assert_grid_equal(out[0], ref[0])
            for a, b in zip(out[1:], ref[1:]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
