"""mass_tpu_torch.core.voxelmap, maps.layers and convert held against
the JAX package: voxel values to atol 1e-5, geometry to 1e-6, integer
outputs exactly."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mass_tpu.config import CameraConfig as JCamera
from mass_tpu.config import MapGeometry as JMapGeometry
from mass_tpu.core import geometry as JG
from mass_tpu.core.voxelmap import HostMapToWorld as JHost
from mass_tpu.core.voxelmap import VoxelMap as JVoxelMap
from mass_tpu.maps import MapSet as JMapSet
from mass_tpu.maps import SemanticMap as JSemanticMap
from mass_tpu_torch import convert
from mass_tpu_torch.config import CameraConfig, MapGeometry
from mass_tpu_torch.core.voxelmap import (HostMapToWorld, VoxelMap,
                                          apply_onehot_group)
from mass_tpu_torch.maps import MapSet, SemanticMap

GEO = dict(map_height=32, map_width=16, map_depth=4, feature_size=6,
           grid_resolution=0.2)
ORIGIN = (0.13, -0.4, 0.2)
CAM = 9


def _t(a):
    return torch.tensor(np.asarray(a))


def _frames(seed, n=2):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        out.append(dict(
            depth=rng.uniform(0.05, 2.2, (CAM, CAM, 1)).astype(np.float32),
            classes=rng.randint(0, GEO["feature_size"],
                                (CAM, CAM)).astype(np.int32),
            pos=(np.asarray(ORIGIN) + rng.uniform(-0.3, 0.3, 3)).astype(
                np.float32),
            yaw=np.float32(rng.uniform(-np.pi, np.pi)),
            elev=np.float32(rng.uniform(-0.8, 0.2))))
    return out


def _pair(seed=0, layout="vmajor"):
    """A JAX map and the port's map after the same two frames."""
    jgeo = JMapGeometry(layout=layout, **GEO)
    jvm = JVoxelMap.create(jgeo, ORIGIN)
    tvm = VoxelMap.create(MapGeometry(**GEO), ORIGIN, device="cpu")
    rays = np.asarray(JG.camera_rays(CAM, CAM, 7.0, 7.0))
    for fr in _frames(seed):
        jvm = jvm.update_classes(
            jnp.asarray(rays), jnp.asarray(fr["pos"]), fr["yaw"],
            fr["elev"], jnp.asarray(fr["depth"]),
            jnp.asarray(fr["classes"]))
        tvm.update_classes(_t(rays), _t(fr["pos"]), float(fr["yaw"]),
                           float(fr["elev"]), _t(fr["depth"]),
                           _t(fr["classes"]))
    return jvm, tvm


@pytest.mark.parametrize("layout", ["vmajor", "cmajor"])
def test_update_classes_matches_jax(layout):
    jvm, tvm = _pair(0, layout)
    ref = np.asarray(jvm.grid())
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(tvm.grid().numpy(), ref, atol=1e-5, rtol=0)
    for name in ("bins_x", "bins_y", "bins_z"):
        np.testing.assert_array_equal(getattr(tvm, name).numpy(),
                                      np.asarray(getattr(jvm, name)))


def test_create_reset_and_grid_round_trip():
    jvm, tvm = _pair(1)
    new_origin = (1.0, 2.0, -0.5)
    jr = jvm.reset(jnp.asarray(new_origin, jnp.float32))
    tvm.reset(new_origin)
    assert float(tvm.data.abs().max()) == 0.0
    for name in ("bins_x", "bins_y", "bins_z"):
        np.testing.assert_array_equal(getattr(tvm, name).numpy(),
                                      np.asarray(getattr(jr, name)))
    grid = np.random.RandomState(2).rand(32, 16, 4, 6).astype(np.float32)
    packed = tvm.with_grid(_t(grid))
    np.testing.assert_array_equal(packed.grid().numpy(), grid)
    np.testing.assert_array_equal(
        packed.data.numpy(), np.asarray(jr.with_grid(jnp.asarray(grid)).data))


def _same_data_pair(seed):
    """JAX map state carried into the port exactly (convert)."""
    jvm, _ = _pair(seed)
    tvm = convert.voxelmap_from_jax(
        np.asarray(jvm.data), np.asarray(jvm.bins_x), np.asarray(jvm.bins_y),
        np.asarray(jvm.bins_z), MapGeometry(**GEO), device="cpu")
    return jvm, tvm


@pytest.mark.parametrize("z", [(0, 2), (1, 4), (0, 4)])
def test_reads_match_jax(z):
    jvm, tvm = _same_data_pair(3)
    np.testing.assert_array_equal(tvm.top_down(*z).numpy(),
                                  np.asarray(jvm.top_down(*z)))
    np.testing.assert_array_equal(tvm.max_over_depth().numpy(),
                                  np.asarray(jvm.max_over_depth()))
    for thr in (0.0, 0.05):
        np.testing.assert_array_equal(
            tvm.occupancy_mask(z[0], z[1], thr).numpy(),
            np.asarray(jvm.occupancy_mask(z[0], z[1], thr)))


def test_coordinate_transforms_match_jax():
    jvm, tvm = _same_data_pair(4)
    rng = np.random.RandomState(5)
    world = rng.uniform(-4, 4, (50, 3)).astype(np.float32)
    np.testing.assert_array_equal(tvm.clamp_to_world(world).numpy(),
                                  np.asarray(jvm.clamp_to_world(world)))
    np.testing.assert_array_equal(tvm.world_to_map(world).numpy(),
                                  np.asarray(jvm.world_to_map(world)))
    np.testing.assert_array_equal(
        tvm.world_to_map(world[:, :2]).numpy(),
        np.asarray(jvm.world_to_map(world[:, :2])))
    cells = rng.uniform(-2, 34, (50, 3)).astype(np.float32)
    np.testing.assert_array_equal(tvm.clamp_to_map(cells).numpy(),
                                  np.asarray(jvm.clamp_to_map(cells)))
    np.testing.assert_allclose(tvm.map_to_world(cells).numpy(),
                               np.asarray(jvm.map_to_world(cells)),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(HostMapToWorld()(tvm, cells, epoch=0),
                               JHost()(jvm, cells, epoch=0), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("layout", ["vmajor", "cmajor"])
def test_convert_round_trips_both_layouts(layout):
    jgeo = JMapGeometry(layout=layout, **GEO)
    jvm = JVoxelMap.create(jgeo, ORIGIN)
    grid = np.random.RandomState(6).rand(32, 16, 4, 6).astype(np.float32)
    jvm = jvm.with_grid(jnp.asarray(grid))
    data = np.asarray(jvm.data)
    tvm = convert.voxelmap_from_jax(
        data, np.asarray(jvm.bins_x), np.asarray(jvm.bins_y),
        np.asarray(jvm.bins_z), MapGeometry(**GEO), device="cpu")
    np.testing.assert_array_equal(tvm.grid().numpy(), grid)
    back = convert.voxelmap_to_numpy(tvm, layout)
    np.testing.assert_array_equal(back["data"], data)
    for name in ("bins_x", "bins_y", "bins_z"):
        np.testing.assert_array_equal(back[name],
                                      np.asarray(getattr(jvm, name)))
    with pytest.raises(ValueError):
        convert.voxelmap_from_jax(data[:, :-1], back["bins_x"],
                                  back["bins_y"], back["bins_z"],
                                  MapGeometry(**GEO), device="cpu")


def test_apply_onehot_group_single_map_and_multi_raises():
    _, tvm = _pair(7)
    v = tvm.geometry.num_voxels
    before = tvm.data.clone()
    other = dataclasses.replace(tvm, data=tvm.data.clone())
    ids = torch.tensor([0, 5, 5, v, 3, 3, 9, 0])     # one pixel, 8 corners
    w = torch.tensor([0.3, 0.2, 0.5, 0.1, 0.05, 0.4, 0.25, 0.15])
    cls = torch.tensor([2])
    [out] = apply_onehot_group([tvm], ids, w, [cls])
    assert out is tvm and not torch.equal(tvm.data, before)
    assert torch.equal(tvm.data, other.apply_onehot(ids, w, cls).data)
    with pytest.raises(NotImplementedError, match="slice 2"):
        apply_onehot_group([tvm, other], ids, w, [cls, cls])


@pytest.mark.parametrize("kind", ["semantic", "occupancy"])
def test_mapset_update_group_matches_jax(kind):
    from mass_tpu.maps import OccupancyMap as JOccupancyMap
    from mass_tpu_torch.maps import OccupancyMap

    cam = dict(height=CAM, width=CAM)
    geo = {k: v for k, v in GEO.items() if k != "feature_size"}
    if kind == "semantic":
        jlayer = JSemanticMap(JCamera(**cam), 54, **geo)
        tlayer = SemanticMap(CameraConfig(**cam), 54, device="cpu", **geo)
    else:
        jlayer = JOccupancyMap(JCamera(**cam), **geo)
        tlayer = OccupancyMap(CameraConfig(**cam), device="cpu", **geo)
    jmaps, tmaps = JMapSet(layer=jlayer), MapSet(layer=tlayer)
    jmaps.reset_all(ORIGIN)
    tmaps.reset_all(ORIGIN)
    rng = np.random.RandomState(8)
    for fr in _frames(9, n=3):
        obs = dict(depth=fr["depth"], position=fr["pos"], yaw=fr["yaw"],
                   elevation=fr["elev"],
                   semantic=rng.randint(0, 54, (CAM, CAM, 1)))
        jmaps.update_group(["layer", "absent"], dict(obs))
        tmaps.update_group(["layer", "absent"], dict(obs))
    assert tmaps["layer"].bins_epoch == 1
    np.testing.assert_allclose(
        tmaps["layer"].voxel_map.grid().numpy(),
        np.asarray(jmaps["layer"].voxel_map.grid()), atol=1e-5, rtol=0)


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    """With no CUDA device, an entry point called without device= raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VoxelMap.create(MapGeometry(**GEO))
    with pytest.raises(RuntimeError, match="--device cpu"):
        SemanticMap(CameraConfig(height=CAM, width=CAM), 6)
    assert VoxelMap.create(MapGeometry(**GEO), device="cpu").data.is_cpu
