"""The port's row-sharded maps (mass_tpu_torch/parallel/sharding.py,
mesh.py, episodes.py, and ``mesh=`` in maps/layers.py and
parallel/fleet.py) against tests/test_sharding.py's cases, the JAX side
on the 8 virtual CPU devices of tests/conftest.py and the port's slabs
on ``["cpu"] * n``: a sharded map equals the port's unsharded map bit for
bit, and JAX's sharded map within 1e-5 (the two packages sum in other
orders), with one splat call a slab; a sharded small episode equals the
unsharded one on every result but ``timing``."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mass_tpu.config import CameraConfig as JCameraConfig
from mass_tpu.config import MapGeometry as JMapGeometry
from mass_tpu.core.voxelmap import VoxelMap as JVoxelMap
from mass_tpu.parallel import make_mesh as jmake_mesh
from mass_tpu.parallel import shard_voxelmap as jshard_voxelmap
from mass_tpu.parallel import sharded_update_fn as jsharded_update_fn
from mass_tpu_torch import convert
from mass_tpu_torch.config import CameraConfig, MapGeometry
from mass_tpu_torch.core.voxelmap import VoxelMap
from mass_tpu_torch.ops import splat as SP
from mass_tpu_torch.parallel import (BatchedMapper, make_mesh,
                                     shard_voxelmap, sharded_update_fn)
from mass_tpu_torch.parallel.mesh import DeviceMesh
from mass_tpu_torch.parallel.sharding import ShardedVoxelMap
from tests import reference_impl as R
from tests.torch_one_thread import one_thread  # noqa: F401

GEO = dict(map_height=32, map_width=20, map_depth=8, feature_size=3,
           grid_resolution=0.1)
CAM = dict(h=9, w=11, f=7.0)
ATOL = 1e-5


def _rays():
    return R.ref_camera_rays(CAM["h"], CAM["w"], CAM["f"], CAM["f"])


def _frames(n, rng):
    """tests/test_sharding.py's frames: (depth, features, position, yaw,
    elevation)."""
    out = []
    for _ in range(n):
        out.append((
            rng.uniform(0.05, 1.6, (CAM["h"], CAM["w"], 1)).astype(
                np.float32),
            rng.uniform(0, 1, (CAM["h"], CAM["w"], 3)).astype(np.float32),
            rng.uniform(-0.3, 0.3, 3).astype(np.float32),
            np.float32(rng.uniform(-np.pi, np.pi)),
            np.float32(rng.uniform(-0.8, 0.2))))
    return out


def _cpu_mesh(*sizes, names=("map",)):
    return make_mesh(sizes, names, ["cpu"] * int(np.prod(sizes)))


def _t(x):
    return torch.from_numpy(np.asarray(x))


class _Calls:
    """Counts the calls of an ``ops/splat`` wrapper (on the CPU each
    takes the plain version: one a slab)."""

    def __init__(self, monkeypatch, name):
        self.count = 0
        inner = getattr(SP, name)

        def counted(*args, **kw):
            self.count += 1
            return inner(*args, **kw)
        monkeypatch.setattr(SP, name, counted)


@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_update_matches_single_device(n_shards, monkeypatch):
    """Dense features into a map of n slabs: bit for bit the port's
    unsharded map, within 1e-5 of JAX's sharded map; one dense splat a
    slab a frame."""
    jgeo = JMapGeometry(layout="vmajor", **GEO)
    jmesh = jmake_mesh((n_shards,), ("map",))
    jvm = jshard_voxelmap(JVoxelMap.create(jgeo, (0.1, -0.2, 0.0)), jmesh)
    jupdate = jsharded_update_fn(jmesh, jgeo)
    geo = MapGeometry(**GEO)
    mesh = _cpu_mesh(n_shards)
    ref = VoxelMap.create(geo, (0.1, -0.2, 0.0), device="cpu")
    vm = shard_voxelmap(VoxelMap.create(geo, (0.1, -0.2, 0.0),
                                        device="cpu"), mesh)
    update = sharded_update_fn(mesh, geo)
    assert [s.shape for _, s in vm.slabs()] == \
        [(geo.num_voxels // n_shards, 3)] * n_shards
    rays = _rays()
    calls = _Calls(monkeypatch, "apply_dense_records")
    frames = _frames(3, np.random.RandomState(11))
    for depth, feats, pos, yaw, elev in frames:
        jvm = jupdate(jvm, jnp.asarray(rays), jnp.asarray(pos), yaw, elev,
                      jnp.asarray(depth), jnp.asarray(feats))
        args = (_t(rays), _t(pos), float(yaw), float(elev), _t(depth),
                _t(feats))
        ref.update(*args)
        assert update(vm, *args) is vm
    assert calls.count == len(frames) * (n_shards + 1)
    assert torch.equal(vm.grid(), ref.grid())
    np.testing.assert_allclose(vm.grid().numpy(), np.asarray(jvm.grid()),
                               atol=ATOL)
    assert ref.data.any()


@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_onehot_matches_single_device(n_shards, monkeypatch):
    """Class images into a map of n slabs (JAX's channel-major case):
    bit for bit the unsharded map, within 1e-5 of JAX's; one single-map
    splat a slab a frame; the row-local reads equal the unsharded ones."""
    shape = dict(map_height=32, map_width=16, map_depth=8, feature_size=5,
                 grid_resolution=0.1)
    jgeo = JMapGeometry(layout="cmajor", **shape)
    jmesh = jmake_mesh((n_shards,), ("map",))
    jvm = jshard_voxelmap(JVoxelMap.create(jgeo, (0.1, -0.2, 0.0)), jmesh)
    jupdate = jsharded_update_fn(jmesh, jgeo, onehot=True)
    geo = MapGeometry(**shape)
    ref = VoxelMap.create(geo, (0.1, -0.2, 0.0), device="cpu")
    vm = ShardedVoxelMap.create(geo, ["cpu"] * n_shards, (0.1, -0.2, 0.0))
    update = sharded_update_fn(_cpu_mesh(n_shards), geo, onehot=True)
    rays = _rays()
    calls = _Calls(monkeypatch, "apply_records")
    rng = np.random.RandomState(3)
    for depth, _, pos, yaw, elev in _frames(3, rng):
        classes = rng.randint(0, 5, (CAM["h"], CAM["w"])).astype(np.int32)
        jvm = jupdate(jvm, jnp.asarray(rays), jnp.asarray(pos), yaw, elev,
                      jnp.asarray(depth), jnp.asarray(classes))
        args = (_t(rays), _t(pos), float(yaw), float(elev), _t(depth),
                _t(classes))
        ref.update_classes(*args)
        update(vm, *args)
    assert calls.count == 3 * (n_shards + 1)
    assert torch.equal(vm.grid(), ref.grid())
    np.testing.assert_allclose(vm.grid().numpy(), np.asarray(jvm.grid()),
                               atol=ATOL)
    assert ref.data.any()
    for read in (lambda m: m.top_down(0, 8), lambda m: m.max_over_depth(),
                 lambda m: m.occupancy_mask(2, 6, 0.1)):
        assert torch.equal(read(vm), read(ref))


def test_reads_of_slabs_that_cut_rows():
    """Slabs that hold part of a map row (V/n not a multiple of W*D): the
    row-local reads fall back to the gathered grid and still equal the
    unsharded map's; ``pieces`` are views of the slabs a range crosses;
    ``zero_voxels`` clears across slabs."""
    from mass_tpu_torch.nav import grid as NG

    geo = MapGeometry(map_height=5, map_width=4, map_depth=2,
                      feature_size=3, grid_resolution=0.25)
    ref = VoxelMap.create(geo, device="cpu")
    ref.data.copy_(torch.rand(ref.data.shape,
                              generator=torch.Generator().manual_seed(0)))
    ref.data[ref.data < 0.6] = 0
    vm = shard_voxelmap(ref, _cpu_mesh(4))
    assert [first for first, _ in vm.slabs()] == [0, 10, 20, 30]
    for read in (lambda m: m.top_down(0, 2), lambda m: m.max_over_depth(),
                 lambda m: m.occupancy_mask(0, 2, 0.5),
                 lambda m: NG.frontier_mass(m, 1, padding=0, z_stop=2)):
        assert torch.equal(read(vm), read(ref))
    inside, = vm.pieces(11, 19)
    assert inside._base is vm.slab_data[1]
    assert torch.equal(inside, ref.data[11:19])
    across = vm.pieces(7, 23)
    assert [p._base is s for p, s in zip(across, vm.slab_data)] == [True] * 3
    assert torch.equal(torch.cat(across), ref.data[7:23])
    vm.zero_voxels(7, 23)
    ref.data[7:23] = 0
    assert torch.equal(vm.grid(), ref.grid())


def test_data_parallel_batch_of_maps():
    """tests/test_sharding.py's episode batch over ``data`` with map rows
    over ``map``: each of 4 maps on one ``data`` row of a (2, 4) mesh, cut
    over its four ``map`` devices; bit for bit the unsharded maps, within
    1e-5 of JAX's vmapped update on the sharded batch."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    jgeo = JMapGeometry(layout="vmajor", **GEO)
    jmesh = jmake_mesh((2, 4), ("data", "map"))
    rays = _rays()
    b = 4
    frames = _frames(b, np.random.RandomState(12))
    depth, feats, pos, yaw, elev = (np.stack([f[i] for f in frames])
                                    for i in range(5))

    def single(data, p, y, e, d, f):
        vm = JVoxelMap.create(jgeo, (0.0, 0.0, 0.0))
        vm = JVoxelMap(data=data, bins_x=vm.bins_x, bins_y=vm.bins_y,
                       bins_z=vm.bins_z, geometry=jgeo)
        return vm.update(jnp.asarray(rays), p, y, e, d, f).data

    data0 = jax.device_put(jnp.zeros((b, jgeo.num_voxels, 3)),
                           NamedSharding(jmesh, P("data", "map", None)))
    want = np.asarray(jax.jit(jax.vmap(single))(
        data0, jnp.asarray(pos), jnp.asarray(yaw), jnp.asarray(elev),
        jnp.asarray(depth), jnp.asarray(feats)))

    geo = MapGeometry(**GEO)
    mesh = _cpu_mesh(2, 4, names=("data", "map"))
    for i in range(b):
        vm = ShardedVoxelMap.create(geo, list(mesh.devices[i // 2]))
        ref = VoxelMap.create(geo, device="cpu")
        args = (_t(rays), _t(pos[i]), float(yaw[i]), float(elev[i]),
                _t(depth[i]), _t(feats[i]))
        vm.update(*args)
        ref.update(*args)
        assert torch.equal(vm.grid(), ref.grid())
        np.testing.assert_allclose(vm.grid().reshape(-1, 3).numpy(),
                                   want[i], atol=ATOL)
    assert want.any()


def test_batched_mapper_matches_single_episodes(monkeypatch):
    """BatchedMapper over a (2, 4) mesh against JAX's over its (2, 4)
    mesh (within 1e-5) and against per-episode single-map updates (bit
    for bit); one single-map splat a slab a step."""
    from mass_tpu.parallel import BatchedMapper as JBatchedMapper

    shape = dict(map_height=32, map_width=20, map_depth=8, feature_size=5,
                 grid_resolution=0.1)
    vfov = math.degrees(2 * math.atan(CAM["h"] / 2 / CAM["f"]))
    b = 4
    jmapper = JBatchedMapper(
        b, JCameraConfig(height=CAM["h"], width=CAM["w"],
                         vertical_fov_degrees=vfov),
        JMapGeometry(layout="vmajor", **shape),
        mesh=jmake_mesh((2, 4), ("data", "map")))
    geo = MapGeometry(**shape)
    cam = CameraConfig(height=CAM["h"], width=CAM["w"],
                       vertical_fov_degrees=vfov)
    mapper = BatchedMapper(b, cam, geo,
                           mesh=_cpu_mesh(2, 4, names=("data", "map")))
    origins = np.asarray([[0.1 * i, -0.05 * i, 0.0] for i in range(b)],
                         np.float32)
    for i in range(b):
        jmapper.reset(i, origins[i])
        mapper.reset(i, origins[i])
    singles = [VoxelMap.create(geo, tuple(origins[i]), device="cpu")
               for i in range(b)]
    calls = _Calls(monkeypatch, "apply_records")
    rng = np.random.RandomState(3)
    for _ in range(2):
        frames = _frames(b, rng)
        depth = np.stack([f[0] for f in frames])
        classes = rng.randint(0, 5, (b, CAM["h"], CAM["w"]))
        pos = np.stack([f[2] for f in frames])
        yaw = np.stack([f[3] for f in frames])
        elev = np.stack([f[4] for f in frames])
        jmapper.step(pos, yaw, elev, depth, classes)
        before = calls.count
        mapper.step(pos, yaw, elev, depth, classes)
        assert calls.count - before == 8
        for i in range(b):
            singles[i].update_classes(
                mapper.rays, _t(pos[i]), float(yaw[i]), float(elev[i]),
                _t(depth[i]), _t(classes[i].astype(np.int32)))
    for i in range(b):
        got = mapper.voxel_map(i).grid()
        assert torch.equal(got, singles[i].grid())
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jmapper.voxel_map(i).grid()),
                                   atol=ATOL)
        assert got.any()
    np.testing.assert_allclose(mapper.top_down(0, 8).numpy(),
                               np.asarray(jmapper.top_down(0, 8)),
                               atol=ATOL)


def test_sharded_map_layers_replay_parity(monkeypatch):
    """MapSet layers with ``mesh=`` (4 slabs) reproduce the unsharded
    layers bit for bit and JAX's sharded layers within 1e-5 on one
    observation stream, the semantic + occupancy pair in one multi-map
    splat a slab; the planner's navigable area is exactly equal."""
    from mass_tpu.maps import MapSet as JMapSet
    from mass_tpu.maps import OccupancyMap as JOccupancyMap
    from mass_tpu.maps import SemanticMap as JSemanticMap
    from mass_tpu.nav import grid as JNG
    from mass_tpu_torch.maps import MapSet, OccupancyMap, SemanticMap
    from mass_tpu_torch.nav import grid as NG

    geo_kw = dict(map_height=24, map_width=20, map_depth=8,
                  grid_resolution=0.25)
    jmesh = jmake_mesh((4,), ("map",))
    jcam = JCameraConfig(height=12, width=12)
    jmaps = JMapSet(semantic0=JSemanticMap(jcam, 7, mesh=jmesh, **geo_kw),
                    occupancy=JOccupancyMap(jcam, mesh=jmesh, **geo_kw))
    cam = CameraConfig(height=12, width=12)
    mesh = _cpu_mesh(4)

    def build(**kw):
        return MapSet(semantic0=SemanticMap(cam, 7, **kw, **geo_kw),
                      occupancy=OccupancyMap(cam, **kw, **geo_kw))

    plain, sharded = build(device="cpu"), build(mesh=mesh)
    assert isinstance(sharded["semantic0"].voxel_map, ShardedVoxelMap)
    rng = np.random.RandomState(7)
    for maps in (plain, sharded, jmaps):
        maps.reset_all((0.3, -0.1, 0.0))
    calls = _Calls(monkeypatch, "apply_records_multi")
    for _ in range(3):
        obs = dict(
            position=rng.uniform(-0.5, 0.5, 3).astype(np.float32),
            yaw=np.float32(rng.uniform(-np.pi, np.pi)),
            elevation=np.float32(rng.uniform(-0.5, 0.1)),
            depth=rng.uniform(0.2, 2.5, (12, 12, 1)).astype(np.float32),
            semantic=rng.randint(0, 7, (12, 12, 1)))
        for maps in (plain, sharded, jmaps):
            maps.update_group(["semantic0", "occupancy"], obs)
    assert calls.count == 3 * (1 + 4)
    for name in ("semantic0", "occupancy"):
        got = sharded[name].voxel_map.grid()
        assert torch.equal(got, plain[name].voxel_map.grid())
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jmaps[name].voxel_map.grid()),
            atol=ATOL)
        assert got.any()
    nav = NG.navigable_area(sharded["semantic0"].voxel_map, padding=1,
                            z_start=0, z_stop=8)
    assert torch.equal(nav, NG.navigable_area(
        plain["semantic0"].voxel_map, padding=1, z_start=0, z_stop=8))
    np.testing.assert_array_equal(nav.numpy(), np.asarray(
        JNG.navigable_area(jmaps["semantic0"].voxel_map, padding=1,
                           z_start=0, z_stop=8)))


@pytest.mark.parametrize("batch,n_shards", [(3, 4), (4, 2)])
def test_fleet_sharded_slab_matches(batch, n_shards, monkeypatch):
    """FleetMaps with ``mesh=`` through updates (one multi-map splat a
    slab), a masked step and a mid-life reset: every episode's view bit
    for bit the unsharded fleet's, and within 1e-5 of JAX's sharded
    fleet (tests/test_sharding.py's case, B = 3 over 4 devices).  With
    B = 3 over 4 slabs episodes cross slabs and ``view`` holds views of
    two slabs' pieces; with B = 4 over 2 each view is a view of its slab.
    Either way the row-local reads equal the unsharded fleet's."""
    from mass_tpu.parallel.fleet import FleetMaps as JFleetMaps
    from mass_tpu_torch.parallel.fleet import FleetMaps

    shape = dict(map_height=16, map_width=12, map_depth=4,
                 grid_resolution=0.25)
    fams = {"semantic0": 6, "occupancy": 1}
    jfleet = JFleetMaps(batch, JCameraConfig(height=10, width=10),
                        JMapGeometry(**shape), fams,
                        mesh=jmake_mesh((n_shards,), ("map",)))
    cam, geo = CameraConfig(height=10, width=10), MapGeometry(**shape)
    plain = FleetMaps(batch, cam, geo, fams, device="cpu")
    sharded = FleetMaps(batch, cam, geo, fams, mesh=_cpu_mesh(n_shards))
    assert len(sharded.buffers["semantic0"]) == n_shards
    fleets = (plain, sharded, jfleet)
    for fleet in fleets:
        for e in range(batch):
            fleet.reset(e, (0.1 * e, -0.05 * e, 0.0))
    calls = _Calls(monkeypatch, "apply_records_multi")
    rng = np.random.RandomState(5)
    for step in range(3):
        pos = rng.uniform(-0.4, 0.4, (batch, 3)).astype(np.float32)
        yaw = rng.uniform(-np.pi, np.pi, batch).astype(np.float32)
        elev = rng.uniform(-0.5, 0.0, batch).astype(np.float32)
        depth = rng.uniform(0.2, 2.0, (batch, 10, 10, 1)).astype(np.float32)
        cls = rng.randint(0, 6, (batch, 10, 10)).astype(np.int32)
        active = None if step != 1 else {
            name: np.arange(batch) != k for k, name in enumerate(fams)}
        for fleet in fleets:
            fleet.update_batch(pos, yaw, elev, depth, {"semantic0": cls},
                               active=active)
    assert calls.count == 2 * (1 + n_shards)
    for fleet in fleets:
        fleet.reset(1, (0.3, 0.0, 0.0))
    for name in fams:
        for e in range(batch):
            got = sharded.view(name, e)
            assert torch.equal(got.grid(), plain.view(name, e).grid())
            np.testing.assert_allclose(
                got.grid().numpy(), np.asarray(jfleet.view(name, e).grid()),
                atol=ATOL)
            assert torch.equal(got.bins_x, plain.bins_x[e])
            for read in (lambda m: m.occupancy_mask(0, 4, 0.1),
                         lambda m: m.top_down(0, 4)):
                assert torch.equal(read(got), read(plain.view(name, e)))
            slab_rows = sharded.buffers[name][0].shape[0]
            V = geo.num_voxels
            k = e * V // slab_rows
            inside = (e + 1) * V <= (k + 1) * slab_rows
            assert len(got.slab_data) == (1 if inside else 2)
            assert all(p._base is sharded.buffers[name][k + i]
                       for i, p in enumerate(got.slab_data))
    assert inside == (batch % n_shards == 0)
    assert plain.view("semantic0", 0).grid().any()
    assert not sharded.view("semantic0", 1).grid().any()


def test_mesh_and_divisibility_errors():
    """The JAX package's rules, each failure naming its numbers: the
    voxels (a fleet's B*V rows) divide over the mesh axis; a mesh never
    takes more CUDA devices than are present, nor mixes device kinds."""
    from mass_tpu_torch.maps import SemanticMap

    geo = MapGeometry(map_height=5, map_width=4, map_depth=2,
                      feature_size=3)
    with pytest.raises(ValueError, match="num_voxels 40 must divide over "
                                         "the 3-device 'map' axis"):
        ShardedVoxelMap.create(geo, ["cpu"] * 3)
    with pytest.raises(ValueError, match="num_voxels 40 must divide over "
                                         "the 3-device 'map' axis"):
        shard_voxelmap(VoxelMap.create(geo, device="cpu"), _cpu_mesh(3))
    with pytest.raises(ValueError, match="num_voxels 40 must divide"):
        SemanticMap(CameraConfig(height=4, width=4), 3, mesh=_cpu_mesh(3),
                    map_height=5, map_width=4, map_depth=2)
    present = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"mesh of {present + 1} CUDA "
                                         f"devices requested, {present} "
                                         "available"):
        make_mesh((present + 1,), ("map",))
    with pytest.raises(ValueError, match=f"mesh devices \\['cuda:{present}'"
                                         f"\\] requested, {present} CUDA "
                                         "devices present"):
        make_mesh((1,), ("map",), [f"cuda:{present}"])
    with pytest.raises(ValueError, match="of one kind"):
        DeviceMesh(np.asarray([torch.device("cpu"), torch.device("meta")],
                              dtype=object), ("map",))
    with pytest.raises(ValueError, match="mesh of 9 devices requested, 8 "
                                         "available"):
        make_mesh((9,), ("map",), ["cpu"] * 8)


@pytest.mark.parametrize("n,data", [(1, None), (2, None), (4, None),
                                    (8, None), (8, 4)])
def test_data_map_mesh_matches_jax(n, data):
    """``data_map_mesh``'s default split of n devices into (data, map)
    is JAX's, and its devices are the list's first n in order."""
    from mass_tpu.parallel.mesh import data_map_mesh as jdata_map_mesh
    from mass_tpu_torch.parallel.mesh import data_map_mesh

    want = jdata_map_mesh(n, data)
    got = data_map_mesh(n, data, devices=["cpu"] * 8)
    assert got.shape == dict(want.shape)
    assert got.axis_devices(("data", "map")) == [torch.device("cpu")] * n
    assert got.axis_devices("map") == [torch.device("cpu")] * \
        want.shape["map"]


def test_convert_carries_a_jax_sharded_map_across():
    """A JAX row-sharded map's state through numpy into the port's
    sharded map (slabs of the gathered array), and back."""
    jgeo = JMapGeometry(layout="vmajor", **GEO)
    jmesh = jmake_mesh((4,), ("map",))
    jvm = jshard_voxelmap(JVoxelMap.create(jgeo, (0.1, -0.2, 0.0)), jmesh)
    depth, feats, pos, yaw, elev = _frames(1, np.random.RandomState(2))[0]
    jvm = jsharded_update_fn(jmesh, jgeo)(
        jvm, jnp.asarray(_rays()), jnp.asarray(pos), yaw, elev,
        jnp.asarray(depth), jnp.asarray(feats))
    vm = convert.voxelmap_from_jax(
        np.asarray(jvm.data), np.asarray(jvm.bins_x), np.asarray(jvm.bins_y),
        np.asarray(jvm.bins_z), MapGeometry(**GEO), mesh=_cpu_mesh(4))
    assert isinstance(vm, ShardedVoxelMap) and len(vm.slab_data) == 4
    np.testing.assert_array_equal(vm.grid().numpy(), np.asarray(jvm.grid()))
    back = convert.voxelmap_to_numpy(vm)
    np.testing.assert_array_equal(back["data"], np.asarray(jvm.data))
    np.testing.assert_array_equal(back["bins_y"], np.asarray(jvm.bins_y))


def _episode_config(pkg: str, shards: int):
    """tests/test_sharding.py's small GT episode (80x80x24, camera 24)."""
    if pkg == "jax":
        from mass_tpu.config import (AgentConfig, CameraConfig as C,
                                     MatchConfig, NavConfig)
    else:
        from mass_tpu_torch.config import (AgentConfig, CameraConfig as C,
                                           MatchConfig, NavConfig)
    return AgentConfig(
        camera=C(height=24, width=24), map_height=80, map_width=80,
        map_depth=24, grid_resolution=0.125,
        nav=NavConfig(step_size=2, obstacle_padding=2, map_slice_start=0,
                      map_slice_stop=12, graph_update_interval=5,
                      max_goal_steps=40),
        match=MatchConfig(contour_padding=0, confidence_threshold=0.1,
                          distance_threshold=0.2, max_instances=8),
        ground_truth_segmentation=True, ground_truth_disagreement=True,
        ground_truth_semantic_search=True, exploration_budget_one=2,
        exploration_budget_two=2, shard_map=shards)


def _port_episode(shards: int, mesh=None):
    from mass_tpu_torch.agent.loop import RearrangementAgent
    from mass_tpu_torch.env.rearrange import GridWorldTaskSampler

    cfg = _episode_config("torch", shards)
    sampler = GridWorldTaskSampler([2], camera=cfg.camera, max_steps=200,
                                   num_objects=2, num_misplaced=1,
                                   num_opened=0)
    agent = RearrangementAgent(cfg, sampler, rng=np.random.RandomState(0),
                               device=None if mesh else "cpu", mesh=mesh)
    results = agent.run_task(0)
    grids = {name: agent.maps[name].voxel_map.grid()
             for name in ("semantic0", "semantic1")}
    return results, grids, agent


def test_sharded_episode_matches_unsharded(monkeypatch):
    """The small GT episode with its maps in 4 slabs (a prebuilt CPU
    mesh, as chip_smoke.py builds one on a card) equals the unsharded
    port episode on every result but ``timing``, and its maps bit for
    bit; each map update made one splat a slab."""
    plain, plain_grids, _ = _port_episode(0)
    calls = _Calls(monkeypatch, "apply_records")
    sharded, grids, agent = _port_episode(0, mesh=_cpu_mesh(4))
    assert isinstance(agent.maps["semantic1"].voxel_map, ShardedVoxelMap)
    assert agent.device == torch.device("cpu")
    assert calls.count == 4 * sharded["timing"]["mapping"]["count"] > 0

    def outcome(r):
        return {k: v for k, v in r.items() if k != "timing"}
    assert outcome(sharded) == outcome(plain)
    for name, grid in grids.items():
        assert torch.equal(grid, plain_grids[name]), name
    assert plain_grids["semantic0"].any()


def test_shard_map_builds_the_cpu_mesh():
    """``config.shard_map`` N on a CPU agent: N slabs on the CPU (the
    JAX package's ``make_mesh((N,), ("map",))``); a grid whose voxels do
    not divide by N stops the agent, naming both numbers."""
    from mass_tpu_torch.agent.loop import RearrangementAgent

    agent = RearrangementAgent(_episode_config("torch", 4), sampler=None,
                               device="cpu")
    vm = agent.maps["semantic0"].voxel_map
    assert agent.mesh.shape == {"map": 4}
    assert vm.devices == [torch.device("cpu")] * 4
    with pytest.raises(ValueError, match="num_voxels 153600 must divide "
                                         "over the 7-device 'map' axis"):
        RearrangementAgent(_episode_config("torch", 7), sampler=None,
                           device="cpu")


@pytest.mark.slow
def test_sharded_episode_matches_jax_sharded():
    """The same episode with ``shard_map=4`` in both packages (JAX on 4
    of its virtual CPU devices): equal outcome, maps within JAX's own
    sharded-against-unsharded tolerance (2e-4)."""
    from mass_tpu.agent.loop import RearrangementAgent as JAgent
    from mass_tpu.env.rearrange import GridWorldTaskSampler as JSampler

    cfg = _episode_config("jax", 4)
    jagent = JAgent(cfg, JSampler([2], camera=cfg.camera, max_steps=200,
                                  num_objects=2, num_misplaced=1,
                                  num_opened=0),
                    rng=np.random.RandomState(0))
    want = jagent.run_task(0)
    got, grids, _ = _port_episode(4)
    for key in ("unshuffle/prop_fixed", "unshuffle/ep_length",
                "unshuffle/num_initially_misplaced", "unshuffle/success",
                "walkthrough/observed_cells", "unshuffle/observed_cells"):
        assert got[key] == want[key], key
    for name, grid in grids.items():
        np.testing.assert_allclose(
            grid.numpy(), np.asarray(jagent.maps[name].voxel_map.grid()),
            atol=2e-4, err_msg=name)
