"""The port's fleet maps (parallel/fleet.py) and batched planner
(nav/grid.plan_batch) held against the JAX package's FleetMaps and
plan_batch (voxel values atol 1e-5, as the two sum in different orders;
integers exact), and against the port's per-episode map updates,
binning and plans (bit for bit).  The CUDA path runs only on a card:
its tests are in ``tests/test_torch_gpu.py``."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mass_tpu.config import CameraConfig as JCameraConfig
from mass_tpu.config import MapGeometry as JMapGeometry
from mass_tpu.core.voxelmap import VoxelMap as JVoxelMap
from mass_tpu.nav import grid as JNG
from mass_tpu.parallel.fleet import FleetMaps as JFleetMaps
from mass_tpu_torch.config import CameraConfig, MapGeometry
from mass_tpu_torch.core import voxelmap as VM
from mass_tpu_torch.nav import grid as TNG
from mass_tpu_torch.parallel import fleet as TF
from mass_tpu_torch.parallel.mesh import make_mesh

# tests/test_fleet.py's settings, each episode on a grid of its own
CAM = 12
GEO = dict(map_height=24, map_width=24, map_depth=8, grid_resolution=0.25)
B = 3
ORIGINS = [(2.0, 2.0, 0.8), (2.25, 1.7, 0.8), (1.6, 2.4, 0.7)]
FAMILIES = {"semantic0": 54, "occupancy": 1}
ATOL = 1e-5


def _frames(seed, batch=B):
    """tests/test_fleet.py's frames, with a second class image."""
    rng = np.random.RandomState(seed)
    return dict(
        positions=rng.uniform(-0.4, 0.4, (batch, 3)).astype(np.float32)
        + np.asarray([[2.0, 2.0, 0.8]], np.float32),
        yaws=rng.uniform(-np.pi, np.pi, batch).astype(np.float32),
        elevations=rng.uniform(-0.6, 0.0, batch).astype(np.float32),
        depths=rng.uniform(0.2, 3.0, (batch, CAM, CAM, 1)).astype(
            np.float32),
        classes={name: rng.randint(0, 54, (batch, CAM, CAM)).astype(
            np.int32) for name in ("semantic0", "semantic1")})


def _port_fleet(families=FAMILIES):
    fleet = TF.FleetMaps(B, CameraConfig(height=CAM, width=CAM),
                         MapGeometry(**GEO), families, device="cpu")
    for e in range(B):
        fleet.reset(e, ORIGINS[e])
    return fleet


def _jax_fleet(families=FAMILIES):
    fleet = JFleetMaps(B, JCameraConfig(height=CAM, width=CAM),
                       JMapGeometry(layout="vmajor", **GEO), families)
    for e in range(B):
        fleet.reset(e, ORIGINS[e])
    return fleet


def _slabs(fleet, name):
    return [np.asarray(fleet.view(name, e).data) for e in range(B)]


MASKS = {"semantic0": np.asarray([True, False, True]),
         "occupancy": np.asarray([False, True, True])}


@pytest.mark.parametrize("case", ["unmasked", "masked", "reset", "discard"])
def test_fleet_matches_jax_fleet(case):
    """The same steps through both packages' FleetMaps: every episode's
    slab and bins agree (atol 1e-5); masked-out slabs stay zero, a reset
    zeroes only its episode, and an all-invalid frame writes nothing
    into any slab."""
    port, ref = _port_fleet(), _jax_fleet()
    active = MASKS if case == "masked" else None
    frames = [_frames(s) for s in range(3)]
    if case == "discard":
        frames[0]["depths"][0, :, :, 0] = 50.0      # out of range
        frames = frames[:1]
    for step, fr in enumerate(frames):
        if case == "reset" and step == 2:
            before = [_slabs(port, "semantic0")[e] for e in (0, 2)]
            for fleet in (port, ref):
                fleet.reset(1, (5.0, 5.0, 1.0))
            after = _slabs(port, "semantic0")
            assert not after[1].any()
            for e, b in zip((0, 2), before):
                np.testing.assert_array_equal(after[e], b)
            assert port.bins_epoch(1) == 2 and port.bins_epoch(0) == 1
        for fleet in (port, ref):
            fleet.update_batch(**fr, active=active)
    for name in FAMILIES:
        for e, (got, want) in enumerate(zip(_slabs(port, name),
                                            _slabs(ref, name))):
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=0,
                                       err_msg=f"{case} {name}[{e}]")
            off = active is not None and not active[name][e]
            assert got.any() != off or (case == "discard" and e == 0)
        for axis in ("x", "y", "z"):
            np.testing.assert_array_equal(
                getattr(port, f"bins_{axis}").numpy(),
                np.asarray(getattr(ref, f"bins_{axis}")))
    if case == "discard":
        assert not _slabs(port, "semantic0")[0].any()
        assert _slabs(port, "semantic0")[1].any()


THREE = {"semantic0": 54, "semantic1": 54, "occupancy": 1}
T, F = True, False


@pytest.mark.parametrize("active,groups", [
    (None, [[54, 54, 1]]),
    # the compat fleet's phases: phase one (semantic0 + occupancy) and
    # phase two (semantic1)
    ({"semantic0": [T, T, F], "occupancy": [T, T, F],
      "semantic1": [F, F, T]}, [[54, 1], [54]]),
    # every episode in phase one: semantic1 is not splatted
    ({"semantic0": [T, T, T], "occupancy": [T, T, T],
      "semantic1": [F, F, F]}, [[54, 1]]),
    ({"semantic0": [T, F, T], "occupancy": [F, T, T],
      "semantic1": [T, T, F]}, [[54], [54], [1]]),
], ids=["unmasked", "two-phases", "one-phase", "all-masks-differ"])
def test_fleet_equals_per_episode_updates(active, groups, monkeypatch):
    """Two steps of a three-family fleet equal, bit for bit, each
    episode's own VoxelMap.update_classes of the families it updates;
    families with equal masks share one sort and one splat (``groups``:
    the channel counts of each splat's maps), and a family no episode
    updates is not splatted."""
    splats = []
    apply = TF.apply_onehot_group

    def counted(vms, *args):
        splats.append([vm.data.shape[1] for vm in vms])
        return apply(vms, *args)
    monkeypatch.setattr(TF, "apply_onehot_group", counted)
    fleet = _port_fleet(THREE)
    singles = {name: [VM.VoxelMap.create(MapGeometry(feature_size=f, **GEO),
                                         ORIGINS[e], device="cpu")
                      for e in range(B)] for name, f in THREE.items()}
    masks = None if active is None else {
        k: np.asarray(v) for k, v in active.items()}
    for step in range(2):
        fr = _frames(10 + step)
        fleet.update_batch(**fr, active=masks)
        for name, maps in singles.items():
            for e, vm in enumerate(maps):
                if masks is not None and not masks[name][e]:
                    continue
                cls = fr["classes"].get(name, np.zeros((B, CAM, CAM),
                                                       np.int32))[e]
                vm.update_classes(fleet.rays,
                                  torch.from_numpy(fr["positions"][e]),
                                  float(fr["yaws"][e]),
                                  float(fr["elevations"][e]),
                                  torch.from_numpy(fr["depths"][e]),
                                  torch.from_numpy(cls))
    for name, maps in singles.items():
        for e, vm in enumerate(maps):
            got = fleet.view(name, e).data
            assert torch.equal(got, vm.data), (name, e)
            assert bool(got.any()) == (masks is None or masks[name][e])
    assert splats == groups * 2


def test_batched_binning_is_per_episode_contributions():
    """The fleet's binning (B frames, each against its own grid's bins,
    one batch) equals each episode's own one-frame contributions bit for
    bit."""
    fleet = _port_fleet()
    fr = _frames(4)
    geometry = fleet.view("semantic0", 0).geometry
    ids, weights = VM.contributions_frames(
        fleet.rays, (fleet.bins_x, fleet.bins_y, fleet.bins_z), geometry,
        torch.from_numpy(fr["positions"]), fr["yaws"], fr["elevations"],
        torch.from_numpy(fr["depths"]))
    assert ids.shape == (B, 8 * CAM * CAM)
    for e in range(B):
        vm = fleet.view("semantic0", e)
        want = vm.contributions(fleet.rays,
                                torch.from_numpy(fr["positions"][e]),
                                float(fr["yaws"][e]),
                                float(fr["elevations"][e]),
                                torch.from_numpy(fr["depths"][e]))
        assert torch.equal(ids[e], want[0])
        assert torch.equal(weights[e], want[1])
        assert (want[0] < geometry.num_voxels).any()
    # the grids differ, so the episodes' cells do too
    assert not torch.equal(fleet.bins_x[0], fleet.bins_x[1])


def test_fleet_views_are_views():
    """An episode's map is rows e*V:(e+1)*V of its family's buffer and
    its bins are rows of the fleet's bins: views, no copies."""
    fleet = _port_fleet()
    V = fleet.episode_voxels
    buf = fleet.buffers["semantic0"]
    vm = fleet.view("semantic0", 2)
    assert vm.data.shape == (V, 54)
    assert vm.data.data_ptr() == buf.data_ptr() + 2 * V * 54 * 4
    vm.data[0, 3] = 7.0
    assert buf[2 * V, 3] == 7.0
    assert vm.bins_x.data_ptr() == fleet.bins_x[2].data_ptr()
    assert vm.geometry.feature_size == 54 and vm.geometry.num_voxels == V


@pytest.mark.parametrize("kwargs,match", [
    ({"mesh": make_mesh((5,), ("map",), ["cpu"] * 5)},
     "fleet slab rows 13824 must divide over the 5-device 'map' axis"),
    ({"dense_sizes": {"feature0": 256}}, "need a backbone")])
def test_fleet_maps_refuse_later_slices(kwargs, match):
    """Row-sharded buffers need their B*V rows to divide over the mesh
    axis (the JAX package's rule, named with both numbers); dense feature
    families need the backbone that feeds them."""
    with pytest.raises(ValueError, match=match):
        TF.FleetMaps(B, CameraConfig(height=CAM, width=CAM),
                     MapGeometry(**GEO), FAMILIES, device="cpu", **kwargs)


# ----------------------------------------------------------------------
# the batched planner
# ----------------------------------------------------------------------

PLAN = dict(step=2, padding=1, z_start=0, z_stop=6, threshold=0.0)


def _planning_inputs(seed=30):
    """A port fleet after two steps, each episode's occupancy mesh with
    a few nodes pruned, agents and goals around the episodes' origins,
    and collision evidence."""
    fleet = _port_fleet()
    for s in range(2):
        fleet.update_batch(**_frames(seed + s))
    rng = np.random.RandomState(seed)
    vms = [fleet.view("occupancy", e) for e in range(B)]
    grids = []
    for e, vm in enumerate(vms):
        nav = TNG.navigable_area(vm, padding=1, z_start=0, z_stop=6)
        g = TNG.build_nav_grid(nav, e % 2, 1 - e % 2, step=2)
        pruned = torch.from_numpy(rng.rand(*g.alive.shape) > 0.9)
        grids.append(g._replace(alive=g.alive & ~pruned, pruned=pruned))
    agents = (np.asarray(ORIGINS, np.float32)
              + rng.uniform(-1.0, 1.0, (B, 3)).astype(np.float32))
    goals = (np.asarray(ORIGINS, np.float32)
             + rng.uniform(-2.5, 2.5, (B, 3)).astype(np.float32))
    blocked = rng.rand(B, GEO["map_height"], GEO["map_width"]) > 0.95
    return vms, grids, agents, goals, blocked


def _jax_inputs(vms, grids):
    """The same maps and meshes as JAX pytrees."""
    jvms = [dataclasses.replace(
        JVoxelMap.create(JMapGeometry(layout="vmajor", feature_size=1, **GEO)),
        data=jnp.asarray(vm.data.numpy()), bins_x=jnp.asarray(vm.bins_x),
        bins_y=jnp.asarray(vm.bins_y), bins_z=jnp.asarray(vm.bins_z))
        for vm in vms]
    jgrids = [JNG.NavGrid(*(jnp.asarray(np.asarray(x)) for x in g))
              for g in grids]
    return jvms, jgrids


def _assert_plans_equal(batched, singles):
    for e, single in enumerate(singles):
        got_grid, want_grid = batched[0], single[0]
        for name in ("alive", "edge_right", "edge_down", "pruned"):
            np.testing.assert_array_equal(
                np.asarray(getattr(got_grid, name)[e]),
                np.asarray(getattr(want_grid, name)), err_msg=(e, name))
        for k, (got, want) in enumerate(zip(batched[1:], single[1:])):
            np.testing.assert_array_equal(np.asarray(got[e]),
                                          np.asarray(want),
                                          err_msg=f"episode {e} output {k}")


@pytest.mark.parametrize("refresh", [True, False])
def test_plan_batch_matches_jax_plan_batch(refresh):
    """plan_batch over the fleet's views equals JAX's plan_batch on the
    same maps and meshes: meshes, fields, snaps and cells exactly."""
    vms, grids, agents, goals, _ = _planning_inputs()
    got = TNG.plan_batch(TNG.stack_grids(grids), vms,
                         torch.from_numpy(agents), torch.from_numpy(goals),
                         refresh=refresh, **PLAN)
    jvms, jgrids = _jax_inputs(vms, grids)
    stack = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jgrids)
    jstack = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jvms)
    ref = JNG.plan_batch(stack, jstack, jnp.asarray(agents),
                         jnp.asarray(goals), refresh=refresh, **PLAN)
    for name in ("alive", "edge_right", "edge_down", "pruned"):
        np.testing.assert_array_equal(getattr(got[0], name).numpy(),
                                      np.asarray(getattr(ref[0], name)))
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (got[1] < TNG.INF).any()


@pytest.mark.parametrize("refresh,monotone,with_blocked", [
    (True, False, False), (True, False, True), (True, True, True),
    (False, True, False)])
def test_plan_batch_matches_per_episode_plans(refresh, monotone,
                                              with_blocked):
    """plan_batch equals each episode's own plan in the port and in the
    JAX package, with the monotone rule and collision evidence; and the
    batch's host copy equals each plan's own."""
    vms, grids, agents, goals, blocked = _planning_inputs(seed=40)
    kw = dict(PLAN, refresh=refresh, monotone=monotone)
    ev = torch.from_numpy(blocked) if with_blocked else None
    got = TNG.plan_batch(TNG.stack_grids(grids), vms,
                         torch.from_numpy(agents), torch.from_numpy(goals),
                         blocked=ev, **kw)
    singles = [TNG.plan(g, vm, torch.from_numpy(a), torch.from_numpy(gl),
                        blocked=None if ev is None else ev[e], **kw)
               for e, (g, vm, a, gl) in enumerate(zip(grids, vms, agents,
                                                      goals))]
    _assert_plans_equal(got, singles)
    jvms, jgrids = _jax_inputs(vms, grids)
    refs = [JNG.plan(g, vm, jnp.asarray(a), jnp.asarray(gl),
                     blocked=None if ev is None else jnp.asarray(blocked[e]),
                     **kw)
            for e, (g, vm, a, gl) in enumerate(zip(jgrids, jvms, agents,
                                                   goals))]
    _assert_plans_equal(got, refs)
    host = TNG.plan_to_host(*got[:4])
    for e, single in enumerate(singles):
        for a, b in zip(host, TNG.plan_to_host(*single[:4])):
            np.testing.assert_array_equal(a[e], b)
