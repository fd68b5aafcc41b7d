"""The port's multi-map splat (ops/splat.py: sorted_records_multi,
splat_onehot_multi_reference, apply_records_multi) held against the JAX
package's Pallas multi-map kernel in interpret mode and its XLA
per-map path (atol 1e-5), and against the port's own single-map splat
bit for bit.  The CUDA kernel runs only on a card: its test is in
``tests/test_torch_gpu.py``.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mass_tpu.config import MapGeometry as JMapGeometry
from mass_tpu.core import geometry as JG
from mass_tpu.core.voxelmap import VoxelMap as JVoxelMap
from mass_tpu.core.voxelmap import apply_onehot_group as japply_group
from mass_tpu.ops import pallas_splat as PS
from mass_tpu.ops.scatter import corner_contributions
from mass_tpu_torch.ops import splat as SP
from tests import reference_impl as R
from tests.test_torch_splat import _kernel_emulation

# the JAX splat tests' geometry (tests/test_pallas_splat.py): V = 2048,
# one SPAN, so the Pallas kernels run in interpret mode
GEO = JMapGeometry(map_height=32, map_width=16, map_depth=4,
                   feature_size=6, grid_resolution=0.2, layout="cmajor")
CAM = dict(h=9, w=11, f=7.0)
N = CAM["h"] * CAM["w"]
ATOL = 1e-5
# (features, EMA weight) per map: occupancy first, as the agent's group
GROUPS = {2: ((1, 0.5), (6, 0.25)),
          3: ((1, 0.5), (6, 0.25), (6, 0.75)),
          4: ((1, 0.5), (6, 0.25), (3, 0.5), (6, 0.125))}


def _t(a):
    return torch.tensor(np.asarray(a))


def _group(seed, num_maps):
    """One random frame binned by the JAX package and M maps of random
    values with random classes, as numpy (maps voxel-major)."""
    rng = np.random.RandomState(seed)
    vm = JVoxelMap.create(GEO, (0.0, 0.0, 0.0))
    rays = R.ref_camera_rays(CAM["h"], CAM["w"], CAM["f"], CAM["f"])
    depth = rng.uniform(0.05, 2.2, (CAM["h"], CAM["w"], 1)).astype(
        np.float32)
    depth[0, 0, 0] = 50.0  # some invalid pixels
    oriented = JG.orient_rays(jnp.asarray(rays),
                              np.float32(rng.uniform(-np.pi, np.pi)),
                              np.float32(rng.uniform(-0.8, 0.2)))
    pts = JG.bin_rays(vm.bins_x, vm.bins_y, vm.bins_z,
                      jnp.asarray(rng.uniform(-0.3, 0.3, 3).astype(
                          np.float32)), oriented, jnp.asarray(depth))
    ids, w = corner_contributions(
        pts, (GEO.map_height, GEO.map_width, GEO.map_depth))
    feats = [f for f, _ in GROUPS[num_maps]]
    datas = [rng.rand(GEO.num_voxels, f).astype(np.float32) for f in feats]
    classes = [rng.randint(0, f, N).astype(np.int32) for f in feats]
    return np.asarray(ids), np.asarray(w), datas, classes


@pytest.mark.parametrize("num_maps", [2, 3, 4])
def test_plain_multi_matches_pallas_and_xla(num_maps):
    """The port's plain multi splat == mass_tpu's Pallas multi-map kernel
    (interpret mode; its packed class sort admits up to four maps of
    F < 256 here) and its XLA per-map group path, each map with its own
    EMA weight."""
    ids, w, datas, classes = _group(num_maps, num_maps)
    iws = tuple(iw for _, iw in GROUPS[num_maps])
    pallas = PS.splat_onehot_multi_cmajor(
        tuple(jnp.asarray(d.T.copy()) for d in datas), jnp.asarray(ids),
        jnp.asarray(w), tuple(jnp.asarray(c) for c in classes), iws,
        interpret=True)
    jvms = [JVoxelMap.create(dataclasses.replace(
        GEO, feature_size=d.shape[1], interpolation_weight=iw),
        (0.0, 0.0, 0.0)) for d, iw in zip(datas, iws)]
    jvms = [vm.with_grid(jnp.asarray(d.reshape(32, 16, 4, -1)))
            for vm, d in zip(jvms, datas)]
    xla = japply_group(jvms, jnp.asarray(ids), jnp.asarray(w),
                       [jnp.asarray(c) for c in classes], use_kernel=False)
    before = (SP.LAUNCHES, SP.MULTI_LAUNCHES)
    out = SP.splat_onehot_multi([_t(d) for d in datas], _t(ids), _t(w),
                                [_t(c) for c in classes], iws)
    assert (SP.LAUNCHES, SP.MULTI_LAUNCHES) == before  # CPU: plain version
    for m, d in enumerate(datas):
        got = out[m].numpy()
        assert np.abs(got - d).max() > 0
        np.testing.assert_allclose(got, np.asarray(pallas[m]).T, atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(
            got, np.asarray(xla[m].grid()).reshape(got.shape), atol=ATOL,
            rtol=0)


@pytest.mark.parametrize("num_maps", [2, 3, 4])
def test_plain_multi_is_per_map_single_splat(num_maps):
    """Sorted once, each map of the group equals the single-map plain
    splat on its own classes bit for bit (the sums and their order are
    the same), and the sort equals sorted_records for every map."""
    ids, w, datas, classes = _group(10 + num_maps, num_maps)
    iws = [iw for _, iw in GROUPS[num_maps]]
    records = SP.sorted_records_multi(_t(ids), _t(w),
                                      [_t(c) for c in classes])
    assert records.classes.shape == (num_maps, ids.shape[0])
    out = SP.apply_records_multi([_t(d) for d in datas], records, iws)
    for m, (d, c, iw) in enumerate(zip(datas, classes, iws)):
        single = SP.sorted_records(_t(ids), _t(w), _t(c))
        for name in ("ids", "weights"):
            assert torch.equal(getattr(records, name), getattr(single, name))
        assert torch.equal(records.classes[m], single.classes)
        want = SP.splat_onehot(_t(d), _t(ids), _t(w), _t(c), iw)
        assert torch.equal(out[m], want)


@pytest.mark.parametrize("num_maps", [1, 5])
def test_multi_splat_takes_two_to_four_maps(num_maps):
    """One map goes through the single-map splat and more than four
    exceed the kernel's limit: the multi-map wrapper refuses both on the
    CPU as on the card, and leaves the maps untouched."""
    ids, w, datas, classes = _group(30, 4)
    datas = [datas[m % 4] for m in range(num_maps)]
    classes = [classes[m % 4] for m in range(num_maps)]
    maps = [_t(d) for d in datas]
    with pytest.raises(ValueError, match="2-4 maps"):
        SP.splat_onehot_multi(maps, _t(ids), _t(w),
                              [_t(c) for c in classes], [0.5] * num_maps)
    for got, d in zip(maps, datas):
        np.testing.assert_array_equal(got.numpy(), d)


def test_out_of_range_class_dropped_for_its_map_only():
    """A class outside [0, F_m) adds nothing to map m's T (its weight
    still counts in W and S2) and leaves the other maps untouched; the
    JAX package's 8-bit packing would carry a bad id into the next map's
    bits instead."""
    ids, w, datas, classes = _group(20, 3)
    iws = [iw for _, iw in GROUPS[3]]
    bad = classes[1].copy()
    bad[3], bad[40], bad[77] = 6, -1, 300
    clean = SP.splat_onehot_multi([_t(d) for d in datas], _t(ids), _t(w),
                                  [_t(c) for c in classes], iws)
    dirty = SP.splat_onehot_multi(
        [_t(d) for d in datas], _t(ids), _t(w),
        [_t(classes[0]), _t(bad), _t(classes[2])], iws)
    assert torch.equal(dirty[0], clean[0])
    assert torch.equal(dirty[2], clean[2])
    assert not torch.equal(dirty[1], clean[1])
    records = SP.sorted_records(_t(ids), _t(w), _t(bad))
    np.testing.assert_array_equal(
        dirty[1].numpy(), _kernel_emulation(datas[1], records, iws[1]))


def test_mapset_group_is_one_multi_splat():
    """Occupancy (F = 1) and semantic maps share one camera and grid
    signature, so MapSet.update_group sorts once and splats both in one
    multi-map call per frame; the maps equal mass_tpu's group update."""
    from mass_tpu.config import CameraConfig as JCamera
    from mass_tpu.maps import MapSet as JMapSet
    from mass_tpu.maps import OccupancyMap as JOccupancyMap
    from mass_tpu.maps import SemanticMap as JSemanticMap
    from mass_tpu_torch.config import CameraConfig
    from mass_tpu_torch.maps import MapSet, OccupancyMap, SemanticMap

    cam, geo = 9, dict(map_height=32, map_width=16, map_depth=4,
                       grid_resolution=0.2)
    origin = (0.13, -0.4, 0.2)
    jmaps = JMapSet(occupancy=JOccupancyMap(JCamera(height=cam, width=cam),
                                            **geo),
                    semantic0=JSemanticMap(JCamera(height=cam, width=cam),
                                           54, **geo))
    tmaps = MapSet(occupancy=OccupancyMap(CameraConfig(height=cam,
                                                       width=cam),
                                          device="cpu", **geo),
                   semantic0=SemanticMap(CameraConfig(height=cam, width=cam),
                                         54, device="cpu", **geo))
    jmaps.reset_all(origin)
    tmaps.reset_all(origin)
    calls = []
    real = SP.apply_records_multi, SP.sorted_records_multi

    def counted(datas, *args):
        calls.append([tuple(d.shape) for d in datas])
        return real[0](datas, *args)

    def sorted_once(*args):
        calls.append("sort")
        return real[1](*args)
    rng = np.random.RandomState(8)
    SP.apply_records_multi, SP.sorted_records_multi = counted, sorted_once
    try:
        for _ in range(3):
            obs = dict(depth=rng.uniform(0.05, 2.2, (cam, cam, 1)).astype(
                np.float32), position=(np.asarray(origin) + rng.uniform(
                    -0.3, 0.3, 3)).astype(np.float32),
                yaw=np.float32(rng.uniform(-np.pi, np.pi)),
                elevation=np.float32(rng.uniform(-0.8, 0.2)),
                semantic=rng.randint(0, 54, (cam, cam, 1)))
            jmaps.update_group(["occupancy", "semantic0"], dict(obs))
            tmaps.update_group(["occupancy", "semantic0"], dict(obs))
    finally:
        SP.apply_records_multi, SP.sorted_records_multi = real
    assert calls == ["sort", [(2048, 1), (2048, 54)]] * 3
    for name in ("occupancy", "semantic0"):
        ref = np.asarray(jmaps[name].voxel_map.grid())
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(tmaps[name].voxel_map.grid().numpy(),
                                   ref, atol=ATOL, rtol=0)
