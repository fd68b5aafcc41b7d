"""The port's splat (ops/scatter.py, ops/splat.py) held against the JAX
package: corner records and sort order exactly, voxel values to atol
1e-5 (the JAX XLA path sums iw*w^2/W per record where the kernel
algebra sums T first, a few ulp apart).  The CUDA kernel itself runs only on a card: its tests
are in ``tests/test_torch_gpu.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mass_tpu.config import MapGeometry as JMapGeometry
from mass_tpu.core import geometry as JG
from mass_tpu.core.voxelmap import VoxelMap as JVoxelMap
from mass_tpu.ops import pallas_splat as PS
from mass_tpu.ops import scatter as JS
from mass_tpu_torch.core import geometry as TG
from mass_tpu_torch.ops import scatter as TS
from mass_tpu_torch.ops import splat as SP
from tests import reference_impl as R
from tests import torch_streams as TS_STREAMS
from tests.torch_streams import naive_splat

# the JAX splat tests' geometry (tests/test_pallas_splat.py)
GEO = JMapGeometry(map_height=32, map_width=16, map_depth=4,
                   feature_size=6, grid_resolution=0.2, layout="cmajor")
SIZES = (GEO.map_height, GEO.map_width, GEO.map_depth)
CAM = dict(h=9, w=11, f=7.0)
ATOL = 1e-5


def _t(a):
    return torch.tensor(np.asarray(a))


def _frame(seed):
    """One random frame binned by the JAX package, as numpy: the binned
    points, corner ids / weights and per-pixel classes."""
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
    ids, w = JS.corner_contributions(pts, SIZES)
    classes = rng.randint(0, GEO.feature_size,
                          (CAM["h"] * CAM["w"],)).astype(np.int32)
    data = rng.rand(GEO.feature_size, GEO.num_voxels).astype(np.float32)
    return pts, np.asarray(ids), np.asarray(w), classes, data


def _torch_points(pts):
    return TG.BinnedPoints(*(_t(np.asarray(x)) for x in pts))


def test_corner_contributions_match_jax():
    pts, ids, w, _, _ = _frame(0)
    t_ids, t_w = TS.corner_contributions(_torch_points(pts), SIZES)
    np.testing.assert_array_equal(t_ids.numpy(), ids)
    np.testing.assert_allclose(t_w.numpy(), w, atol=1e-6, rtol=0)
    # discard id is V, and the grid edge folds both corners onto one cell
    assert (ids == GEO.num_voxels).any()
    assert t_ids.max().item() == GEO.num_voxels


def test_corner_edge_fold():
    ind = torch.tensor([0, 3, 3])
    ratio = torch.tensor([0.2, 0.7, 0.3])
    (lo, up), (wl, wu) = TS._corner_indices_and_weights(ind, ratio, 4)
    np.testing.assert_array_equal(lo.numpy(), [0, 3, 2])
    np.testing.assert_array_equal(up.numpy(), [0, 3, 3])
    np.testing.assert_allclose((wl + wu).numpy(), [1, 1, 1], atol=1e-7)


@pytest.mark.parametrize("layout", ["cmajor", "vmajor"])
def test_xla_path_ports_match_jax(layout):
    """The port's one plain splat stands in for both of the JAX
    package's XLA blends (channel-major and voxel-major)."""
    _, ids, w, classes, data = _frame(1)
    if layout == "cmajor":
        ref = np.asarray(JS.apply_onehot_cmajor(
            jnp.asarray(data), jnp.asarray(ids), jnp.asarray(w),
            jnp.asarray(classes), 0.5)).T
    else:
        ref = np.asarray(JS.apply_onehot_vmajor(
            jnp.asarray(data.T.copy()), jnp.asarray(ids), jnp.asarray(w),
            jnp.asarray(classes), 0.5))
    out = SP.splat_onehot(_t(data.T.copy()), _t(ids), _t(w), _t(classes),
                          0.5)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def test_span_sorted_records_match_jax():
    """sorted_records orders the records as mass_tpu's span sort does:
    by voxel id, ties in record order (and, where JAX packs the class
    into the key, by class within a voxel, then record order)."""
    _, ids, w, classes, _ = _frame(2)
    records = SP.sorted_records(_t(ids), _t(w), _t(classes))
    ids_s = records.ids.numpy()
    w_s, cls_s = records.weights.numpy(), records.classes.numpy()
    for num_classes in (None, GEO.feature_size):
        ref = JS.span_sorted_records(jnp.asarray(ids), jnp.asarray(w),
                                     jnp.asarray(classes), GEO.num_voxels,
                                     256, num_classes=num_classes)
        order = (np.arange(ids_s.shape[0]) if num_classes is None
                 else np.lexsort((cls_s, ids_s)))
        np.testing.assert_array_equal(ids_s[order], np.asarray(ref[0]))
        np.testing.assert_array_equal(w_s[order], np.asarray(ref[1]))
        np.testing.assert_array_equal(cls_s[order], np.asarray(ref[2]))


def test_splat_matches_xla_path_and_pallas_kernel():
    """The port's plain splat == mass_tpu's XLA scatter path and its
    Pallas kernel in interpret mode, on the same records."""
    _, ids, w, classes, data = _frame(3)
    xla = np.asarray(JS.apply_onehot_cmajor(
        jnp.asarray(data), jnp.asarray(ids), jnp.asarray(w),
        jnp.asarray(classes), 0.5))
    pallas = np.asarray(PS.splat_onehot_cmajor(
        jnp.asarray(data), jnp.asarray(ids), jnp.asarray(w),
        jnp.asarray(classes), 0.5, interpret=True))
    launches = SP.LAUNCHES
    out = SP.splat_onehot(_t(data.T.copy()), _t(ids), _t(w), _t(classes),
                          0.5).numpy().T
    assert SP.LAUNCHES == launches      # a CPU map takes the plain version
    assert np.abs(xla - data).max() > 0
    np.testing.assert_allclose(out, xla, atol=ATOL, rtol=0)
    np.testing.assert_allclose(out, pallas, atol=ATOL, rtol=0)


def test_splat_two_updates_match_numpy_oracle():
    """Two sequential updates through the port's VoxelMap match the
    loop-based NumPy oracle of the reference semantics."""
    from mass_tpu_torch.config import MapGeometry
    from mass_tpu_torch.core.voxelmap import VoxelMap

    rng = np.random.RandomState(4)
    rays = R.ref_camera_rays(CAM["h"], CAM["w"], CAM["f"], CAM["f"])
    fmap = np.zeros(SIZES + (GEO.feature_size,), np.float32)
    bx = R.ref_bins(0.0, GEO.map_width, GEO.grid_resolution)
    by = R.ref_bins(0.0, GEO.map_height, GEO.grid_resolution)
    bz = R.ref_bins(0.0, GEO.map_depth, GEO.grid_resolution)
    geo = MapGeometry(map_height=32, map_width=16, map_depth=4,
                      feature_size=6, grid_resolution=0.2)
    vm = VoxelMap.create(geo, device="cpu")
    for _ in range(2):
        depth = rng.uniform(0.05, 2.2, (CAM["h"], CAM["w"], 1)).astype(
            np.float32)
        classes = rng.randint(0, GEO.feature_size,
                              (CAM["h"], CAM["w"])).astype(np.int32)
        pos = rng.uniform(-0.3, 0.3, 3).astype(np.float32)
        yaw = np.float32(rng.uniform(-np.pi, np.pi))
        elev = np.float32(rng.uniform(-0.6, 0.2))
        R.ref_full_update(fmap, bx, by, bz, rays, pos, yaw, elev, depth,
                          np.eye(GEO.feature_size, dtype=np.float32)[
                              classes], interpolation_weight=0.5)
        vm.update_classes(_t(rays), _t(pos), float(yaw), float(elev),
                          _t(depth), _t(classes))
    np.testing.assert_allclose(vm.grid().numpy(), fmap, atol=1e-4)


def _kernel_emulation(data, records, iw):
    """What the CUDA kernel computes, one voxel at a time in float32
    with no fused multiply-add (the kernel writes its arithmetic with
    round-to-nearest intrinsics)."""
    return naive_splat([data], records.ids.numpy(), records.weights.numpy(),
                       records.classes.numpy()[None], [iw])[0]


def test_plain_splat_is_the_kernel_arithmetic():
    """The plain version sums each run in sorted record order with the
    kernel's float32 blend: bit-identical to an emulation of the
    kernel, so a CUDA episode and a CPU episode see the same maps."""
    _, ids, w, classes, data = _frame(5)
    records = SP.sorted_records(_t(ids), _t(w), _t(classes))
    vdata = data.T.copy()
    want = _kernel_emulation(vdata, records, 0.5)
    out = SP.splat_onehot_reference(torch.tensor(vdata), records,
                                    0.5).numpy()
    np.testing.assert_array_equal(out, want)


def test_sorted_runs_stable_and_complete():
    """sorted_records is a stable sort and gathers: int32 ids, every
    record kept, weights and classes in the sorted order."""
    _, ids, w, classes, _ = _frame(6)
    records = SP.sorted_records(_t(ids), _t(w), _t(classes))
    assert records.ids.dtype == torch.int32
    order = np.argsort(ids, kind="stable")
    np.testing.assert_array_equal(records.ids.numpy(), ids[order])
    np.testing.assert_array_equal(records.weights.numpy(), w[order])
    np.testing.assert_array_equal(records.classes.numpy(),
                                  np.tile(classes, 8)[order])


@pytest.mark.parametrize("num_maps", [1, 2, 3, 4])
@pytest.mark.parametrize("name", sorted(TS_STREAMS.STREAMS))
def test_plain_splat_on_chosen_runs(name, num_maps):
    """On streams of chosen run lengths (1, 31, 32, 33 records, a run
    across a tile's end, one longer than a tile, every record in one
    voxel, only discard ids, runs of negative ids, which it skips as the
    kernels do) the plain version equals a naive float32 loop over each
    voxel's records bit for bit, for one to four maps."""
    ids, w, classes, datas = TS_STREAMS.stream(name, num_maps)
    iws = TS_STREAMS.INTERPOLATION_WEIGHTS[:num_maps]
    want = naive_splat(datas, ids, w, classes, iws)
    records = SP.Records(_t(ids), _t(w), _t(classes))
    if num_maps == 1:
        got = [SP.apply_records(_t(datas[0]), records._replace(
            classes=records.classes[0]), iws[0])]
    else:
        got = SP.apply_records_multi([_t(d) for d in datas], records, iws)
    for out, ref, data in zip(got, want, datas):
        np.testing.assert_array_equal(out.numpy(), ref)
        assert np.array_equal(ref, data) == (name == "all_invalid")
