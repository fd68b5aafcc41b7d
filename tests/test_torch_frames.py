"""The port's frames route (ops/splat.py: sorted_frame_records,
splat_onehot_frames_reference, apply_frame_records; VoxelMap.
contributions_frames and update_classes_frames) held against the JAX
package's Pallas frames kernel in interpret mode and its XLA scan path
(atol 1e-5), against T sequential port updates bit for bit, and the
plain version against a naive float32 loop on chosen sub-runs bit for
bit.  The CUDA kernel runs only on a card: its tests are in
``tests/test_torch_gpu.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mass_tpu.config import MapGeometry as JMapGeometry
from mass_tpu.core.voxelmap import VoxelMap as JVoxelMap
from mass_tpu_torch.config import MapGeometry
from mass_tpu_torch.core.voxelmap import VoxelMap
from mass_tpu_torch.ops import splat as SP
from tests import reference_impl as R
from tests import torch_streams as TS

# the JAX splat tests' geometry (tests/test_pallas_splat.py): V = 2048
GEO = dict(map_height=32, map_width=16, map_depth=4, feature_size=6,
           grid_resolution=0.2)
CAM = dict(h=9, w=11, f=7.0)
T = 3
ATOL = 1e-5


def _t(a):
    return torch.tensor(np.asarray(a))


def _frames(seed):
    """T random frames as numpy (tests/test_pallas_splat.py's draw),
    with a random starting map ``[V, F]``."""
    rng = np.random.RandomState(seed)
    return dict(
        positions=rng.uniform(-0.3, 0.3, (T, 3)).astype(np.float32),
        yaws=rng.uniform(-np.pi, np.pi, T).astype(np.float32),
        elevs=rng.uniform(-0.6, 0.2, T).astype(np.float32),
        depths=rng.uniform(0.05, 2.2,
                           (T, CAM["h"], CAM["w"], 1)).astype(np.float32),
        classes=rng.randint(0, GEO["feature_size"],
                            (T, CAM["h"], CAM["w"])).astype(np.int32),
        start=rng.rand(32, 16, 4, GEO["feature_size"]).astype(np.float32))


def _rays():
    return R.ref_camera_rays(CAM["h"], CAM["w"], CAM["f"], CAM["f"])


def _port_map(fr):
    vm = VoxelMap.create(MapGeometry(**GEO), device="cpu")
    return vm.with_grid(_t(fr["start"]))


@pytest.mark.parametrize("use_kernel", [True, False])
def test_update_classes_frames_matches_jax(use_kernel):
    """T = 3 frames through the port's frames route == mass_tpu's
    update_classes_frames: its Pallas frames kernel (interpret mode,
    cmajor) and its XLA scan path."""
    fr = _frames(0)
    jvm = JVoxelMap.create(JMapGeometry(layout="cmajor", **GEO)).with_grid(
        jnp.asarray(fr["start"]))
    jvm = jvm.update_classes_frames(
        jnp.asarray(_rays()), jnp.asarray(fr["positions"]),
        jnp.asarray(fr["yaws"]), jnp.asarray(fr["elevs"]),
        jnp.asarray(fr["depths"]), jnp.asarray(fr["classes"]),
        use_kernel=use_kernel)
    before = (SP.LAUNCHES, SP.FRAMES_LAUNCHES)
    tvm = _port_map(fr).update_classes_frames(
        _t(_rays()), _t(fr["positions"]), _t(fr["yaws"]), _t(fr["elevs"]),
        _t(fr["depths"]), _t(fr["classes"]))
    assert (SP.LAUNCHES, SP.FRAMES_LAUNCHES) == before   # CPU: plain
    ref = np.asarray(jvm.grid())
    assert np.abs(ref - fr["start"]).max() > 0
    np.testing.assert_allclose(tvm.grid().numpy(), ref, atol=ATOL, rtol=0)


def test_frames_route_is_sequential_updates():
    """The frames route equals T port update_classes calls in a row, bit
    for bit (the blend order within every voxel is kept across
    frames)."""
    fr = _frames(1)
    rays = _t(_rays())
    seq = _port_map(fr)
    for t in range(T):
        seq.update_classes(rays, _t(fr["positions"][t]),
                           float(fr["yaws"][t]), float(fr["elevs"][t]),
                           _t(fr["depths"][t]), _t(fr["classes"][t]))
    batched = _port_map(fr).update_classes_frames(
        rays, _t(fr["positions"]), _t(fr["yaws"]), _t(fr["elevs"]),
        _t(fr["depths"]), _t(fr["classes"]))
    assert torch.equal(batched.data, seq.data)
    assert not torch.equal(batched.data, _port_map(fr).data)


def _records(vm, fr, rays):
    """The frames' corner records, one frame at a time."""
    return [vm.contributions(rays, _t(fr["positions"][t]),
                             float(fr["yaws"][t]), float(fr["elevs"][t]),
                             _t(fr["depths"][t]))
            for t in range(fr["yaws"].shape[0])]


@pytest.mark.parametrize("num_frames", [1, 3])
def test_batched_binning_is_per_frame_contributions(num_frames):
    """contributions_frames bins T frames as one batch (poses to the host
    once, the T rotations built there): frame t's ids and weights equal
    its own contributions call bit for bit."""
    fr = {k: v[:num_frames] for k, v in _frames(3).items()
          if k != "start"}
    vm = _port_map(_frames(3))
    rays = _t(_rays())
    ids, weights = vm.contributions_frames(
        rays, _t(fr["positions"]), _t(fr["yaws"]), _t(fr["elevs"]),
        _t(fr["depths"]))
    assert ids.shape == weights.shape == (num_frames,
                                          8 * CAM["h"] * CAM["w"])
    for t, (i, w) in enumerate(_records(vm, fr, rays)):
        assert torch.equal(ids[t], i)
        assert torch.equal(weights[t], w)
    assert (ids < vm.geometry.num_voxels).any()


def test_sorted_frame_records_restrict_to_sorted_records():
    """sorted_frame_records: int32 records stable-sorted by voxel id,
    frames nondecreasing inside each voxel, and restricted to frame t
    they are frame t's sorted_records exactly."""
    fr = _frames(2)
    recs = _records(_port_map(fr), fr, _t(_rays()))
    classes = _t(fr["classes"].reshape(T, -1))
    records = SP.sorted_frame_records(torch.stack([i for i, _ in recs]),
                                      torch.stack([w for _, w in recs]),
                                      classes)
    assert [t.dtype for t in records] == [torch.int32, torch.float32,
                                          torch.int32, torch.int32]
    ids, frames = records.ids.long(), records.frames.long()
    assert torch.all(ids[1:] >= ids[:-1])
    same = ids[1:] == ids[:-1]
    assert torch.all(frames[1:][same] >= frames[:-1][same])
    for t in range(T):
        single = SP.sorted_records(recs[t][0], recs[t][1], classes[t])
        sel = records.frames == t
        for name in ("ids", "weights", "classes"):
            assert torch.equal(getattr(records, name)[sel],
                               getattr(single, name))


@pytest.mark.parametrize("num_features", [54, 7])
@pytest.mark.parametrize("name", sorted(TS.FRAME_STREAMS))
def test_plain_frames_on_chosen_subruns(name, num_features):
    """On T-frame streams of chosen sub-runs (1, 31, 32, 33 records, a
    frame change at a tile's end, a sub-run across it, a run over two
    tiles with three frames, one frame, a frame of discard ids only, a
    voxel of frames 0 and 2 but not 1, negative ids, 400 random runs) the
    plain frames version equals a naive float32 loop over the frames bit
    for bit."""
    ids, w, classes, frames, data = TS.frame_stream(name, num_features)
    want = TS.naive_frames_splat(data, ids, w, classes, frames, 0.5)
    records = SP.FrameRecords(_t(ids), _t(w), _t(classes), _t(frames))
    before = SP.FRAMES_LAUNCHES
    got = SP.apply_frame_records(_t(data), records, 0.5)
    assert SP.FRAMES_LAUNCHES == before              # CPU: plain
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, data)
