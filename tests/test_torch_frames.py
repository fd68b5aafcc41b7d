"""The port's frames route (ops/splat.py: frame_runs,
splat_onehot_frames_reference, apply_frame_runs; VoxelMap.
update_classes_frames) held against the JAX package's Pallas frames
kernel in interpret mode and its XLA scan path (atol 1e-5), and
against T sequential port updates bit for bit.  The CUDA kernel runs
only on a card: its test is in ``tests/test_torch_gpu.py``.
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


def test_frame_runs_cut_voxels_then_frames():
    """frame_runs: one run per voxel (ids increasing), its sub-runs in
    frame order, and each frame's sub-runs holding exactly that frame's
    sorted_records records."""
    fr = _frames(2)
    vm = _port_map(fr)
    rays = _t(_rays())
    recs = [vm.contributions(rays, _t(fr["positions"][t]),
                             float(fr["yaws"][t]), float(fr["elevs"][t]),
                             _t(fr["depths"][t])) for t in range(T)]
    classes = _t(fr["classes"].reshape(T, -1))
    runs = SP.frame_runs(torch.stack([i for i, _ in recs]),
                         torch.stack([w for _, w in recs]), classes)
    assert torch.all(runs.ids[1:] > runs.ids[:-1])
    assert runs.starts[-1] == T * recs[0][0].shape[0]
    sub_ids = torch.repeat_interleave(
        runs.ids, runs.sub_starts[1:] - runs.sub_starts[:-1])
    key = sub_ids * T + runs.frames
    assert torch.all(key[1:] > key[:-1])
    for t in range(T):
        single = SP.sorted_records(recs[t][0], recs[t][1], classes[t])
        sel = torch.nonzero(runs.frames == t)[:, 0]
        assert torch.equal(sub_ids[sel],
                           torch.unique_consecutive(single.ids).long())
        rec = torch.cat([torch.arange(int(runs.starts[s]),
                                      int(runs.starts[s + 1]))
                         for s in sel.tolist()])
        assert torch.equal(runs.weights[rec], single.weights)
        assert torch.equal(runs.classes[rec], single.classes)
