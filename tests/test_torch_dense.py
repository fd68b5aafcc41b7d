"""The port's dense-feature mapping held against the JAX package on the
same numpy inputs: the dense-row splat's plain version against XLA's
``apply_dense_rows`` (atol 1e-5; it is bit-equal on these inputs),
``VoxelMap.update``, ``FeatureMap``, ``ClipMap`` and a ``MapSet`` group
of semantic and feature maps (atol 2e-4, the backbone's tolerance), and
the fleet's dense slabs against per-episode updates (bit for bit).  The
CUDA kernel itself runs only on a card (``tests/test_torch_gpu.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from mass_tpu.config import CameraConfig as JCameraConfig
from mass_tpu.config import MapGeometry as JMapGeometry
from mass_tpu.core.voxelmap import VoxelMap as JVoxelMap
from mass_tpu.maps import layers as JL
from mass_tpu.ops.scatter import apply_dense_rows
from mass_tpu.perception import resnet as JRN
from mass_tpu_torch.config import CameraConfig, MapGeometry
from mass_tpu_torch.convert import (backbone_state_dict_from_jax,
                                    voxelmap_from_jax)
from mass_tpu_torch.core.voxelmap import VoxelMap
from mass_tpu_torch.maps import layers as TL
from mass_tpu_torch.ops import splat as SP
from mass_tpu_torch.parallel.fleet import FleetMaps
from mass_tpu_torch.perception import resnet as TR
from tests import reference_impl as R
from tests import torch_streams as TS

SPLAT_ATOL = 1e-5
MAP_ATOL = 2e-4     # features from the two backbones differ by this much
# tests/test_perception.py's FeatureMap geometry
CAM = 32
GEO = dict(map_height=32, map_width=32, map_depth=8, grid_resolution=0.2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _dense_case(seed, voxels, features, pixels, long_run):
    """Corner-major records of ``pixels`` pixels: random ids with the
    discard id ``V`` among them, and (``long_run``) a third of them on
    one voxel."""
    rng = np.random.RandomState(seed)
    data = rng.rand(voxels, features).astype(np.float32)
    ids = rng.randint(0, voxels + 1, 8 * pixels).astype(np.int32)
    if long_run:
        ids[rng.rand(8 * pixels) < 0.33] = voxels // 2
    weights = (1e-9 + rng.rand(8 * pixels)).astype(np.float32)
    feats = rng.randn(pixels, features).astype(np.float32)
    return data, ids, weights, feats


def _jax_dense(data, ids, weights, feats, iw):
    return np.asarray(apply_dense_rows(jnp.asarray(data), jnp.asarray(ids),
                                       jnp.asarray(weights),
                                       jnp.asarray(feats), iw))


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), voxels=st.integers(1, 40),
       features=st.sampled_from([1, 3, 4, 7, 16, 256]),
       pixels=st.integers(1, 12), long_run=st.booleans(),
       iw=st.sampled_from([0.5, 0.25, 1.0]))
def test_dense_reference_matches_jax(seed, voxels, features, pixels,
                                     long_run, iw):
    data, ids, weights, feats = _dense_case(seed, voxels, features, pixels,
                                            long_run)
    ref = _jax_dense(data, ids, weights, feats, iw)
    got = SP.splat_dense(_t(data), _t(ids), _t(weights), _t(feats), iw)
    np.testing.assert_allclose(got.numpy(), ref, atol=SPLAT_ATOL, rtol=0)


def test_dense_reference_touches_only_the_runs():
    """Untouched rows keep their bits (NaN included: the plain version
    never multiplies them), and the discard id changes nothing."""
    data, ids, weights, feats = _dense_case(3, 30, 5, 6, True)
    untouched = np.setdiff1d(np.arange(30), ids[ids < 30])
    assert untouched.size
    data[untouched[0]] = np.nan
    got = SP.splat_dense(_t(data), _t(ids), _t(weights), _t(feats), 0.5)
    np.testing.assert_array_equal(got.numpy()[untouched], data[untouched])
    only_discard = np.full_like(ids, 30)
    same = SP.splat_dense(_t(data), _t(only_discard), _t(weights),
                          _t(feats), 0.5)
    np.testing.assert_array_equal(same.numpy(), data)
    assert SP.DENSE_LAUNCHES == 0            # CPU maps: the plain version


def test_dense_records_carry_pixels_in_sorted_order():
    ids = torch.tensor([5, 2, 5, 9, 2, 2, 5, 9], dtype=torch.int32)
    w = torch.arange(8, dtype=torch.float32)
    rec = SP.sorted_dense_records(ids, w, 4)
    assert rec.ids.tolist() == [2, 2, 2, 5, 5, 5, 9, 9]
    assert rec.weights.tolist() == [1, 4, 5, 0, 2, 6, 3, 7]
    assert rec.pixels.tolist() == [1, 0, 1, 0, 2, 2, 3, 3]
    assert rec.pixels.dtype == torch.int32


@pytest.mark.parametrize("name", sorted(TS.DENSE_STREAMS))
def test_dense_streams_sort_into_their_runs(name):
    """A stable sort of a dense stream gives back the runs it was made
    of, each record still carrying the pixel of its position."""
    ids, weights, feats, _ = TS.dense_stream(name, 1)
    rec = SP.sorted_dense_records(_t(ids), _t(weights), feats.shape[0])
    negative, lengths, _ = TS.DENSE_STREAMS[name]
    runs = torch.unique_consecutive(rec.ids, return_counts=True)[1]
    valid = runs[len(negative):len(negative) + len(lengths)]
    assert runs[:len(negative)].tolist() == list(negative)
    assert valid.tolist() == list(lengths)
    assert (rec.ids[valid.sum() + sum(negative):] == TS.NUM_VOXELS).all()
    order = np.argsort(ids, kind="stable")
    assert rec.pixels.tolist() == (order % feats.shape[0]).tolist()


@pytest.mark.parametrize("num_features", TS.DENSE_FEATURES)
@pytest.mark.parametrize("name", sorted(TS.DENSE_STREAMS))
def test_dense_streams_match_jax(name, num_features):
    """The plain version on each chosen stream against XLA's
    ``apply_dense_rows`` (atol 1e-5).  JAX knows one discard id, V, and
    wraps negative indices, so its input has every id outside [0, V) at
    V: the ids the port skips."""
    ids, weights, feats, data = TS.dense_stream(name, num_features)
    jax_ids = np.where((ids >= 0) & (ids < data.shape[0]), ids,
                       data.shape[0]).astype(np.int32)
    ref = _jax_dense(data, jax_ids, weights, feats, 0.5)
    got = SP.splat_dense(_t(data), _t(ids), _t(weights), _t(feats), 0.5)
    np.testing.assert_allclose(got.numpy(), ref, atol=SPLAT_ATOL, rtol=0)
    if name != "all_discard":
        assert not np.array_equal(got.numpy(), data)


def _frame(seed, camera=CAM):
    rng = np.random.RandomState(seed)
    return dict(
        position=rng.uniform(-0.3, 0.3, 3).astype(np.float32),
        yaw=np.float32(rng.uniform(-np.pi, np.pi)),
        elevation=np.float32(rng.uniform(-0.6, 0.1)),
        depth=rng.uniform(0.3, 2.5, (camera, camera, 1)).astype(np.float32),
        rgb=rng.rand(camera, camera, 3).astype(np.float32),
        semantic=rng.randint(0, 54, (camera, camera)).astype(np.int32))


def test_voxelmap_update_matches_jax():
    """Three frames of 8x8 dense features through an 8x8 ray grid (one
    of them upsampled from 4x4), port against JAX's vmajor update."""
    F = 16
    jgeo = JMapGeometry(feature_size=F, layout="vmajor", **GEO)
    jvm = JVoxelMap.create(jgeo, (0.0, 0.0, 0.0))
    tvm = VoxelMap.create(MapGeometry(feature_size=F, **GEO), device="cpu")
    rays = R.ref_camera_rays(8, 8, 4.0, 4.0)
    for seed in range(3):
        rng = np.random.RandomState(seed)
        f = rng.randn(4 if seed == 1 else 8, 4 if seed == 1 else 8,
                      F).astype(np.float32)
        pose = (rng.uniform(-0.3, 0.3, 3).astype(np.float32),
                np.float32(rng.uniform(-np.pi, np.pi)),
                np.float32(rng.uniform(-0.6, 0.1)))
        depth = rng.uniform(0.1, 2.5, (8, 8, 1)).astype(np.float32)
        depth[0, 0] = 50.0
        jvm = jvm.update(jnp.asarray(rays), jnp.asarray(pose[0]), pose[1],
                         pose[2], jnp.asarray(depth), jnp.asarray(f))
        tvm.update(_t(rays), _t(pose[0]), float(pose[1]), float(pose[2]),
                   _t(depth), _t(f))
    ref = np.asarray(jvm.data)
    assert np.count_nonzero(ref.any(axis=1)) > 20
    np.testing.assert_allclose(tvm.data.numpy(), ref, atol=SPLAT_ATOL,
                               rtol=0)


def _backbones(seed=0):
    variables = jax.tree_util.tree_map(
        np.asarray, JRN.ResNet50Stage1().init(jax.random.PRNGKey(seed),
                                              jnp.zeros((1, 32, 32, 3))))
    module = TR.from_state_dict(backbone_state_dict_from_jax(variables),
                                device="cpu")
    return JRN.make_backbone(variables), TR.make_backbone(module)


def test_feature_map_matches_jax():
    jbackbone, tbackbone = _backbones()
    kw = dict(stride=4, **GEO)
    jmap = JL.FeatureMap(JCameraConfig(height=CAM, width=CAM), 256,
                         jbackbone, **kw)
    tmap = TL.FeatureMap(CameraConfig(height=CAM, width=CAM), 256,
                         tbackbone, device="cpu", **kw)
    assert tuple(tmap.rays.shape) == (8, 8, 3)
    for seed in range(2):
        obs = _frame(seed)
        jmap.update_from_observation(obs)
        tmap.update_from_observation(obs)
    ref = np.asarray(jmap.voxel_map.data)
    assert np.count_nonzero(ref.any(axis=1)) > 20
    np.testing.assert_allclose(tmap.voxel_map.data.numpy(), ref,
                               atol=MAP_ATOL, rtol=0)


def _clip_encoder(pkg):
    """tests/test_maps_group.py's stub encoder: the mean colour, tiled."""
    if pkg == "jax":
        return lambda rgb: jnp.tile(jnp.mean(rgb.reshape(-1, 3), axis=0),
                                    44)[:128]
    return lambda rgb: rgb.reshape(-1, 3).mean(dim=0).repeat(44)[:128]


def test_clip_map_matches_jax():
    jmap = JL.ClipMap(JCameraConfig(height=24, width=24), 128,
                      _clip_encoder("jax"), **GEO)
    tmap = TL.ClipMap(CameraConfig(height=24, width=24), 128,
                      _clip_encoder("torch"), device="cpu", **GEO)
    assert tuple(tmap.rays.shape) == (1, 1, 3)
    for seed in range(3):
        obs = _frame(seed, 24)
        obs["depth"] = np.full((24, 24, 1), 1.0 + 0.3 * seed, np.float32)
        jmap.update_from_observation(obs)
        tmap.update_from_observation(obs)
    ref = np.asarray(jmap.voxel_map.data)
    assert 1 <= np.count_nonzero(ref.any(axis=1)) <= 24
    np.testing.assert_allclose(tmap.voxel_map.data.numpy(), ref,
                               atol=1e-6, rtol=0)


def test_map_group_of_semantic_and_feature_maps_matches_jax():
    """One ``update_group`` of semantic0 + feature0 (and the dense map
    routed to its own update) equals JAX's group, and each map equals
    its own update."""
    jbackbone, tbackbone = _backbones(1)
    jcam, tcam = (JCameraConfig(height=CAM, width=CAM),
                  CameraConfig(height=CAM, width=CAM))
    jmaps = JL.MapSet(semantic0=JL.SemanticMap(jcam, 54, **GEO),
                      feature0=JL.FeatureMap(jcam, 256, jbackbone, **GEO))
    tmaps = TL.MapSet(
        semantic0=TL.SemanticMap(tcam, 54, device="cpu", **GEO),
        feature0=TL.FeatureMap(tcam, 256, tbackbone, device="cpu", **GEO))
    alone = TL.FeatureMap(tcam, 256, tbackbone, device="cpu", **GEO)
    for seed in range(2):
        obs = _frame(10 + seed)
        jmaps.update_group(["semantic0", "feature0", "absent"], obs)
        tmaps.update_group(["semantic0", "feature0", "absent"], obs)
        alone.update_from_observation(obs)
    jsem = jmaps["semantic0"].voxel_map
    ref = voxelmap_from_jax(np.asarray(jsem.data), jsem.bins_x, jsem.bins_y,
                            jsem.bins_z, tmaps["semantic0"].geometry,
                            device="cpu").data
    np.testing.assert_allclose(tmaps["semantic0"].voxel_map.data.numpy(),
                               ref.numpy(), atol=SPLAT_ATOL, rtol=0)
    np.testing.assert_allclose(tmaps["feature0"].voxel_map.data.numpy(),
                               np.asarray(jmaps["feature0"].voxel_map.data),
                               atol=MAP_ATOL, rtol=0)
    assert torch.equal(tmaps["feature0"].voxel_map.data,
                       alone.voxel_map.data)


def _pixel_backbone(rgb: torch.Tensor) -> torch.Tensor:
    """A stand-in backbone whose output for a frame does not depend on
    the batch it rides in (a conv's does, by an ulp, on the CPU): each
    4x4 cell's corner colour spread over 256 channels, elementwise."""
    cells = rgb[..., ::4, ::4, :]
    gain = torch.linspace(-2.0, 2.0, 256)
    return cells[..., torch.arange(256) % 3] * gain


@pytest.mark.parametrize("masked", [False, True])
def test_fleet_dense_slabs_equal_feature_map_updates(masked):
    """``FleetMaps.update_dense`` of B = 3 episodes (one batched backbone
    call, corner-major records over the fleet) equals each episode's own
    ``FeatureMap`` updates bit for bit; a masked episode's slab stays as
    it was, per family.  The backbone is a batch-independent stand-in, so
    the check is the fleet's binning, records and splats."""
    B = 3
    tbackbone = _pixel_backbone
    cam = CameraConfig(height=CAM, width=CAM)
    fleet = FleetMaps(B, cam, MapGeometry(**GEO), {"semantic0": 54},
                      device="cpu",
                      dense_sizes={"feature0": 256, "feature1": 256},
                      backbone=tbackbone)
    assert fleet.dense_names == ["feature0", "feature1"]
    singles = [TL.FeatureMap(cam, 256, tbackbone, device="cpu", **GEO)
               for _ in range(B)]
    origins = [(0.0, 0.0, 0.0), (0.4, -0.2, 0.1), (-0.3, 0.5, 0.0)]
    for e, origin in enumerate(origins):
        fleet.reset(e, origin)
        singles[e].reset(origin)
    active = ({"feature0": np.array([True, False, True]),
               "feature1": np.array([False, True, True])} if masked
              else None)
    for step in range(2):
        frames = [_frame(20 + 3 * step + e) for e in range(B)]
        fleet.update_dense(
            np.stack([f["position"] for f in frames]),
            np.stack([f["yaw"] for f in frames]),
            np.stack([f["elevation"] for f in frames]),
            np.stack([f["depth"] for f in frames]),
            np.stack([f["rgb"] for f in frames]), active=active)
        for e in range(B):
            singles[e].update_from_observation(frames[e])
    for name in ("feature0", "feature1"):
        for e in range(B):
            got = fleet.view(name, e).data
            if active is not None and not active[name][e]:
                assert not got.any()
                continue
            assert got.any()
            assert torch.equal(got, singles[e].voxel_map.data), (name, e)
    assert not fleet.buffers["semantic0"].any()
    assert SP.DENSE_LAUNCHES == 0


def test_fleet_maps_refuse_dense_families_without_a_backbone():
    with pytest.raises(ValueError, match="backbone"):
        FleetMaps(2, CameraConfig(height=CAM, width=CAM),
                  MapGeometry(**GEO), {"semantic0": 54}, device="cpu",
                  dense_sizes={"feature0": 256})


def test_dense_wrapper_refuses_mixed_devices():
    data = torch.zeros(4, 3)
    rec = SP.sorted_dense_records(torch.zeros(8, dtype=torch.int32),
                                  torch.ones(8), 1)
    with pytest.raises(ValueError, match="mixed"):
        SP.apply_dense_records(data, rec, torch.zeros(1, 3,
                                                      device="meta"), 0.5)
