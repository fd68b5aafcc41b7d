"""mass_tpu_torch.ops.components, ops.hungarian and match held against
the JAX package (and scipy for the assignment): labels, instance order
and assignments exactly; instance statistics to rtol 1e-5."""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.optimize
import torch

from mass_tpu import taxonomy
from mass_tpu.config import MapGeometry as JMapGeometry
from mass_tpu.config import MatchConfig as JMatchConfig
from mass_tpu.core.voxelmap import VoxelMap as JVoxelMap
from mass_tpu.match import differences as JD
from mass_tpu.match import find as JF
from mass_tpu.ops import components as JC
from mass_tpu.ops import hungarian as JH
from mass_tpu_torch import convert
from mass_tpu_torch.config import MapGeometry, MatchConfig
from mass_tpu_torch.match import differences as TD
from mass_tpu_torch.match import find as TF
from mass_tpu_torch.ops import components as TC
from mass_tpu_torch.ops import hungarian as TH

GEO = dict(map_height=40, map_width=48, map_depth=8, feature_size=54,
           grid_resolution=0.1)


def _t(a):
    return torch.tensor(np.asarray(a))


def _masks(seed, n=3, h=21, w=17):
    rng = np.random.RandomState(seed)
    return rng.rand(n, h, w) > 0.62


def test_label_components_match_jax():
    masks = _masks(0)
    batched = TC.label_components(_t(masks)).numpy()
    for m, got in zip(masks, batched):
        ref = np.asarray(JC.label_components(jnp.asarray(m)))
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(
            TC.label_components(_t(m)).numpy(), ref)


@pytest.mark.parametrize("k", [2, 4, 40])
def test_extract_instances_match_jax(k):
    masks = _masks(1)
    # equal-size blobs: the rank among ties must follow lax.top_k
    ties = np.zeros((14, 14), bool)
    for y, x in ((1, 9), (1, 1), (9, 1), (9, 9), (5, 5)):
        ties[y:y + 2, x:x + 2] = True
    for m in list(masks) + [ties, np.zeros_like(ties)]:
        ref = JC.extract_instances(jnp.asarray(m), k)
        out = TC.extract_instances(_t(m), k)
        for name in ref._fields:
            np.testing.assert_array_equal(
                getattr(out, name).numpy(), np.asarray(getattr(ref, name)))


def _cost_cases():
    rng = np.random.RandomState(2)
    yield rng.rand(5, 5).astype(np.float32)
    yield rng.randint(0, 3, (6, 6)).astype(np.float32)     # many ties
    yield rng.rand(3, 6).astype(np.float32)
    yield rng.rand(6, 3).astype(np.float32)
    yield np.ones((4, 4), np.float32)


@pytest.mark.parametrize("case", range(5))
def test_hungarian_matches_jax_and_scipy(case):
    cost = list(_cost_cases())[case]
    ref = np.asarray(JH.linear_sum_assignment(jnp.asarray(cost)))
    out = TH.linear_sum_assignment(_t(cost)).numpy()
    np.testing.assert_array_equal(out, ref)
    rows, cols = scipy.optimize.linear_sum_assignment(cost)
    matched = out >= 0
    assert matched.sum() == len(rows)
    np.testing.assert_allclose(
        cost[np.nonzero(matched)[0], out[matched]].sum(),
        cost[rows, cols].sum(), rtol=1e-6)


def test_hungarian_dynamic_sizes_match_jax():
    cost = np.random.RandomState(3).rand(6, 6).astype(np.float32)
    ref = np.asarray(JH.linear_sum_assignment(jnp.asarray(cost), 4, 3))
    np.testing.assert_array_equal(
        TH.linear_sum_assignment(_t(cost), 4, 3).numpy(), ref)


def _maps(blobs0, blobs1):
    """The same class-blob maps in both packages: (y0, y1, x0, x1, z0,
    z1, class, mass) boxes with a little per-voxel texture."""
    out = []
    for seed, blobs in enumerate((blobs0, blobs1)):
        rng = np.random.RandomState(10 + seed)
        grid = np.zeros((40, 48, 8, 54), np.float32)
        for y0, y1, x0, x1, z0, z1, cls, m in blobs:
            grid[y0:y1, x0:x1, z0:z1, cls] = m * (
                0.9 + 0.1 * rng.rand(y1 - y0, x1 - x0, z1 - z0))
        jvm = JVoxelMap.create(JMapGeometry(**GEO), (0.3, -0.2, 0.1)) \
            .with_grid(jnp.asarray(grid))
        tvm = convert.voxelmap_from_jax(
            np.asarray(jvm.data), np.asarray(jvm.bins_x),
            np.asarray(jvm.bins_y), np.asarray(jvm.bins_z),
            MapGeometry(**GEO), device="cpu")
        out.append((jvm, tvm))
    return out


PICK = taxonomy.ID_TO_PICKABLE.index(True)
OPEN = taxonomy.ID_TO_OPENABLE.index(True)
BLOBS0 = [(4, 9, 4, 9, 2, 5, PICK, 0.9), (20, 24, 30, 36, 1, 4, PICK, 0.7),
          (30, 35, 5, 12, 0, 6, OPEN, 0.8), (10, 12, 40, 44, 3, 4, 7, 0.5)]
BLOBS1 = [(22, 27, 31, 36, 2, 5, PICK, 0.9), (4, 8, 4, 10, 1, 4, PICK, 0.7),
          (30, 35, 5, 12, 0, 6, OPEN, 0.8)]


def _assert_found_equal(out, ref):
    np.testing.assert_array_equal(out.present.numpy(),
                                  np.asarray(ref.present))
    np.testing.assert_array_equal(out.truncated.numpy(),
                                  np.asarray(ref.truncated))
    for name in ("confidence", "position", "size"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("padding", [0, 1])
def test_find_matches_jax(padding):
    (jvm, tvm), _ = _maps(BLOBS0, BLOBS1)
    kw = dict(confidence_threshold=0.1, contour_padding=padding,
              contour_threshold=0.0, max_instances=4)
    _assert_found_equal(TF.find_class_instances(tvm, PICK, **kw),
                        JF.find_class_instances(jvm, PICK, **kw))
    _assert_found_equal(TF.find_all_classes(tvm, **kw),
                        JF.find_all_classes(jvm, **kw))


@pytest.mark.parametrize("moved", [set(), {PICK}])
def test_predict_scene_differences_matches_jax(moved):
    (j0, t0), (j1, t1) = _maps(BLOBS0, BLOBS1)
    cfg = dict(contour_padding=0, distance_threshold=0.05, max_instances=2)
    cands = range(taxonomy.NUM_CLASSES)
    jc, jg0, jg1 = JD.predict_scene_differences(
        j0, j1, None, None, set(moved), cands, JMatchConfig(**cfg))
    tc, tg0, tg1 = TD.predict_scene_differences(
        t0, t1, None, None, set(moved), cands, MatchConfig(**cfg))
    assert tc == jc is not None
    assert len(tg0) == len(jg0) and len(tg1) == len(jg1)
    np.testing.assert_allclose(np.stack(tg0), np.stack(jg0), atol=1e-5)
    np.testing.assert_allclose(np.stack(tg1), np.stack(jg1), atol=1e-5)
