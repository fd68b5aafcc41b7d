"""mass_tpu_torch.core.geometry held against mass_tpu.core.geometry.

Same inputs (numpy, from a seed) through both; geometry agrees to 1e-6
and integer cell indices exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mass_tpu.core import geometry as JG
from mass_tpu_torch.core import geometry as TG

CPU = torch.device("cpu")


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("h,w,f", [(9, 11, 7.0), (48, 48, 24.0)])
def test_camera_rays(h, w, f):
    ref = np.asarray(JG.camera_rays(h, w, f, f))
    out = TG.camera_rays(h, w, f, f, device=CPU).numpy()
    np.testing.assert_array_equal(out, ref)


def test_orient_rays_matches_jax():
    rng = np.random.RandomState(0)
    rays = np.asarray(JG.camera_rays(9, 11, 7.0, 7.0))
    for _ in range(20):
        yaw = np.float32(rng.uniform(-np.pi, np.pi))
        elev = np.float32(rng.uniform(-0.8, 0.2))
        ref = np.asarray(JG.orient_rays(jnp.asarray(rays), yaw, elev))
        out = TG.orient_rays(_t(rays), float(yaw), float(elev)).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("origin,n,res", [(0.0, 16, 0.2), (1.37, 80, 0.125),
                                          (-2.1, 384, 0.05)])
def test_uniform_bins(origin, n, res):
    ref = np.asarray(JG.uniform_bins(jnp.float32(origin), n, res))
    out = TG.uniform_bins(origin, n, res, device=CPU).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("resolution", [None, 0.125])
def test_bucketize_matches_jax_and_torch_bucketize(resolution):
    rng = np.random.RandomState(1)
    bins = np.asarray(JG.uniform_bins(jnp.float32(0.3), 80, 0.125))
    x = np.concatenate([
        rng.uniform(bins[0] - 1, bins[-1] + 1, 500).astype(np.float32),
        bins, np.nextafter(bins, -np.inf, dtype=np.float32)])
    ref = np.asarray(JG.bucketize(jnp.asarray(x), jnp.asarray(bins),
                                  resolution))
    out = TG.bucketize(_t(x), _t(bins), resolution).numpy()
    np.testing.assert_array_equal(out, ref)
    lib = torch.bucketize(_t(x), _t(bins), right=True) - 1
    np.testing.assert_array_equal(out, lib.clamp(-1, len(bins) - 1).numpy())


def test_bin_rays_matches_jax():
    rng = np.random.RandomState(2)
    res = 0.2
    bx = JG.uniform_bins(jnp.float32(0.1), 16, res)
    by = JG.uniform_bins(jnp.float32(-0.2), 32, res)
    bz = JG.uniform_bins(jnp.float32(0.0), 4, res)
    rays = np.asarray(JG.orient_rays(
        JG.camera_rays(9, 11, 7.0, 7.0), np.float32(0.4), np.float32(-0.5)))
    depth = rng.uniform(0.05, 3.0, (9, 11, 1)).astype(np.float32)
    depth[0, 0, 0] = 50.0
    origin = rng.uniform(-0.3, 0.3, 3).astype(np.float32)
    ref = JG.bin_rays(bx, by, bz, jnp.asarray(origin), jnp.asarray(rays),
                      jnp.asarray(depth), resolution=res)
    out = TG.bin_rays(_t(bx), _t(by), _t(bz), _t(origin), _t(rays),
                      _t(depth), resolution=res)
    assert np.asarray(ref.valid).any() and not np.asarray(ref.valid).all()
    for name in ("ind_x", "ind_y", "ind_z", "valid"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    for name in ("ratio_x", "ratio_y", "ratio_z"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=1e-6, rtol=0)


def test_upsample_features():
    rng = np.random.RandomState(3)
    feats = rng.randint(0, 54, (12, 12, 1)).astype(np.int32)
    ref = np.asarray(JG.upsample_features(jnp.asarray(feats), 48, 48))
    out = TG.upsample_features(_t(feats), 48, 48).numpy()
    np.testing.assert_array_equal(out, ref)
