"""The dense half of the reference against the port on seeded random
weights at a small size on the CPU: the stage-1 backbone, and the dense
fold against ``FleetMaps.update_dense`` on a 32x16x4 grid with F = 8 and
B = 2."""

import numpy as np
import pytest
import torch

from portbench.reference import resnet as RR
from portbench.reference import voxel as RV
from portbench.traffic import generator


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 3])
def test_the_reference_backbone_equals_the_ports_stage1(seed):
    from mass_tpu_torch.perception import resnet

    sd = generator.backbone_weights(seed, "cpu")
    port = resnet.make_backbone(resnet.from_state_dict(sd, "cpu"))
    rgb = torch.rand(2, 32, 48, 3, generator=torch.Generator().manual_seed(5))
    mine, theirs = port(rgb), RR.forward(sd, rgb)
    assert mine.shape == theirs.shape == (2, 8, 12, RR.CHANNELS)
    assert float(theirs.abs().max()) > 0.1
    torch.testing.assert_close(mine, theirs, rtol=1e-5, atol=1e-5)


def test_the_reference_backbone_flops_equal_its_convs_products(monkeypatch):
    macs = [0]
    conv = torch.nn.functional.conv2d

    def counted(x, w, *a, **k):
        out = conv(x, w, *a, **k)
        macs[0] += out.numel() * w.shape[1] * w.shape[2] * w.shape[3]
        return out

    monkeypatch.setattr(torch.nn.functional, "conv2d", counted)
    RR.forward(generator.backbone_weights(1, "cpu"), torch.rand(1, 40, 24, 3))
    assert 2 * macs[0] == RR.flops(40, 24)
    assert RR.flops(224, 224) == 1_571_913_728


GRID = dict(map_height=32, map_width=16, map_depth=4, grid_resolution=0.25)
CAMERA, STRIDE, F, B = 16, 4, 8, 2


def _fleet(features):
    from mass_tpu_torch.config import CameraConfig, MapGeometry
    from mass_tpu_torch.parallel.fleet import FleetMaps

    return FleetMaps(
        B, CameraConfig(height=CAMERA, width=CAMERA,
                        vertical_fov_degrees=90.0),
        MapGeometry(**GRID), {"semantic0": 3}, device="cpu",
        dense_sizes={"feature0": F, "feature1": F},
        backbone=lambda rgb: features.pop(0), stride=STRIDE)


def test_the_reference_dense_fold_equals_update_dense():
    """Three steps of two episodes, feature1 updated by episode 1 alone,
    each step's features its own; every map of the fleet against the
    reference's float64 fold of the same frames."""
    rng = np.random.default_rng(7)
    g = RV.Geometry(GRID["map_height"], GRID["map_width"], GRID["map_depth"],
                    F, GRID["grid_resolution"])
    origins = np.asarray([[0.1, -0.2, 0.0], [-0.3, 0.4, 0.05]], np.float32)
    steps = 3
    feats = [torch.randn(B, CAMERA // STRIDE, CAMERA // STRIDE, F,
                         generator=torch.Generator().manual_seed(s))
             for s in range(steps)]
    fleet = _fleet(list(feats))
    for e in range(B):
        fleet.reset(e, tuple(float(v) for v in origins[e]))
    active = {"feature0": np.array([True, True]),
              "feature1": np.array([False, True])}
    rays = RV.camera_rays(CAMERA // STRIDE, 90.0, "cpu")
    bins = RV.grid_edges(origins, g, "cpu")
    ref = {(name, e): torch.zeros(g.voxels, F, dtype=torch.float64)
           for name in active for e in range(B)}
    for s in range(steps):
        positions = (origins + rng.uniform(-0.3, 0.3, (B, 3))).astype(
            np.float32)
        yaws = rng.uniform(-np.pi, np.pi, B).astype(np.float32)
        elevations = rng.uniform(-0.3, 0.3, B).astype(np.float32)
        depths = rng.uniform(0.4, 2.5, (B, CAMERA, CAMERA)).astype(
            np.float32)
        fleet.update_dense(positions, yaws, elevations, depths[..., None],
                           np.zeros((B, CAMERA, CAMERA, 3), np.float32),
                           active=active)
        sub = torch.from_numpy(np.ascontiguousarray(
            depths[:, STRIDE // 2::STRIDE, STRIDE // 2::STRIDE]))
        pixels = torch.arange(sub[0].numel()).view(sub.shape[1:]).expand(
            sub.shape)
        frames, ids, w, pix = RV.records(rays, bins, g, positions, yaws,
                                         elevations, sub, pixels)
        for name, mask in active.items():
            for e in np.flatnonzero(mask):
                k = frames == int(e)
                RV.fold_dense(ref[name, e], ids[k], w[k], pix[k],
                              feats[s][e].reshape(-1, F), g)
    reached = 0
    for (name, e), data in ref.items():
        port = fleet.view(name, e).data
        reached += int((data.abs().sum(-1) > 0).sum())
        torch.testing.assert_close(port.double(), data, rtol=0, atol=1e-5)
    assert reached > 100
    assert float(ref["feature1", 0].abs().max()) == 0.0
