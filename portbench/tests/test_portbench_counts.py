"""The benchmark's operation and byte counts against counts by hand."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench.reference import maskrcnn as RM
from portbench.reference import roofline
from portbench.reference import voxel as RV
from portbench.traffic import generator


def test_detector_flops_equal_the_networks_own_products(monkeypatch):
    """Every conv, deconv and linear of a one-frame forward, counted from
    the shapes it ran at (the heads over every proposal and slot),
    against the formula."""
    macs = [0]
    conv, linear, deconv = F.conv2d, F.linear, F.conv_transpose2d

    def counted_conv(x, w, b=None, stride=1, padding=0, *a, **k):
        out = conv(x, w, b, stride, padding, *a, **k)
        macs[0] += out.numel() * w.shape[1] * w.shape[2] * w.shape[3]
        return out

    def counted_linear(x, w, b=None):
        macs[0] += x.shape[0] * w.shape[0] * w.shape[1]
        return linear(x, w, b)

    def counted_deconv(x, w, b=None, stride=1, *a, **k):
        macs[0] += x.numel() * w.shape[1] * w.shape[2] * w.shape[3]
        return deconv(x, w, b, stride, *a, **k)

    cfg = RM.Config(image_size=64, post_nms_topk=32, max_detections=8,
                    pre_nms_topk=100, candidate_pool=64)
    sd = generator.detector_weights(cfg.num_classes, 3, "cpu")
    monkeypatch.setattr(F, "conv2d", counted_conv)
    monkeypatch.setattr(F, "linear", counted_linear)
    monkeypatch.setattr(F, "conv_transpose2d", counted_deconv)
    RM.detect(sd, cfg, torch.rand(1, 64, 64, 3))
    assert 2 * macs[0] == RM.flops(cfg)


def test_trunk_flops_by_hand():
    # 32 px: the stem's 16x16x64 outputs of 7x7x3 products, then the
    # stages at 8, 4, 2, 1 px
    side = [8, 4, 2, 1]
    macs = 16 * 16 * 64 * 3 * 49
    cin = 64
    for s, (blocks, w) in enumerate(zip(RM.BLOCKS, RM.WIDTHS)):
        for b in range(blocks):
            n = side[s] ** 2
            macs += n * (cin * w + 9 * w * w + 4 * w * w)
            if b == 0:
                macs += n * cin * 4 * w
            cin = 4 * w
    assert RM.trunk_flops(32) == 2 * macs


def test_map_update_bytes_by_hand():
    # 10 voxel rows of 54 float32 channels read and written, 100 pixels'
    # depth and class read
    assert roofline.map_update_bytes(10, 54, 100) == 10 * 54 * 4 * 2 + 800


def test_dense_update_bytes_by_hand():
    # 10 voxel rows of 256 float32 channels read and written, 80 records'
    # int32 id, float32 weight and int32 pixel, 10 pixels' feature rows
    assert roofline.dense_update_bytes(10, 256, 80, 10) \
        == 10 * 256 * 4 * 2 + 80 * 12 + 10 * 256 * 4


@pytest.mark.parametrize("depth, voxels", [(1.0, 8), (1.2, 8), (9.0, 0)])
def test_one_pixel_touches_its_eight_corner_voxels(depth, voxels):
    """A ray along +x from the origin of a 1 m grid: at a cell's centre
    (1.0) or off it (1.2) the point spreads over 2x2x2 voxels with
    weights that sum to one; past the grid (9.0) it touches none."""
    g = RV.Geometry(8, 8, 8, 3, 1.0)
    bins = RV.grid_edges(np.zeros((1, 3)), g, "cpu")
    rays = torch.tensor([[[0.0, 0.0, -1.0]]])
    frames, ids, w, cls = RV.records(
        rays, bins, g, np.zeros((1, 3), np.float32), [0.0], [0.0],
        torch.tensor([[[depth]]]), torch.tensor([[[2]]], dtype=torch.int32))
    assert RV.touched_voxels(frames, ids, g.voxels) == voxels
    if voxels:
        assert abs(float(w.sum()) - 1.0) < 1e-6
        data = torch.zeros(g.voxels, g.classes, dtype=torch.float64)
        RV.fold(data, ids, w, cls, g)
        # one pixel, blend 0.5: each touched voxel holds 0.5 * w of class 2
        assert torch.allclose(data[ids, 2], 0.5 * w.double())
        assert float(data[:, :2].abs().sum()) == 0.0
