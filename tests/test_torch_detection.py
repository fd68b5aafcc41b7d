"""The port's detection blocks (``mass_tpu_torch.ops.detection``) against
``mass_tpu.ops.detection`` on the same inputs: IoU, the greedy NMS loop
on chosen streams (ties, signed zeros, zero-area boxes, dead boxes, class
islands) and ROIAlign.  The CUDA kernel itself is held against the plain
loop in ``tests/test_torch_gpu.py``."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mass_tpu.ops import detection as JD
from mass_tpu.perception import maskrcnn as JM
from mass_tpu_torch.ops import detection as TD
from mass_tpu_torch.perception import maskrcnn as TM
from tests import torch_streams as TS


def _boxes(rng, n, size=64.0):
    xy = rng.uniform(-4, size, (n, 2))
    wh = rng.uniform(0, 30, (n, 2))
    wh[::5] = 0.0                                  # degenerate boxes
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_box_iou_matches_jax():
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 40), _boxes(rng, 33)
    want = np.asarray(JD.box_iou(jnp.asarray(a), jnp.asarray(b)))
    got = TD.box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    batched = TD.box_iou(torch.from_numpy(a)[None].expand(3, -1, -1),
                         torch.from_numpy(b)[None].expand(3, -1, -1))
    assert torch.equal(batched[1], torch.from_numpy(got))


@pytest.mark.parametrize("name", sorted(TS.NMS_STREAMS))
def test_nms_reference_matches_jax(name):
    boxes, scores, thr, outputs = TS.nms_stream(name)
    want = np.asarray(JD.nms(jnp.asarray(boxes), jnp.asarray(scores), thr,
                             outputs))
    got = TD.nms_reference(torch.from_numpy(boxes)[None],
                           torch.from_numpy(scores)[None], thr, outputs)
    np.testing.assert_array_equal(got[0].numpy(), want)
    before = TD.LAUNCHES
    via = TD.nms(torch.from_numpy(boxes)[None],
                 torch.from_numpy(scores)[None], thr, outputs)
    assert torch.equal(via, got) and TD.LAUNCHES == before


def test_nms_batch_equals_each_problem():
    """Streams padded into one batch with -inf scores, a cap per problem
    (and a cap list cycled over problems, as the RPN's levels are), give
    each problem's own keep row."""
    names = ["random", "zero_area", "all_dead", "class_offsets",
             "equal_scores"]
    boxes, scores, _, outputs = TS.nms_batch(names)
    keep = TD.nms_reference(torch.from_numpy(boxes),
                            torch.from_numpy(scores), 0.5, outputs)
    assert keep.shape == (len(names), max(outputs))
    for p, name in enumerate(names):
        b, s, _, m = TS.nms_stream(name)
        want = np.asarray(JD.nms(jnp.asarray(b), jnp.asarray(s), 0.5, m))
        np.testing.assert_array_equal(keep[p, :m].numpy(), want)
        assert (keep[p, m:] == -1).all()
    cycled = TD.nms_reference(torch.from_numpy(np.concatenate([boxes] * 2)),
                              torch.from_numpy(np.concatenate([scores] * 2)),
                              0.5, outputs)
    assert torch.equal(cycled, torch.cat([keep, keep]))
    with pytest.raises(ValueError):
        TD.nms_reference(torch.from_numpy(boxes), torch.from_numpy(scores),
                         0.5, [1, 2])


def test_roi_align_matches_jax():
    rng = np.random.RandomState(1)
    feat = rng.randn(13, 11, 5).astype(np.float32)
    boxes = np.concatenate([_boxes(rng, 9, 12.0),
                            [[-3, -2, 20, 18], [5, 5, 5, 5]]]
                           ).astype(np.float32)
    for size in (7, 14):
        want = np.asarray(JD.roi_align(jnp.asarray(feat),
                                       jnp.asarray(boxes), size))
        got = TD.roi_align(torch.from_numpy(feat), torch.from_numpy(boxes),
                           size).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_multilevel_roi_align_matches_jax():
    """Each box pooled on its own level only equals the JAX package's sum
    over all four levels with a one-hot selection."""
    rng = np.random.RandomState(2)
    feats = [rng.randn(s, s, 6).astype(np.float32) for s in (16, 8, 4, 2)]
    boxes = np.concatenate([_boxes(rng, 12, 64.0),
                            [[0, 0, 60, 62], [10, 10, 11, 11]]]
                           ).astype(np.float32)
    want = np.asarray(JM.multilevel_roi_align(
        [jnp.asarray(f) for f in feats], jnp.asarray(boxes), 7))
    got = TM.multilevel_roi_align([torch.from_numpy(f) for f in feats],
                                  torch.from_numpy(boxes), 7).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(
        TM.assign_levels(torch.from_numpy(boxes)).numpy(),
        np.asarray(JM.assign_levels(jnp.asarray(boxes))))
    # a batch of two frames pools each frame from its own maps
    two = TM.multilevel_roi_align(
        [torch.from_numpy(np.stack([f, 2 * f])) for f in feats],
        torch.from_numpy(np.stack([boxes, boxes])), 7)
    assert torch.equal(two[0], torch.from_numpy(got))
    np.testing.assert_allclose(two[1].numpy(), 2 * got, atol=1e-5)


def test_paste_masks_matches_jax():
    rng = np.random.RandomState(3)
    masks = rng.rand(6, 28, 28).astype(np.float32)
    boxes = np.array([[3, 4, 40, 50], [0, 0, 64, 64], [10, 10, 10.0005, 30],
                      [-5, 20, 30, 70], [33.3, 1.7, 35.1, 9.9],
                      [50, 50, 49, 60]], np.float32)
    want = np.asarray(JM.paste_masks(jnp.asarray(masks), jnp.asarray(boxes),
                                     48, 64))
    got = TM.paste_masks(torch.from_numpy(masks), torch.from_numpy(boxes),
                         48, 64).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_decode_and_anchors_match_jax():
    rng = np.random.RandomState(4)
    anchors = _boxes(rng, 50)
    deltas = rng.randn(50, 4).astype(np.float32) * 2
    deltas[0, 2:] = 20.0                           # past the dw clamp
    for weights in ((1.0, 1.0, 1.0, 1.0), TM.BOX_REG_WEIGHTS):
        want = np.asarray(JM.decode_boxes(jnp.asarray(anchors),
                                          jnp.asarray(deltas), weights))
        got = TM.decode_boxes(torch.from_numpy(anchors),
                              torch.from_numpy(deltas), weights).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    for side in (48, 64, 224):
        cfg = TM.MaskRCNNConfig(image_size=side)
        jcfg = JM.MaskRCNNConfig(image_size=side)
        for a, b in zip(TM.level_anchors(cfg), JM.level_anchors(jcfg)):
            np.testing.assert_array_equal(a, b)
