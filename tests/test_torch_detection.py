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


# ----------------------------------------------------------------------
# a CPU model of csrc/nms.cu's algorithm: rank by key, suppression
# bitmask over the sorted pairs, one warp's walk along the words
# ----------------------------------------------------------------------

FULL = 0xffffffff


def _model_keys(scores):
    """The kernel's order as one 64-bit key: the score's order bits (-0
    read as +0) over ~index, so a tie goes to the lower index; 0 for a
    dead box (-inf or NaN)."""
    s = np.where(scores == 0, np.float32(0), scores).astype(np.float32)
    u = s.view(np.uint32)
    u = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))
    index = ~np.arange(s.shape[0], dtype=np.uint32)
    keys = (u.astype(np.uint64) << np.uint64(32)) | index.astype(np.uint64)
    return np.where(s > -np.inf, keys, np.uint64(0))


def _model_midpoint(t):
    """csrc/nms.cu's threshold_midpoint: the midpoint between float32 t
    and the float below it, in float64, and whether a tie rounds to t."""
    if np.isnan(t):
        return np.nan, False
    if t <= 0:
        return -np.inf, True
    above = 2.0 ** 128 if np.isinf(t) else float(t)
    below = float(np.nextafter(t, np.float32(0)))
    return 0.5 * (below + above), int(t.view(np.uint32)) % 2 == 0


def _model_rows(boxes, threshold):
    """Bit (r, c) = iou(box r, box c) >= threshold in the kernel's fp32
    order (fminf/fmaxf ignore NaN, as np.fmin/np.fmax), checked equal to
    the kernel's test against the threshold's midpoint, packed into
    32-bit words with position 32w + b at bit 31 - b of word w; words left
    of the diagonal zero."""
    zero = np.float32(0)
    x0, y0, x1, y1 = (boxes[:, k] for k in range(4))
    area = np.fmax(x1 - x0, zero) * np.fmax(y1 - y0, zero)
    w = np.fmax(np.fmin(x1[:, None], x1[None]) - np.fmax(x0[:, None],
                                                          x0[None]), zero)
    h = np.fmax(np.fmin(y1[:, None], y1[None]) - np.fmax(y0[:, None],
                                                          y0[None]), zero)
    inter = w * h
    divisor = np.fmax((area[:, None] + area[None]) - inter, np.float32(1e-9))
    with np.errstate(invalid="ignore"):
        bits = inter / divisor >= np.float32(threshold)
    # the kernel decides the same bits without the division
    midpoint, ties_reach = _model_midpoint(np.float32(threshold))
    product = midpoint * divisor.astype(np.float64)
    exact = (inter > product) | ((inter == product) & ties_reach)
    np.testing.assert_array_equal(exact, bits)
    live = boxes.shape[0]
    words = -(-live // 32)
    bits = np.pad(bits, ((0, 0), (0, 32 * words - live)))
    rows = np.packbits(bits, axis=1).view(">u4").astype(np.int64)
    for r in range(live):
        rows[r, :r // 32] = 0
    return rows


def nms_model(boxes, scores, threshold, max_outputs):
    """The kernel's algorithm in numpy, for ``boxes [P, N, 4]``, ``scores
    [P, N]`` and caps as :func:`nms_reference` takes them."""
    P, n = scores.shape
    counts = TD._counts(max_outputs, P)
    keep = np.full((P, max(counts)), -1, np.int32)
    for p in range(P):
        keys = _model_keys(scores[p])
        live = np.flatnonzero(keys)
        position = (keys[None, :] > keys[live][:, None]).sum(1)
        order = np.empty(live.shape[0], np.int64)
        order[position] = live
        rows = _model_rows(boxes[p][order], threshold)
        words = rows.shape[1]
        removed = np.zeros(words, np.int64)
        if live.shape[0] % 32:
            removed[-1] = FULL >> (live.shape[0] % 32)
        cap, taken = min(counts[p % len(counts)], n), []
        for wi in range(words):
            if len(taken) >= cap:
                break
            # the greedy loop over the word's 32 positions on the rows'
            # own words; a taken box its row leaves free (zero area) is
            # taken again to the cap
            cur, word = int(removed[wi]), []
            for b in range(32):
                if not (cur >> (31 - b)) & 1:
                    pos = 32 * wi + b
                    cur |= int(rows[pos, wi])
                    word.append(pos)
                    if not (int(rows[pos, wi]) >> (31 - b)) & 1:
                        break
            word = word[:cap - len(taken)]
            taken += word
            if word and not (int(rows[word[-1], wi]) >> (31 - word[-1] % 32)
                             ) & 1:
                taken += [word[-1]] * (cap - len(taken))
                break
            for pos in word:
                removed[wi + 1:] |= rows[pos, wi + 1:]
        keep[p, :len(taken)] = order[taken]
    return keep


def _model_and_reference(boxes, scores, threshold, outputs):
    want = TD.nms_reference(torch.from_numpy(boxes),
                            torch.from_numpy(scores), threshold, outputs)
    return nms_model(boxes, scores, threshold, outputs), want.numpy()


@pytest.mark.parametrize("name", sorted(TS.NMS_STREAMS))
def test_nms_model_matches_reference(name):
    """The kernel's algorithm, rehearsed in numpy, keeps the plain loop's
    indices on every chosen stream."""
    boxes, scores, thr, outputs = TS.nms_stream(name)
    got, want = _model_and_reference(boxes[None], scores[None], thr,
                                     outputs)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cycled", [False, True])
def test_nms_model_on_a_padded_batch(cycled):
    """Every stream in one padded batch, a cap per problem, or the batch
    twice over with the caps cycled."""
    boxes, scores, _, outputs = TS.nms_batch(sorted(TS.NMS_STREAMS), seed=3)
    if cycled:
        boxes = np.concatenate([boxes, boxes])
        scores = np.concatenate([scores, scores])
    got, want = _model_and_reference(boxes, scores, 0.5, outputs)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("threshold", TS.NMS_SWEEP_THRESHOLDS)
def test_nms_model_random_sweep(threshold):
    """Seeded random problems of 1 to 1,024 boxes (ties, dead, zero-area
    and copied boxes, caps past N) at each threshold."""
    for boxes, scores, cap in TS.nms_sweep(threshold):
        got, want = _model_and_reference(boxes[None], scores[None],
                                         threshold, cap)
        np.testing.assert_array_equal(got, want, err_msg=f"N={len(scores)}")


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
