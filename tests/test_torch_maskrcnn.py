"""The port's Mask R-CNN (``mass_tpu_torch.perception.maskrcnn``) against
``mass_tpu.perception.maskrcnn`` on the same random detectron2-layout
weights (``tests/test_maskrcnn.py``'s generator and small config): the
state-dict layout, every network stage, the proposal stage and the
detection tail fed JAX's own intermediate tensors, and the whole
``detect`` at 64 px and at 48 px (a camera that is not a multiple of 32:
P5's anchors are fewer than its cells) under the margin rule of
``tests/torch_margins.py``."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mass_tpu.ops import detection as JD
from mass_tpu.perception import maskrcnn as JM
from mass_tpu.perception import segmentation as JS
from mass_tpu_torch import convert
from mass_tpu_torch.perception import maskrcnn as TM
from mass_tpu_torch.perception.segmentation import detections_to_semantic
from tests import torch_checkpoints as TC
from tests import torch_margins
from tests.test_maskrcnn import IMG, NCLS, SMALL, _rand_d2_state_dict, \
    _tv_from_d2

# the fusion threshold of these tests: with the tempered random weights
# and 7 classes, a frame's scores lie near 0.21-0.29 at 48 px and
# 0.26-0.45 at 64 px, so detections survive it
THRESHOLD = 0.2


def _port_config(cfg) -> TM.MaskRCNNConfig:
    return TM.MaskRCNNConfig(**{f.name: getattr(cfg, f.name)
                                for f in dataclasses.fields(cfg)})


@pytest.fixture(scope="module")
def raw():
    """Untempered random weights (``_rand_d2_state_dict``), as JAX's own
    torch-forward tests use them: the JAX variables and the port's
    module."""
    sd = _rand_d2_state_dict(np.random.RandomState(0))
    variables = JM.params_from_detectron2(sd, SMALL)
    return sd, variables, TM.from_state_dict(sd, _port_config(SMALL), "cpu")


def _tempered(side):
    sd = TC.random_maskrcnn_state_dict(0, NCLS)
    cfg = dataclasses.replace(SMALL, image_size=side)
    return (sd, cfg, JM.params_from_detectron2(sd, cfg),
            TM.from_state_dict(sd, _port_config(cfg), "cpu"))


@pytest.fixture(scope="module")
def tempered64():
    return _tempered(IMG)


@pytest.fixture(scope="module")
def tempered48():
    return _tempered(48)


def _rgb(seed, side):
    return np.random.RandomState(seed).rand(side, side, 3).astype(np.float32)


def test_state_dict_layout_is_detectron2s(raw):
    sd, variables, model = raw
    assert set(model.state_dict()) == set(sd)
    out = convert.maskrcnn_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables))
    assert set(out) == set(sd)
    for k, v in out.items():
        assert torch.equal(v, sd[k]), k
    # the random generator draws _rand_d2_state_dict's numbers
    untempered = TC.random_maskrcnn_state_dict(0, NCLS, tempered=False)
    assert all(torch.equal(untempered[k], sd[k]) for k in sd)


def _close(a, b, msg):
    # JAX's own torch-forward test's tolerance: random unnormalised
    # weights blow activations up to ~1e5, so fp32 noise is relative
    atol = 1e-5 * float(np.abs(b).max()) + 1e-6
    np.testing.assert_allclose(a, b, atol=atol, rtol=1e-3, err_msg=msg)


def test_network_stages_match_jax(raw):
    sd, variables, model = raw
    jmodel = JM.MaskRCNN(SMALL)
    rgb = _rgb(1, IMG)
    jfeats = jmodel.apply(variables, jnp.asarray(rgb)[None],
                          method=JM.MaskRCNN.features)
    with torch.no_grad():
        feats = model.features(torch.from_numpy(rgb)[None])
        assert len(feats) == 5
        for i, (jf, tf) in enumerate(zip(jfeats, feats)):
            _close(tf.numpy(), np.asarray(jf), f"P{i + 2}")
        obj, deltas = model.rpn(torch.tensor(np.asarray(jfeats[0])))
        jobj, jdeltas = jmodel.apply(variables, jfeats[0],
                                     method=JM.MaskRCNN.rpn)
        _close(obj.numpy(), np.asarray(jobj), "rpn obj")
        _close(deltas.numpy(), np.asarray(jdeltas), "rpn deltas")

        rng = np.random.RandomState(2)
        rois7 = rng.normal(0, 1, (5, 7, 7, 256)).astype(np.float32)
        rois14 = rng.normal(0, 1, (5, 14, 14, 256)).astype(np.float32)
        logits, bdeltas = model.box(torch.from_numpy(rois7))
        jlogits, jbdeltas = jmodel.apply(variables, jnp.asarray(rois7),
                                         method=JM.MaskRCNN.box)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=2e-4, rtol=1e-4)
        np.testing.assert_allclose(bdeltas.numpy(), np.asarray(jbdeltas),
                                   atol=2e-4, rtol=1e-4)
        masks = model.masks(torch.from_numpy(rois14))
        jmasks = jmodel.apply(variables, jnp.asarray(rois14),
                              method=JM.MaskRCNN.masks)
        np.testing.assert_allclose(masks.numpy(), np.asarray(jmasks),
                                   atol=2e-4, rtol=1e-4)


def test_torchvision_checkpoint_loads_as_detectron2(raw, tmp_path):
    """A torchvision-named, background-first file re-keys to the same
    tensors and loads with torchvision's preprocessing and stride."""
    sd, _, _ = raw
    tv = _tv_from_d2(sd)
    again = TM.state_dict_from_torchvision(tv)
    assert set(again) == set(sd)
    assert all(torch.equal(again[k], sd[k]) for k in sd)
    path = str(tmp_path / "tv.pth")
    torch.save(tv, path)
    loaded, cfg, offset = TM.load_torch_checkpoint(path, _port_config(SMALL))
    assert offset == 0 and cfg == _port_config(SMALL).torchvision_style()
    model = TM.from_state_dict(loaded, cfg, "cpu")
    jcfg = SMALL.torchvision_style()
    jvars = JM.params_from_torchvision_maskrcnn(tv, jcfg)
    rgb = _rgb(6, IMG)
    jfeats = JM.MaskRCNN(jcfg).apply(jvars, jnp.asarray(rgb)[None],
                                     method=JM.MaskRCNN.features)
    with torch.no_grad():
        feats = model.features(torch.from_numpy(rgb)[None])
    for i, (jf, tf) in enumerate(zip(jfeats, feats)):
        _close(tf.numpy(), np.asarray(jf), f"P{i + 2}")


def _jax_rpn(cfg, variables, rgb):
    jmodel = JM.MaskRCNN(cfg)
    feats = jmodel.apply(variables, jnp.asarray(rgb)[None],
                         method=JM.MaskRCNN.features)
    rpn = [jmodel.apply(variables, f, method=JM.MaskRCNN.rpn)
           for f in feats]
    return jmodel, feats, [(o[0], d[0]) for o, d in rpn]


@pytest.mark.parametrize("side", [IMG, 48])
def test_generate_proposals_matches_jax(side, tempered64, tempered48):
    """Fed JAX's own RPN outputs: the same proposals (scores exact, boxes
    within 1e-6 relative).  At 48 px P5 has 2x2 cells and 1x1 anchors:
    the index past the table is clamped, as XLA clamps it."""
    sd, cfg, variables, _ = tempered64 if side == IMG else tempered48
    _, _, rpn = _jax_rpn(cfg, variables, _rgb(3, side))
    anchors = [jnp.asarray(a) for a in JM.level_anchors(cfg)]
    jboxes, jscores = JM.generate_proposals(cfg, rpn, anchors)
    pcfg = _port_config(cfg)
    boxes, scores = TM.generate_proposals(
        pcfg, [(torch.tensor(np.asarray(o)),
                torch.tensor(np.asarray(d))) for o, d in rpn],
        TM.device_anchors(pcfg, "cpu"))
    np.testing.assert_array_equal(scores.numpy(), np.asarray(jscores))
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jboxes),
                               rtol=1e-6, atol=1e-6)
    assert np.isfinite(np.asarray(jscores)).sum() > 10
    if side == 48:
        level5 = np.asarray(rpn[3][0])
        assert level5.size > JM.level_anchors(cfg)[3].shape[0]


def _jax_tail(cfg, proposals, pscores, logits, deltas):
    """``mass_tpu.perception.maskrcnn.detect``'s lines from the box head's
    outputs to the detections' boxes, scores and classes, in JAX."""
    c = cfg
    probs = jax.nn.softmax(logits, axis=-1)[:, :c.num_classes]
    probs = jnp.where(jnp.isfinite(pscores)[:, None], probs, 0.0)
    boxes_c = JM.clip_boxes(JM.decode_boxes(
        proposals[:, None, :], deltas, JM.BOX_REG_WEIGHTS), c.image_size)
    flat = probs.reshape(-1)
    top, idx = jax.lax.top_k(flat, min(c.candidate_pool, flat.shape[0]))
    cls = (idx % c.num_classes).astype(jnp.int32)
    cand = boxes_c.reshape(-1, 4)[idx]
    top = jnp.where(top >= c.score_threshold, top, -jnp.inf)
    degenerate = ((cand[:, 2] - cand[:, 0] < 1e-3) |
                  (cand[:, 3] - cand[:, 1] < 1e-3))
    top = jnp.where(degenerate, -jnp.inf, top)
    offset = cls.astype(jnp.float32)[:, None] * (c.image_size + 2.0)
    keep = JD.nms(cand + offset, top, c.nms_threshold, c.max_detections)
    safe = jnp.maximum(keep, 0)
    scores = jnp.where(keep >= 0, top[safe], -jnp.inf)
    scores = jnp.where(jnp.isfinite(scores), scores, 0.0)
    return cand, top, cls, cand[safe], scores, cls[safe]


def test_detection_tail_matches_jax(tempered64):
    """Fed JAX's proposals and box-head outputs: the same candidates,
    classes and kept detections (indices exact, boxes within 1e-6)."""
    sd, cfg, variables, _ = tempered64
    jmodel, feats, rpn = _jax_rpn(cfg, variables, _rgb(4, IMG))
    anchors = [jnp.asarray(a) for a in JM.level_anchors(cfg)]
    proposals, pscores = JM.generate_proposals(cfg, rpn, anchors)
    rois = JM.multilevel_roi_align([f[0] for f in feats], proposals, 7)
    logits, deltas = jmodel.apply(variables, rois, method=JM.MaskRCNN.box)
    want = _jax_tail(cfg, proposals, pscores, logits, deltas)
    pcfg = _port_config(cfg)
    t = [torch.from_numpy(np.asarray(x))[None]
         for x in (proposals, pscores, logits, deltas)]
    cand, top, cls = TM.box_candidates(pcfg, *t)
    got = (cand, top, cls) + TM.select_detections(pcfg, cand, top, cls)
    for name, w, g in zip(("cand", "top", "cls", "boxes", "scores",
                           "classes"), want, got):
        g = g[0].numpy()
        if g.dtype.kind in "iu":
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
        else:
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6,
                                       atol=1e-6, err_msg=name)
    assert (got[4][0] > 0).sum() > 0


@pytest.mark.parametrize("side", [IMG, 48])
def test_full_detect_matches_jax(side, tempered64, tempered48):
    """The whole ``detect`` on one frame by the margin rule: classes,
    scores (within 1e-4) and masks exact except where the deciding value
    lies within 1e-4 of its threshold or rival; the fused image (at the
    tests' threshold, where detections survive) equal except there."""
    sd, cfg, variables, model = tempered64 if side == IMG else tempered48
    rgb = _rgb(5, side)
    jdet = JM.make_detector(variables, cfg)(jnp.asarray(rgb))
    jdet = type(jdet)(*(np.asarray(x) for x in jdet))
    det, probs = TM.detect(model, torch.from_numpy(rgb),
                                  TM.device_anchors(model.config, "cpu"),
                                  with_probs=True)
    report = torch_margins.compare_detections(
        det, jdet, probs, thresholds=(cfg.score_threshold,))
    print(f"{side} px: {report}")
    assert report["ok"], report
    assert report["live_slots"] > 0
    sem = detections_to_semantic(det, THRESHOLD, NCLS + 1)
    jsem = torch.from_numpy(np.asarray(JS.detections_to_semantic(
        jdet, THRESHOLD, NCLS + 1)))
    fused = int((sem > 0).sum())
    print(f"{side} px: {fused} fused non-zero pixels at {THRESHOLD}")
    assert fused > 0
    differing, unexplained = torch_margins.compare_semantic(
        sem, jsem, det, probs, THRESHOLD)
    assert unexplained == 0, (differing, unexplained)


def test_detect_batch_equals_frames(tempered48):
    """Two frames in one call give each frame's own detections (the
    fleet's batched sensor), by the margin rule."""
    _, cfg, _, model = tempered48
    anchors = TM.device_anchors(model.config, "cpu")
    frames = np.stack([_rgb(7, 48), _rgb(8, 48)])
    batch, probs = TM.detect(model, torch.from_numpy(frames),
                                    anchors, with_probs=True)
    for b in range(2):
        one = TM.detect(model, torch.from_numpy(frames[b]), anchors)
        part = type(batch)(*(x[b] for x in batch))
        report = torch_margins.compare_detections(part, one, probs[b])
        assert report["ok"], report


def test_load_detector_reads_class_count_and_offset(tmp_path):
    sd = TC.random_maskrcnn_state_dict(1, 53)
    path = str(tmp_path / "det.pth")
    torch.save({"model": sd, "class_offset": 1}, path)
    run, model = TM.load_detector(path, 48, device="cpu")
    assert model.config.num_classes == 53
    det = run(np.zeros((48, 48, 3), np.float32))
    assert det.masks.shape == (64, 48, 48)
    live = det.scores > 0
    assert (det.classes[live] >= 1).all()            # offset applied
    with pytest.raises(ValueError):
        TM.load_detector(path, 48, num_classes=54, device="cpu")
    with pytest.raises(FileNotFoundError):
        TM.load_torch_checkpoint(str(tmp_path / "missing.pth"))
