"""The port's Mask R-CNN trainer (mass_tpu_torch/perception/maskrcnn_train.py)
against ``mass_tpu.perception.maskrcnn_train`` on the CPU, at the JAX
tests' 64 px, 3-class ``CFG``/``TCFG`` (tests/test_maskrcnn_train.py):
anchor labels, sampling and every target exact; box coding within 1e-6;
rasterisation, the appended gt boxes and the flips exact; one step's five
losses within rtol 1e-4 and every gradient (the batch norms' scale and
bias included) within 1e-4 of the largest, from the same flax-initialised
parameters, batch and key; the parameters and the optimizer state after
one clipped SGD step; optax's schedule; and, port only, ``--resume``,
``--init-checkpoint``, the flags of ``main`` and the trained
``maskrcnn.pth`` in the CLI.  JAX's step compiles once for the file."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mass_tpu.ops.detection import box_iou as jax_box_iou
from mass_tpu.ops.detection import roi_align as jax_roi_align
from mass_tpu.parallel.mesh import make_mesh
from mass_tpu.perception import maskrcnn as JM
from mass_tpu.perception import maskrcnn_train as JT
from mass_tpu_torch import convert
from mass_tpu_torch.perception import maskrcnn as TM
from mass_tpu_torch.perception import maskrcnn_train as TT
from mass_tpu_torch.search import prng
from tests.test_maskrcnn_train import CFG, IMG, NCLS, TCFG, _batch, \
    _write_dataset
from tests.torch_one_thread import one_thread  # noqa: F401

RTOL = 1e-4
# every gradient within GRAD_TOL of the tree's largest |g|: float32 convs
# summed in another order on the CPU than XLA's
GRAD_TOL = 1e-4
# a pooled mask value this close to 0.5 is a tie that rounding decides
MASK_TIE = 1e-6
LEARNING_RATE = 0.0025
BOUNDARIES = {1: 0.1, 2: 0.1}

PCFG = TM.MaskRCNNConfig(**dataclasses.asdict(CFG))
PTCFG = TT.TrainConfig(**dataclasses.asdict(TCFG))


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_model(variables):
    """The trainable port model holding the JAX variables."""
    model = TT.init_maskrcnn(torch.Generator().manual_seed(0), PCFG)
    model.load_state_dict(convert.maskrcnn_state_dict_from_jax(variables),
                          strict=True)
    return model


@pytest.fixture(scope="module")
def jax_step():
    """JAX's jitted training step from flax's initialisation on a batch of
    two scenes (the JAX tests' ``_batch``).  A zero-decay ``optax.trace``
    in front of the trainer's chain passes the gradients on unchanged and
    keeps them in its state."""
    model = JM.MaskRCNN(CFG)
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, IMG, IMG, 3)))
    schedule = optax.piecewise_constant_schedule(LEARNING_RATE, BOUNDARIES)
    tx = optax.chain(optax.trace(0.0), optax.clip_by_global_norm(10.0),
                     optax.sgd(schedule, momentum=0.9))
    run = JT.make_train_step(model, tx, TCFG, make_mesh((1,), ("data",)))
    batch = _batch(np.random.RandomState(0), 2)
    new, opt, losses = run(variables, tx.init(variables["params"]), batch,
                           jax.random.PRNGKey(1))
    return dict(variables=_numpy(variables), new=_numpy(new),
                grads=_numpy(opt[0].trace), opt=_numpy(opt[2]),
                losses={k: float(v) for k, v in losses.items()},
                batch=batch)


@pytest.fixture(scope="module")
def port_loss(jax_step):
    """The port's five losses and gradients from the same parameters,
    batch and key."""
    model = _port_model(jax_step["variables"])
    anchors = TM.device_anchors(PCFG, "cpu")
    images, boxes, classes, masks, valid = (
        torch.from_numpy(np.asarray(x)) for x in jax_step["batch"])
    losses, targets = TT.batch_loss(
        model, PTCFG, anchors, images, boxes, classes.long(), masks,
        valid, prng.PRNGKey(1))
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(losses["total"],
                                [p for _, p in model.named_parameters()])
    return dict(losses={k: float(v.detach()) for k, v in losses.items()},
                grads=dict(zip(names, grads)), targets=targets)


def test_encode_boxes_matches_jax():
    rng = np.random.RandomState(0)
    xy = rng.uniform(0, 60, (2, 50, 2)).astype(np.float32)
    wh = rng.uniform(0, 30, (2, 50, 2)).astype(np.float32)
    wh[:, :5] = 0.0                                   # the 1e-6 floors
    anchors, boxes = (np.concatenate([p, p + s], -1)
                      for p, s in zip(xy, wh))
    for weights in ((1.0, 1.0, 1.0, 1.0), JM.BOX_REG_WEIGHTS):
        got = TM.encode_boxes(torch.from_numpy(anchors),
                              torch.from_numpy(boxes), weights).numpy()
        want = np.asarray(JM.encode_boxes(anchors, boxes, weights))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        back = TM.decode_boxes(torch.from_numpy(anchors),
                               torch.from_numpy(got), weights).numpy()
        np.testing.assert_allclose(back[5:], boxes[5:], atol=1e-3)


def test_rpn_targets_force_positive_and_thresholds():
    """The JAX test's case on the port."""
    anchors = torch.tensor([[0., 0., 10., 10.], [0., 0., 9., 11.],
                            [30., 30., 40., 40.], [100., 100., 110., 110.]])
    gt = torch.tensor([[0., 0., 10., 10.], [31., 31., 39., 39.],
                       [0., 0., 0., 0.]])
    valid = torch.tensor([True, True, False])
    pos, neg, best_gt = TT.rpn_targets(TT.TrainConfig(), anchors, gt, valid)
    assert pos[0] and best_gt[0] == 0
    assert pos[2] and best_gt[2] == 1
    assert neg[3] and not pos[3]


def test_rpn_targets_match_jax():
    """A batch of scenes on the 64 px anchors: labels and matches exact."""
    _, boxes, _, _, valid = _batch(np.random.RandomState(4), 3)
    anchors = np.concatenate(JM.level_anchors(CFG))
    pos, neg, best_gt = TT.rpn_targets(
        PTCFG, torch.from_numpy(anchors), torch.from_numpy(boxes),
        torch.from_numpy(valid))
    for b in range(3):
        want = JT.rpn_targets(TCFG, jnp.asarray(anchors),
                              jnp.asarray(boxes[b]), jnp.asarray(valid[b]))
        for got, w in zip((pos[b], neg[b], best_gt[b]), want):
            np.testing.assert_array_equal(got.numpy(), np.asarray(w))
        assert pos[b].any() and neg[b].any()


@pytest.mark.parametrize("n,k,p", [(5, 4, 0.4), (300, 24, 0.1),
                                   (12543, 12543, 0.9)])
def test_sample_eligible_matches_jax(n, k, p):
    """Indices and weights exact, a stack of keys as ``vmap`` over them;
    over all 12,543 anchors of 224 px, where ``1 + noise`` rounds equal
    values, the whole order (``lax.top_k`` puts the lower index first)."""
    rng = np.random.RandomState(n)
    eligible = rng.rand(3, n) < p
    keys = jax.random.split(jax.random.PRNGKey(n), 3)
    want_i, want_w = jax.vmap(lambda e, key: JT.sample_eligible(e, k, key))(
        jnp.asarray(eligible), keys)
    got_i, got_w = TT.sample_eligible(torch.from_numpy(eligible), k,
                                      prng.split(prng.PRNGKey(n), 3))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    if n == k:
        noise = prng.uniform(prng.split(prng.PRNGKey(n), 3), (n,))
        score = torch.where(torch.from_numpy(eligible), 1.0 + noise, noise)
        top = torch.sort(score, descending=True).values
        assert (top[:, 1:] == top[:, :-1]).any()      # ties decided


@jax.jit
def _jax_image_targets(rpn, boxes, classes, masks, valid, rng):
    """The sampling of JAX's ``image_losses`` on one frame's RPN outputs,
    from its own building blocks."""
    anchors = jnp.concatenate([jnp.asarray(a) for a in
                               JM.level_anchors(CFG)])
    r_obj, r_box, r_roi = jax.random.split(rng, 3)
    pos, neg, best_gt = JT.rpn_targets(TCFG, anchors, boxes, valid)
    pi, pw = JT.sample_eligible(pos, TCFG.rpn_pos_samples, r_obj)
    ni, nw = JT.sample_eligible(neg, TCFG.rpn_neg_samples, r_box)
    proposals, scores = JM.generate_proposals(
        CFG, rpn, JT._split_anchors(CFG, anchors))
    rois = jnp.concatenate([proposals, boxes])
    iou = jnp.where(valid[None], jax_box_iou(rois, boxes), 0.0)
    best, roi_gt = iou.max(1), iou.argmax(1)
    fg = best >= TCFG.roi_fg_iou
    fi, fw = JT.sample_eligible(fg, TCFG.roi_fg_samples, r_roi)
    bi, bw = JT.sample_eligible(~fg, TCFG.roi_bg_samples,
                                jax.random.fold_in(r_roi, 1))
    fg_cls = classes[roi_gt[fi]]
    crop = jax.vmap(lambda m, box: jax_roi_align(
        m[..., None], box[None], TCFG.mask_size)[0, ..., 0])(
            masks[roi_gt[fi]], rois[fi])
    return dict(
        rpn_index=jnp.concatenate([pi, ni]),
        rpn_weight=jnp.concatenate([pw, nw]),
        rpn_box=JM.encode_boxes(anchors[pi], boxes[best_gt[pi]]),
        proposals=proposals, proposal_scores=scores,
        roi_index=jnp.concatenate([fi, bi]),
        roi_weight=jnp.concatenate([fw, bw]),
        roi_label=jnp.concatenate([
            jnp.where(fw > 0, fg_cls, CFG.num_classes),
            jnp.full(bi.shape, CFG.num_classes)]),
        fg_class=fg_cls,
        box_target=JM.encode_boxes(rois[fi], boxes[roi_gt[fi]],
                                   JM.BOX_REG_WEIGHTS),
        mask_crop=crop)


def _jax_targets(rpn, batch, key):
    """:func:`_jax_image_targets` frame by frame, with JAX's key split."""
    _, boxes, classes, masks, valid = (jnp.asarray(x) for x in batch)
    out = [_jax_image_targets([(o[b], d[b]) for o, d in rpn], boxes[b],
                              classes[b], masks[b], valid[b], rng)
           for b, rng in enumerate(jax.random.split(key, boxes.shape[0]))]
    return {k: np.stack([np.asarray(o[k]) for o in out]) for k in out[0]}


def test_targets_match_jax(jax_step):
    """Every sampled index, label, weight and target of a batch, from the
    same RPN outputs (JAX's) and key: exact; the decoded proposals and the
    encoded boxes within 1e-6 (XLA fuses their products), the pooled gt
    masks within 1e-5 and their targets (``>= 0.5``) exact but where the
    pooled value lies within MASK_TIE of 0.5.  There jit's contraction of
    the bilinear products into fused multiply-adds decides: on this batch
    one pixel pools to 0.5 in the port and in eager JAX, and to 0.49999997
    in the jitted step.  The foreground and the appended gt boxes are
    sampled."""
    variables = jax_step["variables"]
    batch = jax_step["batch"]
    model = JM.MaskRCNN(CFG)
    feats = model.apply(variables, jnp.asarray(batch[0]),
                        method=JM.MaskRCNN.features)
    rpn = [model.apply(variables, f, method=JM.MaskRCNN.rpn) for f in feats]
    key = jax.random.PRNGKey(5)
    want = _jax_targets(rpn, batch, key)
    _, boxes, classes, masks, valid = (torch.from_numpy(np.asarray(x))
                                       for x in batch)
    got = TT.sample_targets(
        PCFG, PTCFG, TM.device_anchors(PCFG, "cpu"),
        [(torch.tensor(np.asarray(o)), torch.tensor(np.asarray(d)))
         for o, d in rpn], boxes, classes, masks, valid,
        prng.split(prng.PRNGKey(5), 2))
    for name, w in want.items():
        g = getattr(got, name).numpy()
        assert g.shape == w.shape, name
        if name in ("rpn_box", "proposals", "box_target"):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                       err_msg=name)
        elif name == "mask_crop":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
            flips = (g >= 0.5) != (w >= 0.5)
            assert (np.abs(w[flips] - 0.5) <= MASK_TIE).all()
            assert flips.sum() <= 2, int(flips.sum())
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert (got.roi_weight[:, :PTCFG.roi_fg_samples].sum(1) >= 2).all()
    assert (got.rpn_label.sum(1) > 0).all()
    assert 0 < float((got.mask_crop >= 0.5).float().mean()) < 1


def test_gt_box_appended_makes_foreground():
    """From proposals that miss every gt (a cold RPN), the appended gt box
    is sampled as foreground with its class and a zero box target."""
    gt = torch.zeros(1, TCFG.max_gt, 4)
    gt[0, 0] = torch.tensor([10., 10., 30., 30.])
    valid = torch.zeros(1, TCFG.max_gt, dtype=torch.bool)
    valid[0, 0] = True
    classes = torch.zeros(1, TCFG.max_gt, dtype=torch.int64)
    classes[0, 0] = 2
    masks = torch.zeros(1, TCFG.max_gt, IMG, IMG)
    masks[0, 0, 10:30, 10:30] = 1.0
    proposals = torch.zeros(1, CFG.post_nms_topk, 4)
    roi = TT.roi_samples(PCFG, PTCFG, proposals, gt, classes, masks, valid,
                         prng.PRNGKey(0)[None])
    assert float(roi["roi_iou"].max()) == 1.0
    fg = roi["roi_weight"][0, :PTCFG.roi_fg_samples] > 0
    assert int(fg.sum()) == 1
    slot = int(torch.nonzero(fg)[0, 0])
    assert int(roi["roi_index"][0, slot]) == CFG.post_nms_topk
    assert int(roi["roi_label"][0, slot]) == 2
    assert float(roi["box_target"][0, slot].abs().max()) < 1e-6
    assert bool((roi["mask_crop"][0, slot] >= 0.5).all())


def test_rasterize_record_matches_jax(tmp_path):
    from mass_tpu.tools.detector_dataset import record_from_frame
    sem = np.zeros((IMG, IMG), np.int32)
    sem[10:26, 8:28] = 5
    sem[40:56, 36:52] = 9
    rgb = np.random.RandomState(0).rand(IMG, IMG, 3).astype(np.float32)
    record = record_from_frame(rgb, sem, 0, str(tmp_path))
    got = TT.rasterize_record(record, max_gt=4)
    want = JT.rasterize_record(record, max_gt=4)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[4].sum() == 2


def test_flip_batch_matches_jax():
    batch = _batch(np.random.RandomState(3), 3)
    flip = np.asarray([True, False, True])
    for g, w in zip(TT.flip_batch(batch, flip), JT.flip_batch(batch, flip)):
        np.testing.assert_array_equal(g, w)
    assert not np.array_equal(TT.flip_batch(batch, flip)[0], batch[0])


def test_losses_match_jax(jax_step, port_loss):
    want, got = jax_step["losses"], port_loss["losses"]
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=RTOL,
                                   err_msg=name)
    assert all(v > 0 for v in got.values())


def test_gradients_match_jax(jax_step, port_loss):
    """Every JAX ``params`` leaf, batch norm scale and bias included."""
    want = convert.maskrcnn_params_from_jax(jax_step["grads"])
    got = port_loss["grads"]
    assert sorted(got) == sorted(want)
    scale = max(float(g.abs().max()) for g in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=name)
    norms = [k for k in want if ".norm." in k]
    assert len(norms) == 2 * 53
    assert all(float(want[k].abs().max()) > 0 for k in norms)


def test_sgd_step_matches_jax(jax_step):
    """One clipped SGD step (the gradients' norm is above 10 here): the
    parameters' change within 1e-4 of the largest change, the momentum
    within 1e-4 of the largest, the count 1; the batch norms' statistics
    unchanged, their scale and bias moved."""
    old = jax_step["variables"]
    model = _port_model(old)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = TT.SGD(model.named_parameters(), LEARNING_RATE, BOUNDARIES)
    losses = TT.make_train_step(model, opt, PTCFG)(jax_step["batch"],
                                                   prng.PRNGKey(1))
    np.testing.assert_allclose(float(losses["total"]),
                               jax_step["losses"]["total"], rtol=RTOL)
    want = convert.maskrcnn_state_dict_from_jax(jax_step["new"])
    got = model.state_dict()
    change = max(float((want[k] - before[k]).abs().max()) for k in want)
    assert change > 0
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                   atol=GRAD_TOL * change, err_msg=name)
        if name.endswith(("running_mean", "running_var")):
            assert torch.equal(got[name], before[name]), name
        elif ".norm." in name:
            assert not torch.equal(got[name], before[name]), name
    for a, b in zip(jax.tree_util.tree_leaves(old["batch_stats"]),
                    jax.tree_util.tree_leaves(jax_step["new"]["batch_stats"])):
        np.testing.assert_array_equal(a, b)
    want_opt = convert.maskrcnn_opt_state_from_jax(jax_step["opt"])
    state = opt.state_dict()
    assert state["count"] == want_opt["count"] == 1
    trace = max(float(v.abs().max()) for v in want_opt["momentum"].values())
    for name, w in want_opt["momentum"].items():
        np.testing.assert_allclose(state["momentum"][name].numpy(),
                                   w.numpy(), rtol=0,
                                   atol=GRAD_TOL * trace, err_msg=name)
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                       for g in jax.tree_util.tree_leaves(jax_step["grads"])))
    assert norm > 10.0                       # the clipping branch was taken


@pytest.mark.parametrize("epochs,steps", [(1, 12), (2, 3), (3, 5), (5, 1)])
def test_schedule_matches_optax(epochs, steps):
    """The trainer's boundaries and the schedule's float32 values, across
    every boundary, equal optax's ``piecewise_constant_schedule``."""
    boundaries = TT.schedule_boundaries(epochs, steps)
    assert boundaries == {max((epochs - 2) * steps, 1): 0.1,
                          max((epochs - 1) * steps, 2): 0.1}
    schedule = optax.piecewise_constant_schedule(0.005, boundaries)
    opt = TT.SGD({}, 0.005, boundaries)
    for count in range(epochs * steps + 3):
        want = np.float32(schedule(jnp.int32(count)))
        assert np.float32(opt.rate(count)) == want, count
    assert TT.schedule_boundaries(1, 7) == {1: 0.1, 2: 0.1}


def test_initialiser_matches_flax_statistics():
    """Each weight's standard deviation within 10% of flax's (the smallest
    draws hold 768 values), biases zero, batch norms at identity, every
    frozen norm's scale and bias a parameter."""
    model = TT.init_maskrcnn(torch.Generator().manual_seed(3), PCFG)
    got = model.state_dict()
    want = convert.maskrcnn_state_dict_from_jax(_numpy(JM.MaskRCNN(CFG).init(
        jax.random.PRNGKey(3), jnp.zeros((1, IMG, IMG, 3)))))
    assert sorted(got) == sorted(want)
    params = dict(model.named_parameters())
    for key, w in got.items():
        if key.endswith(("running_mean", "bias")):
            assert torch.equal(w, torch.zeros_like(w)), key
        elif key.endswith("running_var") or ".norm." in key:
            assert torch.equal(w, torch.ones_like(w)), key
        else:
            ratio = w.std().item() / want[key].std().item()
            assert abs(ratio - 1) < 0.1, (key, ratio)
        if ".norm." in key:
            assert (key in params) == key.endswith(("weight", "bias")), key


def _datasets(tmp_path):
    """The JAX tests' six-image dataset, and a perturbed split of it with
    a validation split (its class PNGs) for ``main``."""
    ds = _write_dataset(tmp_path / "ds", 6, seed=0)
    ds2 = _write_dataset(tmp_path / "ds2", 6, seed=3, shift=17)
    with open(os.path.join(ds2, "training.json")) as f:
        records = json.load(f)
    with open(os.path.join(ds2, "validation.json"), "w") as f:
        json.dump(records[:2], f)
    return ds, ds2


def test_resume_continues_and_init_checkpoint_loads_the_weights(tmp_path):
    """``--resume`` restores momentum and the schedule count (6 after two
    epochs of 3 steps, then 12) and the loss goes on from the trained
    level; ``--init-checkpoint`` starts from exactly the saved weights
    with a fresh optimizer, and a class count that differs is refused."""
    ds, ds2 = _datasets(tmp_path)
    run1 = str(tmp_path / "run1")
    kw = dict(batch_size=2, learning_rate=0.02, config=PCFG, tcfg=PTCFG,
              device="cpu")
    _, h1 = TT.train(ds, run1, epochs=2, seed=0, **kw)
    opt_path = os.path.join(run1, "maskrcnn-opt.pth")
    assert torch.load(opt_path, weights_only=True)["count"] == 6
    ckpt = torch.load(os.path.join(run1, "maskrcnn.pth"), weights_only=True)
    assert ckpt["class_offset"] == 1
    assert TM.num_classes_of(ckpt["model"]) == NCLS

    _, h2 = TT.train(ds, run1, epochs=2, seed=1, resume=True, **kw)
    resumed = torch.load(opt_path, weights_only=True)
    assert resumed["count"] == 12
    assert any(float(v.abs().max()) > 0
               for v in resumed["momentum"].values())
    assert h2[0]["total"] < h1[0]["total"], (h1[0], h2[0])

    init = os.path.join(run1, "maskrcnn.pth")
    model, _ = TT.train(ds2, None, epochs=0, seed=7, init_checkpoint=init,
                        **kw)
    saved = torch.load(init, weights_only=True)["model"]
    got = model.state_dict()
    assert sorted(got) == sorted(saved)
    for k, v in saved.items():
        assert torch.equal(got[k], v), k
    ft = str(tmp_path / "ft")
    _, h_ft = TT.train(ds2, ft, epochs=1, seed=0, init_checkpoint=init, **kw)
    assert np.isfinite(h_ft[0]["total"])
    assert torch.load(os.path.join(ft, "maskrcnn-opt.pth"),
                      weights_only=True)["count"] == 3
    other = dataclasses.replace(PCFG, num_classes=NCLS + 1)
    with pytest.raises(ValueError, match=f"{NCLS}-class.*{NCLS + 1} classes"):
        TT.train(ds2, None, epochs=0, init_checkpoint=init,
                 **dict(kw, config=other))


def test_main_flags_and_the_pth_in_the_cli(tmp_path, capsys):
    """``main`` on the CPU with ``--augment --eval-every 1`` (the best
    checkpoint kept, mIoU in the history), ``--eval-only`` with and
    without ``--tta``; the written ``maskrcnn.pth`` runs a small episode
    through the CLI's ``--detector-checkpoint`` with class offset 1."""
    from mass_tpu_torch.agent import cli

    _, ds2 = _datasets(tmp_path)
    logdir = str(tmp_path / "run")
    common = ["--dataset", ds2, "--logdir", logdir, "--image-size",
              str(IMG), "--num-classes", str(NCLS), "--device", "cpu"]
    TT.main(common + ["--epochs", "2", "--batch-size", "2", "--augment",
                      "--eval-every", "1", "--learning-rate", "0.01"])
    with open(os.path.join(logdir, "history.json")) as f:
        history = json.load(f)
    assert [h["epoch"] for h in history] == [0, 1]
    assert all("val_miou" in h for h in history)
    for tta in (False, True):
        metrics = TT.main(common + ["--eval-only", "--detection-threshold",
                                    "0.3"] + (["--tta"] if tta else []))
        assert metrics["tta"] is tta
        assert 0.0 <= metrics["miou"] <= 1.0
        assert 0.0 <= metrics["pixel_accuracy"] <= 1.0
    assert '"tta": true' in capsys.readouterr().out
    path = os.path.join(logdir, "maskrcnn.pth")
    fn, model = TM.load_detector(path, 32, NCLS, "cpu")
    assert model.config.num_classes == NCLS
    det = fn(np.zeros((32, 32, 3), np.float32))
    assert int(det.classes.min()) >= 1                # class offset 1
    metrics = cli.main([
        "--device", "cpu", "--backend", "gridworld", "--camera-size", "32",
        "--map-height", "32", "--map-width", "32", "--map-depth", "8",
        "--grid-resolution", "0.125", "--step-size", "2",
        "--obstacle-padding", "2", "--map-slice-start", "0",
        "--map-slice-stop", "4", "--ground-truth-disagreement",
        "--detector-checkpoint", path, "--detection-threshold", "0.3",
        "--exploration-budget-one", "1", "--exploration-budget-two", "1",
        "--max-goal-steps", "4", "--max-steps", "8", "--num-objects",
        "1", "--num-misplaced", "1", "--num-opened", "0", "--total-tasks",
        "1", "--logdir", str(tmp_path / "episode")])
    assert len(metrics) == 1
