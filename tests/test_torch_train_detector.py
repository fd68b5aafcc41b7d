"""The port's UNet trainer (mass_tpu_torch/perception/train_detector.py)
and detector-dataset tooling (mass_tpu_torch/tools/detector_dataset.py)
against the JAX package on the CPU: class weights and batch order exact,
one step's loss and gradients and one AdamW step within 1e-4 from the
same parameters, the evaluation's confusion counts exact, the generated
dataset equal file for file; and the trained ``segmenter.pth`` runs in
the port's CLI."""

import json
import os

import imageio.v2 as imageio
import jax
import numpy as np
import optax
import pytest
import torch

from mass_tpu.parallel.mesh import make_mesh
from mass_tpu.perception import detector as JDet
from mass_tpu.perception import train_detector as JT
from mass_tpu.tools import detector_dataset as JData
from mass_tpu_torch import convert, taxonomy
from mass_tpu_torch.perception import detector as TDet
from mass_tpu_torch.perception import train_detector as TT
from mass_tpu_torch.tools import detector_dataset as TData

# float32 convs and group norms summed in another order
RTOL = ATOL = 1e-4


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed=0, b=2, size=16):
    rng = np.random.RandomState(seed)
    rgb = rng.rand(b, size, size, 3).astype(np.float32)
    sem = rng.randint(0, taxonomy.NUM_CLASSES, (b, size, size)).astype(
        np.int32)
    sem[:, : size // 2] = 0                     # background dominates
    return rgb, sem


def test_class_weights_match_jax():
    _, sem = _batch(1, b=4, size=24)
    got, want = TT.class_weights(sem), JT.class_weights(sem)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_batches_order_matches_jax():
    images = np.arange(11)[:, None].repeat(2, 1)
    targets = -images
    got = list(TT.batches(images, targets, 4, np.random.RandomState(3)))
    want = list(JT.batches(images, targets, 4, np.random.RandomState(3)))
    assert len(got) == len(want) == 2             # the last 3 are dropped
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def _jax_step(params, tx, rgb, sem, weights):
    model = JDet.SegmenterUNet()
    run = JT.make_train_step(model, tx, make_mesh((1,), ("data",)),
                             weights)
    return run(params, tx.init(params), rgb, sem)


@pytest.mark.parametrize("weighted", [True, False])
def test_loss_and_gradients_match_jax(weighted):
    """The gradient of JAX's step is read off one SGD step of rate 1."""
    rgb, sem = _batch()
    weights = JT.class_weights(sem) if weighted else None
    _, params = JDet.init_segmenter(jax.random.PRNGKey(0), 16)
    params = _numpy(params)
    new, _, want = _jax_step(params, optax.sgd(1.0), rgb, sem, weights)
    grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - b, params,
                                   _numpy(new))
    model = TDet.from_state_dict(convert.unet_state_dict_from_jax(params),
                                 "cpu")
    w = torch.from_numpy(weights if weighted else
                         np.ones(taxonomy.NUM_CLASSES, np.float32))
    loss = TT.weighted_cross_entropy(model, torch.from_numpy(rgb),
                                     torch.from_numpy(sem).long(), w)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=RTOL)
    want_grads = convert.unet_state_dict_from_jax(grads)
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want_grads)
    for key, grad in want_grads.items():
        np.testing.assert_allclose(got[key].grad.numpy(), grad.numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=key)


def test_adamw_step_matches_jax():
    """One step of ``optax.adamw(lr)`` (decay 1e-4 by default) against
    the port's step from the same parameters."""
    rgb, sem = _batch(2)
    weights = JT.class_weights(sem)
    _, params = JDet.init_segmenter(jax.random.PRNGKey(1), 16)
    params = _numpy(params)
    new, _, want = _jax_step(params, optax.adamw(3e-4), rgb, sem, weights)
    model = TDet.from_state_dict(convert.unet_state_dict_from_jax(params),
                                 "cpu")
    opt = torch.optim.AdamW(model.parameters(), 3e-4,
                            weight_decay=TT.WEIGHT_DECAY)
    loss = TT.make_train_step(model, opt, weights)(rgb, sem)
    np.testing.assert_allclose(loss.item(), float(want), rtol=RTOL)
    got = model.state_dict()
    for key, value in convert.unet_state_dict_from_jax(_numpy(new)).items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                   rtol=0, atol=ATOL, err_msg=key)


def test_evaluate_matches_jax():
    """Mean IoU and pixel accuracy come from one confusion matrix of
    counts; on the same parameters and images both packages give the
    same two numbers exactly (batches of 3 over 7 images)."""
    rgb, sem = _batch(3, b=7, size=16)
    model_j, params = JDet.init_segmenter(jax.random.PRNGKey(2), 16)
    params = _numpy(params)
    # a few steps first, so that the argmax is not one class everywhere
    opt = optax.adamw(1e-2)
    for _ in range(3):
        params, _, _ = _jax_step(params, opt, rgb[:2], sem[:2], None)
        params = _numpy(params)
    want = JT.evaluate(model_j, params, rgb, sem, batch_size=3)
    model = TDet.from_state_dict(convert.unet_state_dict_from_jax(params),
                                 "cpu")
    got = TT.evaluate(model, rgb, sem, batch_size=3)
    assert got == want
    assert 0 < got["pixel_accuracy"] < 1


def test_initialiser_matches_flax_statistics():
    """Every conv kernel's std (over four seeded draws: the smallest
    kernel holds 864 values) within 5% of flax's and of 1/sqrt(fan-in),
    the head's bias zero, group norms at ones and zeros."""
    seeds = range(4)
    got = [TDet.init_segmenter(torch.Generator().manual_seed(s)).state_dict()
           for s in seeds]
    want = [convert.unet_state_dict_from_jax(_numpy(JDet.init_segmenter(
        jax.random.PRNGKey(s), 16)[1])) for s in seeds]
    assert sorted(got[0]) == sorted(want[0])
    for key, w in got[0].items():
        if key.endswith("bias"):
            assert torch.equal(w, torch.zeros_like(w)), key
        elif "norm" in key:
            assert torch.equal(w, torch.ones_like(w)), key
        else:
            fan_in = w[0].numel()
            w = torch.stack([sd[key] for sd in got])
            ref = torch.stack([sd[key] for sd in want])
            assert abs(w.std().item() / ref.std().item() - 1) < 0.05, key
            assert abs(w.std().item() * np.sqrt(fan_in) - 1) < 0.05, key


def _relative(record, root):
    return dict(record, file_name=os.path.relpath(record["file_name"], root))


def test_detector_dataset_equals_jax(tmp_path):
    """``generate`` + ``format_dataset`` at camera 32: the same records
    (paths compared relative to each dataset), splits and PNG pixels."""
    roots = {}
    for name, module in (("port", TData), ("jax", JData)):
        root = str(tmp_path / name)
        n = module.generate(root, total_tasks=1, poses_per_scene=3,
                            camera_size=32)
        assert n == 6
        assert module.format_dataset(root, validation_fraction=0.2) == (5, 1)
        roots[name] = root
    port, jax_root = roots["port"], roots["jax"]
    records = []
    for split in ("training", "validation"):
        with open(os.path.join(port, f"{split}.json")) as f:
            got = [_relative(r, port) for r in json.load(f)]
        with open(os.path.join(jax_root, f"{split}.json")) as f:
            want = [_relative(r, jax_root) for r in json.load(f)]
        assert got == want
        records += got
    assert any(r["annotations"] for r in records)
    images = sorted(os.listdir(os.path.join(port, "images")))
    assert images == sorted(os.listdir(os.path.join(jax_root, "images")))
    assert len(images) == 12
    for name in images:
        np.testing.assert_array_equal(
            imageio.imread(os.path.join(port, "images", name)),
            imageio.imread(os.path.join(jax_root, "images", name)))


def test_train_writes_a_segmenter_the_cli_runs(tmp_path, capsys):
    """``main`` on the CPU (``--platform cpu``): history.json and
    segmenter.pth, which ``--detector-arch unet`` runs in a small
    episode through the port's CLI."""
    from mass_tpu_torch.agent import cli

    data = str(tmp_path / "data")
    TData.main(["generate", "--logdir", data, "--total-tasks", "1",
                "--poses-per-scene", "4", "--camera-size", "24"])
    TData.main(["format", "--logdir", data, "--validation-fraction", "0.25"])
    logdir = str(tmp_path / "det")
    TT.main(["--dataset", data, "--logdir", logdir, "--epochs", "2",
             "--batch-size", "2", "--platform", "cpu"])
    with open(os.path.join(logdir, "history.json")) as f:
        history = json.load(f)
    assert [h["epoch"] for h in history] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in history)
    assert "'pixel_accuracy'" in capsys.readouterr().out
    path = os.path.join(logdir, "segmenter.pth")
    model = TDet.load_segmenter(path, "cpu")
    assert model.head.out_channels == taxonomy.NUM_CLASSES
    metrics = cli.main([
        "--device", "cpu", "--backend", "gridworld", "--camera-size", "24",
        "--map-height", "32", "--map-width", "32", "--map-depth", "8",
        "--grid-resolution", "0.125", "--step-size", "2",
        "--obstacle-padding", "2", "--map-slice-start", "0",
        "--map-slice-stop", "4", "--ground-truth-disagreement",
        "--detector-arch", "unet", "--detector-checkpoint", path,
        "--exploration-budget-one", "1", "--exploration-budget-two", "1",
        "--max-goal-steps", "10", "--max-steps", "20", "--num-objects",
        "1", "--num-misplaced", "1", "--num-opened", "0", "--total-tasks",
        "1", "--logdir", str(tmp_path / "run")])
    assert len(metrics) == 1


@pytest.mark.slow
def test_segmenter_training_learns(tmp_path):
    """Mirror of the JAX package's test on the port: a small dataset,
    three epochs on the CPU, the loss falls and pixel accuracy rises
    over the untrained network."""
    TData.generate(str(tmp_path), total_tasks=2, poses_per_scene=6,
                   camera_size=64)
    TData.format_dataset(str(tmp_path), validation_fraction=0.2)
    val = TT.load_split(str(tmp_path), "validation")
    before = TT.evaluate(TDet.init_segmenter(
        torch.Generator().manual_seed(0)), *val)
    model, history = TT.train(str(tmp_path), None, epochs=3, batch_size=4,
                              device="cpu")
    after = TT.evaluate(model, *val)
    assert history[-1]["loss"] < history[0]["loss"]
    assert after["pixel_accuracy"] > before["pixel_accuracy"]
    assert after["pixel_accuracy"] > 0.5
