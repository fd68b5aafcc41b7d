"""The port's data-parallel trainers (``utils/training.Replicas`` under
search/train.py's ``fit(data_parallel=True)``, perception/
train_detector.py and perception/maskrcnn_train.py) on ``["cpu"] * n``
against the port's one-device step and the JAX package's mesh step over
n of the 8 virtual CPU devices of tests/conftest.py, at the tolerances of
tests/test_torch_search_train.py, test_torch_train_detector.py and
test_torch_maskrcnn_train.py; two data-parallel runs are bit-equal."""

import copy
import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mass_tpu.parallel.mesh import make_mesh as jmake_mesh
from mass_tpu_torch import convert
from mass_tpu_torch.utils.training import Replicas, largest_divisor
from tests.torch_one_thread import one_thread  # noqa: F401

RTOL = ATOL = 1e-4
# every Mask R-CNN gradient within GRAD_TOL of the tree's largest |g|
GRAD_TOL = 1e-4


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cpus(n):
    return ["cpu"] * n


# ----------------------------------------------------------------------
# the replicas themselves
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4])
def test_mean_of_shard_means_is_the_batch_mean(n):
    """With equal shards, the replicas' mean of their shards' mean losses
    and gradients is the batch's mean: the gradients within float32
    rounding of one full-batch backward; the replicas get replica 0's
    parameters before the step, and the sum runs in device order."""
    gen = torch.Generator().manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(5, 7), torch.nn.Tanh(),
                                torch.nn.Linear(7, 1))
    x = torch.randn(8, 5, generator=gen)
    y = torch.randn(8, 1, generator=gen)

    def losses(m, x, y):
        per_item = (m(x) - y).square()[:, 0]
        return {"total": per_item.mean(), "max": per_item.max()}

    want = losses(model, x, y)["total"]
    want_grads = torch.autograd.grad(want, list(model.parameters()))
    replicas = Replicas(model, _cpus(n))
    with torch.no_grad():
        for replica in replicas.modules[1:]:
            replica[0].weight.add_(1.0)          # stale until broadcast
    got, grads = replicas.grads(losses, x, y)
    torch.testing.assert_close(got["total"], want.detach(), rtol=1e-6,
                               atol=0)
    for g, w in zip(grads, want_grads):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-7)
    # the replicas' mean, each over its own shard, in device order
    shard_max = [losses(model, *s)["max"] for s in replicas.shards(x, y)]
    total = shard_max[0]
    for v in shard_max[1:]:
        total = total + v
    assert torch.equal(got["max"], (total / n).detach())
    if n == 4:
        with pytest.raises(ValueError, match="a batch of 6 does not split "
                                             "over 4 replicas"):
            replicas.grads(losses, x[:6], y[:6])


def test_largest_divisor_and_the_module_device(monkeypatch):
    """``largest_divisor``; ``data_devices`` counts CUDA cards from the
    given card's index on (four cards stood in for), the CPU as any
    number; the UNet trainer defaults to its one device."""
    from mass_tpu_torch.parallel import mesh as M
    from mass_tpu_torch.perception import train_detector as TT
    from mass_tpu_torch.utils import training

    assert [largest_divisor(8, k) for k in (1, 3, 5, 8, 16)] == \
        [1, 2, 4, 8, 8]
    assert largest_divisor(6, 4) == 3
    with pytest.raises(ValueError, match="lies on cpu, the data axis "
                                         "starts at meta"):
        Replicas(torch.nn.Linear(2, 2), ["meta", "cpu"])
    cpu = torch.device("cpu")
    assert training.data_devices("cpu") == [cpu]
    assert training.data_devices("cpu", 3) == [cpu] * 3
    cards = [torch.device("cuda", i) for i in range(4)]
    for module in (M, training):
        monkeypatch.setattr(module, "cuda_devices", lambda: cards)
    assert training.data_devices("cuda:1") == cards[1:]
    assert training.data_devices("cuda:1", 2) == cards[1:3]
    with pytest.raises(ValueError, match="mesh of 3 CUDA devices "
                                         "requested, 2 available"):
        training.data_devices("cuda:2", 3)

    class Stop(Exception):
        pass

    def stop(*args):
        raise Stop(args[-1])
    monkeypatch.setattr(TT, "make_train_step", stop)
    monkeypatch.setattr(TT, "load_split", lambda d, s: (
        np.zeros((2, 8, 8, 3), np.uint8), np.zeros((2, 8, 8), np.int32)))
    with pytest.raises(Stop) as got:
        TT.train("unused", None, batch_size=2, device="cpu")
    assert got.value.args[0] == [cpu]


# ----------------------------------------------------------------------
# the search policy: fit(data_parallel=True)
# ----------------------------------------------------------------------

LOG = re.compile(r"step (\d+)/\d+: train NLL (\S+)  val NLL (\S+)  "
                 r"val argmax-dist (\S+) cells")


def _policy_dataset(d):
    """tests/test_policy.py's data-parallel dataset: 4 tasks of 16x16x3
    snapshots."""
    rng = np.random.RandomState(0)
    d.mkdir()
    for tid in range(4):
        np.savez_compressed(
            d / f"task-{tid}.npz",
            tops0=rng.uniform(size=(2, 16, 16, 3)).astype(np.float16),
            cells0=rng.randint(0, 16, (1, 2)).astype(np.int32),
            tops1=rng.uniform(size=(1, 16, 16, 3)).astype(np.float16),
            cells1=rng.randint(0, 16, (1, 2)).astype(np.int32))


def test_fit_data_parallel_matches_jax(tmp_path, monkeypatch, capsys):
    """tests/test_policy.py's ``fit(data_parallel=True)`` (batch 8, 12
    steps) on 8 replicas against JAX's on its 8 devices, from the same
    initial parameters: the logged validation NLLs and the returned ones
    within the fit parity tolerances, the logits up to the last conv's
    constant (tests/test_torch_search_train.py::test_fit_matches_jax
    says why, and why the learning rate is 1e-4 there and here); and
    equal, within rounding, to the port's one-device fit."""
    from mass_tpu.search import policy as JP
    from mass_tpu.search import train as JT
    from mass_tpu.utils.checkpoint import load_pytree
    from mass_tpu_torch.search import policy as TP
    from mass_tpu_torch.search import train as TT

    d = tmp_path / "data"
    _policy_dataset(d)
    kw = dict(steps=12, batch_size=8, val_fraction=0.25, log_every=6,
              learning_rate=1e-4)
    # JAX's fit starts from init_params(PRNGKey(seed)); the port from it
    init = _numpy(JP.init_params(jax.random.PRNGKey(0), 16, 16, 3))
    want = JT.fit(str(d), str(tmp_path / "ckpt"), data_parallel=True, **kw)
    jax_log = capsys.readouterr().out
    monkeypatch.setattr(TP, "init_policy", lambda generator, channels:
                        convert.policy_from_jax(init, "cpu"))
    runs = []
    for devices in (_cpus(8), _cpus(8), None):
        out = str(tmp_path / f"port-{len(runs)}.pth")
        got = TT.fit(str(d), out, data_parallel=devices is not None,
                     devices=devices, device="cpu", **kw)
        runs.append((got, capsys.readouterr().out,
                     torch.load(out, map_location="cpu", weights_only=True)))
    (got, port_log, state), again, single = runs
    assert "data-parallel over 8 devices" in jax_log
    assert "data-parallel over 8 devices" in port_log
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    jl, pl = LOG.findall(jax_log), LOG.findall(port_log)
    assert [r[0] for r in pl] == [r[0] for r in jl] == ["1", "6", "12"]
    np.testing.assert_allclose(np.asarray(pl, float)[:, 1:],
                               np.asarray(jl, float)[:, 1:], atol=1.5e-3)
    # two data-parallel fits: the same bits; one device: rounding apart
    assert again[0] == got
    assert all(torch.equal(state[k], again[2][k]) for k in state)
    np.testing.assert_allclose(single[0], got, rtol=RTOL, atol=ATOL)
    x = np.random.RandomState(9).rand(2, 16, 16, 3).astype(np.float32)
    got_logits = np.asarray(JP.goal_logits(
        JP.load_reference_policy(str(tmp_path / "port-0.pth")), x))
    want_logits = np.asarray(JP.goal_logits(
        _numpy(load_pytree(str(tmp_path / "ckpt"))), x))
    shift = (got_logits - want_logits).mean(axis=1, keepdims=True)
    assert abs(shift).max() <= kw["steps"] * kw["learning_rate"]
    np.testing.assert_allclose(got_logits - shift, want_logits, rtol=RTOL,
                               atol=ATOL)
    assert TP.input_channels(TP.from_state_dict(state, "cpu")) == 3


def test_conditioned_data_parallel_fit_assembles_batches_on_the_host(
        tmp_path, monkeypatch):
    """JAX's rule: ``data_parallel`` turns off the on-device batch
    assembly of a square conditioned fit; ``--data-parallel 2`` on the CPU
    trains two replicas."""
    from mass_tpu_torch.search import train as TT

    d = tmp_path / "data"
    _policy_dataset(d)

    def refuse(*args):
        raise AssertionError("batches assembled on the device")
    monkeypatch.setattr(TT, "_assemble_conditioned", refuse)
    TT.main(["--data", str(d), "--out", str(tmp_path / "p.pth"),
             "--steps", "2", "--batch-size", "4", "--conditioned",
             "--data-parallel", "2", "--device", "cpu"])
    state = torch.load(tmp_path / "p.pth", weights_only=True)
    assert state["0.weight"].shape[1] == 6


# ----------------------------------------------------------------------
# the UNet segmenter
# ----------------------------------------------------------------------

def _unet_batch(b=4, size=16):
    from mass_tpu_torch import taxonomy

    rng = np.random.RandomState(0)
    rgb = rng.rand(b, size, size, 3).astype(np.float32)
    sem = rng.randint(0, taxonomy.NUM_CLASSES, (b, size, size)).astype(
        np.int32)
    sem[:, : size // 2] = 0
    return rgb, sem


@pytest.fixture(scope="module")
def unet_start():
    from mass_tpu.perception import detector as JDet
    from mass_tpu.perception import train_detector as JT

    rgb, sem = _unet_batch()
    _, params = JDet.init_segmenter(jax.random.PRNGKey(0), 16)
    return dict(params=_numpy(params), rgb=rgb, sem=sem,
                weights=JT.class_weights(sem))


def _port_unet_grads(start, devices):
    """The port step's gradients, read off one SGD step of rate 1."""
    from mass_tpu_torch.perception import detector as TDet
    from mass_tpu_torch.perception import train_detector as TT

    model = TDet.from_state_dict(
        convert.unet_state_dict_from_jax(start["params"]), "cpu")
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    step = TT.make_train_step(model, torch.optim.SGD(model.parameters(),
                                                     1.0),
                              start["weights"], devices)
    loss = step(start["rgb"], start["sem"])
    return loss.item(), {k: before[k] - v.detach()
                         for k, v in model.named_parameters()}


@pytest.mark.parametrize("n", [2, 4])
def test_unet_step_matches_one_device_and_jax_mesh(unet_start, n):
    """The UNet step on n replicas against the port's one-device step and
    JAX's step on an n-device ``data`` mesh: loss and every gradient
    within 1e-4."""
    from mass_tpu.perception import detector as JDet
    from mass_tpu.perception import train_detector as JT

    params = unet_start["params"]
    run = JT.make_train_step(JDet.SegmenterUNet(), optax.sgd(1.0),
                             jmake_mesh((n,), ("data",)),
                             unet_start["weights"])
    new, _, want = run(params, optax.sgd(1.0).init(params),
                       unet_start["rgb"], unet_start["sem"])
    want_grads = convert.unet_state_dict_from_jax(jax.tree_util.tree_map(
        lambda a, b: np.asarray(a) - b, params, _numpy(new)))
    one_loss, one = _port_unet_grads(unet_start, None)
    loss, grads = _port_unet_grads(unet_start, _cpus(n))
    np.testing.assert_allclose(loss, float(want), rtol=RTOL)
    np.testing.assert_allclose(loss, one_loss, rtol=RTOL)
    assert sorted(grads) == sorted(want_grads)
    for key, grad in grads.items():
        np.testing.assert_allclose(grad.numpy(), want_grads[key].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=key)
        np.testing.assert_allclose(grad.numpy(), one[key].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=key)


def test_unet_train_takes_the_largest_divisor(tmp_path, monkeypatch):
    """``train`` splits a batch of 4 over 2 of 3 devices (the largest
    divisor of the batch within the count), and two runs save equal
    ``segmenter.pth`` files bit for bit."""
    from mass_tpu_torch.perception import train_detector as TT

    rgb, sem = _unet_batch(b=6)
    split = dict(training=(rgb[:4], sem[:4]), validation=(rgb[4:], sem[4:]))
    monkeypatch.setattr(TT, "load_split", lambda d, s: split[s])
    used = []
    make = TT.make_train_step

    def recording(model, opt, weights=None, devices=None):
        used.append(devices)
        return make(model, opt, weights, devices)
    monkeypatch.setattr(TT, "make_train_step", recording)
    states = []
    for k in range(2):
        TT.train("unused", str(tmp_path / str(k)), epochs=1, batch_size=4,
                 devices=_cpus(3))
        states.append(torch.load(tmp_path / str(k) / "segmenter.pth",
                                 weights_only=True))
    assert used == [_cpus(2), _cpus(2)]
    assert all(torch.equal(states[0][k], states[1][k]) for k in states[0])


# ----------------------------------------------------------------------
# the Mask R-CNN
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_variables():
    """JAX's flax initialisation of the JAX tests' 64 px, 3-class
    Mask R-CNN (jitted: eager init takes half a minute)."""
    from mass_tpu.perception import maskrcnn as JM
    from tests.test_maskrcnn_train import CFG, IMG

    model = JM.MaskRCNN(CFG)
    return model, _numpy(jax.jit(model.init)(jax.random.PRNGKey(0),
                                             jnp.zeros((1, IMG, IMG, 3))))


@functools.lru_cache(maxsize=None)
def _port_base():
    """The port's trainable model at the JAX tests' config, made once
    (each run loads JAX's parameters into a copy)."""
    from mass_tpu_torch.perception import maskrcnn as TM
    from mass_tpu_torch.perception import maskrcnn_train as TT
    from tests.test_maskrcnn_train import CFG

    return TT.init_maskrcnn(torch.Generator().manual_seed(0),
                            TM.MaskRCNNConfig(**dataclasses.asdict(CFG)))


def _jax_mesh_step(n, batch):
    """JAX's trainer step on an n-device mesh; the gradients through a
    zero-decay ``optax.trace`` (tests/test_torch_maskrcnn_train.py)."""
    from mass_tpu.perception import maskrcnn_train as JT
    from tests.test_maskrcnn_train import TCFG, _batch

    model, variables = _jax_variables()
    tx = optax.chain(optax.trace(0.0), optax.clip_by_global_norm(10.0),
                     optax.sgd(0.0025, momentum=0.9))
    run = JT.make_train_step(model, tx, TCFG, jmake_mesh((n,), ("data",)))
    _, opt, losses = run(variables, tx.init(variables["params"]),
                         _batch(np.random.RandomState(0), batch),
                         jax.random.PRNGKey(1))
    return ({k: float(v) for k, v in losses.items()},
            convert.maskrcnn_params_from_jax(_numpy(opt[0].trace)))


def _port_maskrcnn(batch, devices):
    """The port's step from JAX's initialisation on the JAX tests' batch
    and key (tests/test_torch_maskrcnn_train.py's start): its losses, the
    gradients the optimizer received and the parameters after."""
    from mass_tpu_torch.perception import maskrcnn_train as TT
    from mass_tpu_torch.search import prng
    from tests.test_maskrcnn_train import TCFG, _batch

    model = copy.deepcopy(_port_base())
    model.load_state_dict(convert.maskrcnn_state_dict_from_jax(
        _jax_variables()[1]))
    opt = TT.SGD(model.named_parameters(), 0.0025)
    seen = {}
    inner = opt.step

    def keep(grads):
        grads = list(grads)
        seen.update(zip(opt.params, grads))
        inner(grads)
    opt.step = keep
    step = TT.make_train_step(
        model, opt, TT.TrainConfig(**dataclasses.asdict(TCFG)), devices)
    losses = step(_batch(np.random.RandomState(0), batch), prng.PRNGKey(1))
    return ({k: float(v) for k, v in losses.items()}, seen,
            {k: v.clone() for k, v in model.state_dict().items()})


@functools.lru_cache(maxsize=None)
def _port_step(batch, replicas):
    """:func:`_port_maskrcnn` on ``replicas`` CPU replicas (one: the
    one-device step), made once for the tests that compare it."""
    return _port_maskrcnn(batch, _cpus(replicas) if replicas > 1 else None)


def _close_maskrcnn(got, want):
    (got_losses, got_grads), (want_losses, want_grads) = got, want
    assert sorted(got_losses) == sorted(want_losses)
    for name in want_losses:
        np.testing.assert_allclose(got_losses[name], want_losses[name],
                                   rtol=RTOL, err_msg=name)
    assert sorted(got_grads) == sorted(want_grads)
    scale = max(float(g.abs().max()) for g in want_grads.values())
    for name, w in want_grads.items():
        np.testing.assert_allclose(got_grads[name].numpy(), w.numpy(),
                                   rtol=0, atol=GRAD_TOL * scale,
                                   err_msg=name)


@pytest.mark.parametrize("n", [2, 4])
def test_maskrcnn_step_matches_one_device(n):
    """The Mask R-CNN step on n replicas (batch n, one frame a replica,
    each taking its frame's key of the batch's split and making its own
    NMS launch) against the port's one-device step: the five losses and
    total within rtol 1e-4, every gradient within 1e-4 of the largest;
    two data-parallel steps (2 replicas) give the same parameters bit for
    bit."""
    losses, grads, params = _port_step(n, n)
    one_losses, one_grads, _ = _port_step(n, 1)
    _close_maskrcnn((losses, grads), (one_losses, one_grads))
    if n == 2:
        again = _port_maskrcnn(n, _cpus(n))
        assert again[0] == losses
        assert all(torch.equal(params[k], again[2][k]) for k in params)


@pytest.mark.parametrize("n", [2, pytest.param(4, marks=pytest.mark.slow)])
def test_maskrcnn_step_matches_jax_mesh(n):
    """The same step against JAX's on an n-device ``data`` mesh
    (tests/test_maskrcnn_train.py's mesh step); each JAX mesh compiles
    for about 25 s, so the 4-device case is ``slow``."""
    _close_maskrcnn(_port_step(n, n)[:2], _jax_mesh_step(n, n))
