"""The port's search-policy trainer (mass_tpu_torch/search/train.py)
against mass_tpu.search.train on the CPU: the loss and its gradients, one
Adam and one AdamW step, the dihedral augmentations (exact), both dataset
loaders (exact), and ``fit`` on the host path and on the device path from
the same initial parameters, whose saved .pth JAX's own reader loads."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mass_tpu.search import policy as JP
from mass_tpu.search import train as JT
from mass_tpu.utils.checkpoint import load_pytree
from mass_tpu_torch import convert
from mass_tpu_torch.search import policy as TP
from mass_tpu_torch.search import train as TT

# float32 convs and group norms summed in another order (flax's norm
# takes E[x^2] - E[x]^2, torch's does not), as for the policy's logits
RTOL = ATOL = 1e-4


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inject(monkeypatch, params):
    """Make the port's initialiser return the JAX package's parameters."""
    monkeypatch.setattr(TP, "init_policy", lambda generator, channels:
                        convert.policy_from_jax(params, "cpu"))


def _batch(seed=0, h=12, w=16, c=54, b=3):
    rng = np.random.RandomState(seed)
    x = rng.rand(b, h, w, c).astype(np.float32)
    g = np.stack([rng.randint(0, w, b), rng.randint(0, h, b)],
                 -1).astype(np.int32)
    return x, g


@pytest.mark.parametrize("sigma", [0.0, 2.0])
def test_goal_cross_entropy_and_gradients_match_jax(sigma):
    params = _numpy(JP.init_params(jax.random.PRNGKey(0), 12, 16, 54))
    x, g = _batch()
    want, grads = jax.value_and_grad(JT.goal_cross_entropy)(
        params, jnp.asarray(x), jnp.asarray(g), sigma)
    policy = convert.policy_from_jax(params, "cpu")
    loss = TT.goal_cross_entropy(policy, torch.from_numpy(x),
                                 torch.from_numpy(g), sigma)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=RTOL,
                               atol=ATOL)
    want_grads = convert.policy_state_dict_from_jax(_numpy(grads))
    got = dict(policy.named_parameters())
    assert sorted(got) == sorted(want_grads)
    for key, grad in want_grads.items():
        np.testing.assert_allclose(got[key].grad.numpy(), grad.numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("weight_decay", [0.0, 1e-4],
                         ids=["adam", "adamw"])
def test_train_step_matches_jax(monkeypatch, weight_decay):
    """One step from the same parameters.  The last conv's bias has a
    zero gradient in exact arithmetic (the softmax over cells ignores a
    shift of every logit), so its Adam step is a ratio of rounding
    noises, at most the learning rate; on these inputs it stays within
    the tolerance with the rest."""
    x, g = _batch(1)
    state, tx = JT.create_train_state(jax.random.PRNGKey(3), 12, 16, 54,
                                      3e-4, weight_decay)
    after, want_loss = JT.train_step(state, tx, jnp.asarray(x),
                                     jnp.asarray(g), 2.0)
    _inject(monkeypatch, _numpy(state.params))
    ts = TT.create_train_state(torch.Generator(), 54, 3e-4, weight_decay,
                               "cpu")
    assert type(ts.optimizer) is (torch.optim.AdamW if weight_decay
                                  else torch.optim.Adam)
    assert ts.optimizer.defaults["weight_decay"] == weight_decay
    loss = TT.train_step(ts, torch.from_numpy(x), torch.from_numpy(g), 2.0)
    assert ts.step == 1 and not loss.requires_grad
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=RTOL)
    want = convert.policy_state_dict_from_jax(_numpy(after.params))
    got = ts.policy.state_dict()
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                   rtol=0, atol=ATOL, err_msg=key)


def test_train_step_decreases_loss():
    """Mirror of the JAX package's test, from the port's own
    initialiser."""
    h, w = 12, 16
    state = TT.create_train_state(torch.Generator().manual_seed(2), 54,
                                  learning_rate=1e-2, device="cpu")
    td = torch.rand((4, h, w, 54), generator=torch.Generator().manual_seed(3))
    goals = torch.as_tensor([[3, 4], [10, 2], [7, 7], [0, 0]])
    losses = [TT.train_step(state, td, goals).item() for _ in range(30)]
    assert losses[-1] < losses[0] * 0.5


def test_smoothed_cross_entropy_minimized_at_goal():
    policy = TP.init_policy(torch.Generator().manual_seed(0), 3)
    top = torch.zeros((1, 16, 16, 3))
    goal = torch.as_tensor([[5, 7]], dtype=torch.int32)
    point = TT.goal_cross_entropy(policy, top, goal, sigma=0.0)
    want = -torch.log_softmax(TP.goal_logits(policy, top), -1)[0, 7 * 16 + 5]
    np.testing.assert_allclose(point.item(), want.item(), rtol=1e-5)
    smoothed = TT.goal_cross_entropy(policy, top, goal, sigma=2.0)
    assert np.isfinite(smoothed.item())
    assert abs(smoothed.item() - point.item()) < 1.0
    # logits peaked at the goal score better than logits peaked elsewhere
    with torch.no_grad():
        policy[12].weight.zero_()
        policy[12].bias.zero_()
    flat = torch.zeros(1, 16 * 16)
    peak = flat.clone()
    peak[0, 7 * 16 + 5] = 8.0
    away = flat.clone()
    away[0, 1 * 16 + 14] = 8.0
    nll = [-(torch.log_softmax(lg, -1)[0, 7 * 16 + 5]).item()
           for lg in (peak, away)]
    assert nll[0] < nll[1]


def test_input_channels_detects_conditioned():
    gen = torch.Generator().manual_seed(0)
    assert TP.input_channels(TP.init_policy(gen, 54)) == 54
    assert TP.input_channels(TP.init_policy(gen, 108)) == 108


# draws per layer: the head's kernel holds 576 values, whose std alone
# scatters by about 3%; eight seeded draws of each side bring that to 1%
INIT_SEEDS = 8


@pytest.mark.parametrize("channels", [54, 108])
def test_initialiser_matches_flax_statistics(channels):
    """Per-layer kernel std (over INIT_SEEDS seeded draws) within 5% of
    flax's and of 1/sqrt(fan-in), every draw inside flax's two-sigma
    truncation, zero biases, group norms at ones and zeros."""
    got = [TP.init_policy(torch.Generator().manual_seed(s),
                          channels).state_dict() for s in range(INIT_SEEDS)]
    want = [convert.policy_state_dict_from_jax(_numpy(JP.init_params(
        jax.random.PRNGKey(s), 8, 8, channels))) for s in range(INIT_SEEDS)]
    for i in TP.CONV_INDICES:
        w = torch.stack([sd[f"{i}.weight"] for sd in got])
        ref = torch.stack([sd[f"{i}.weight"] for sd in want])
        fan_in = w.shape[2] * 9
        assert abs(w.std().item() / ref.std().item() - 1) < 0.05, i
        assert abs(w.std().item() * np.sqrt(fan_in) - 1) < 0.05, i
        bound = 2 / np.sqrt(fan_in) / 0.87962566103423978
        assert w.abs().max().item() <= bound + 1e-7
        for sd in got:
            assert torch.equal(sd[f"{i}.bias"],
                               torch.zeros_like(w[0, :, 0, 0, 0]))
    for i in TP.NORM_INDICES:
        assert torch.equal(got[0][f"{i}.weight"], torch.ones(64))
        assert torch.equal(got[0][f"{i}.bias"], torch.zeros(64))
        assert torch.equal(want[0][f"{i}.weight"], torch.ones(64))
    again = TP.init_policy(torch.Generator().manual_seed(0), channels)
    assert all(torch.equal(v, again.state_dict()[k])
               for k, v in got[0].items())


@pytest.mark.parametrize("shape", [(8, 8, 2), (6, 10, 2)])
def test_dihedral_augmentation_matches_jax(shape):
    rng = np.random.RandomState(0)
    top = rng.uniform(size=shape).astype(np.float32)
    cell = np.asarray([2, 5], np.int32)
    top[cell[1], cell[0], 0] = 77.0
    for k in range(4):
        for flip in (False, True):
            t, c = TT._dihedral(top, cell, k, flip)
            jt, jc = JT._dihedral(top, cell, k, flip)
            np.testing.assert_array_equal(t, jt)
            np.testing.assert_array_equal(c, jc)
            assert c.dtype == jc.dtype == np.int32
            assert t[c[1], c[0], 0] == 77.0


def test_device_dihedral_matches_host():
    rng = np.random.RandomState(0)
    top = rng.uniform(size=(10, 10, 3)).astype(np.float32)
    cell = np.asarray([2, 7], np.int32)
    for k in range(4):
        for flip in (False, True):
            want_img, want_cell = JT._dihedral(top, cell, k, flip)
            got = TT._device_dihedral(torch.from_numpy(top), k, flip)
            np.testing.assert_array_equal(got.numpy(), want_img)
            jax_img = np.asarray(JT._device_dihedral(
                jnp.asarray(top), jnp.asarray(k), jnp.asarray(flip)))
            np.testing.assert_array_equal(got.numpy(), jax_img)
            np.testing.assert_array_equal(
                TT._dihedral_cell(cell, k, flip, 10, 10), want_cell)


def _write_dataset(d, n_tasks=12, h=16, w=16, c=3, g0=2, g1=2, k=2,
                   seed=0):
    """Tasks 0..n-1 (so task-10 sorts before task-2), one of them with an
    empty walkthrough, one with no labels of its own."""
    rng = np.random.RandomState(seed)
    d.mkdir(exist_ok=True)
    for tid in range(n_tasks):
        n0 = 0 if tid == 3 else g0
        np.savez_compressed(
            d / f"task-{tid}.npz",
            tops0=rng.uniform(size=(n0, h, w, c)).astype(np.float16),
            cells0=rng.randint(0, min(h, w), (k if tid != 5 else 0, 2)
                               ).astype(np.int32),
            tops1=rng.uniform(size=(g1, h, w, c)).astype(np.float16),
            cells1=rng.randint(0, min(h, w), (k, 2)).astype(np.int32))


def test_loaders_match_jax(tmp_path):
    d = tmp_path / "data"
    _write_dataset(d)
    tops, cells, tids = TT.load_dataset(str(d))
    jtops, jcells, jtids = JT.load_dataset(str(d))
    for got, want in ((tops, jtops), (cells, jcells), (tids, jtids)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert list(dict.fromkeys(tids))[:3] == [0, 1, 10]
    src = TT.load_dataset_conditioned(str(d))
    ref = JT.load_dataset_conditioned(str(d))
    assert len(src) == len(ref) and src.shape == ref.shape
    for name in ("cells", "task_ids", "_snaps", "_ctxs", "_si", "_ci"):
        got, want = getattr(src, name), getattr(ref, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for i in range(len(src)):
        np.testing.assert_array_equal(src.top(i), ref.top(i))


def test_assemble_conditioned_matches_jax(tmp_path):
    d = tmp_path / "data"
    _write_dataset(d, n_tasks=4, g0=2, g1=1)
    src = TT.load_dataset_conditioned(str(d))
    ids = np.asarray([0, 4, 9, 13])
    ks = np.asarray([0, 1, 2, 3])
    fl = np.asarray([False, True, True, False])
    got = TT._assemble_conditioned(
        torch.from_numpy(src._snaps), torch.from_numpy(src._ctxs),
        src._si[ids], src._ci[ids], ks, fl)
    want = np.asarray(JT._assemble_conditioned(
        jnp.asarray(src._snaps), jnp.asarray(src._ctxs),
        jnp.asarray(src._si[ids]), jnp.asarray(src._ci[ids]),
        jnp.asarray(ks, jnp.int32), jnp.asarray(fl)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    ident = TT._assemble_conditioned(
        torch.from_numpy(src._snaps), torch.from_numpy(src._ctxs),
        src._si[ids], src._ci[ids], np.zeros(4, int), np.zeros(4, bool))
    np.testing.assert_array_equal(
        ident.numpy(), np.stack([src.top(i) for i in ids]).astype(np.float32))


LEARNING_RATE = 1e-4
LOG = re.compile(r"step (\d+)/\d+: train NLL (\S+)  val NLL (\S+)  "
                 r"val argmax-dist (\S+) cells")


def _logged(text):
    return [(int(s), float(t), float(v), float(dd))
            for s, t, v, dd in LOG.findall(text)]


def _recording(module, losses, jax_side):
    step = module.train_step

    def recording_step(*args):
        out = step(*args)
        if jax_side:
            jax.debug.callback(lambda v: losses.append(float(v)), out[1],
                               ordered=True)
        else:
            losses.append(out.item())
        return out
    return recording_step


@pytest.mark.parametrize("conditioned,shape,augment", [
    (False, (12, 16), False), (False, (16, 16), True),
    (True, (16, 16), True)], ids=["plain-host-path-non-square",
                                  "plain-host-path-augmented",
                                  "conditioned-device-path"])
def test_fit_matches_jax(tmp_path, monkeypatch, capsys, conditioned, shape,
                         augment):
    """``fit`` from the same initial parameters: the same batches and
    augmentations (one RandomState, drawn in JAX's order on each path),
    per-step losses within rtol 1e-4, the same logged validation NLLs
    and best step, and a .pth that JAX's reader turns into JAX's own
    result.  (A quarter turn changes a non-square map's shape, which
    neither package can batch, so that map trains unaugmented.)

    Adam divides each gradient component by its own running magnitude,
    so a component that is zero but for rounding takes a step of up to
    the learning rate, each package in its own direction.  At the
    default 3e-4 one such step in the augmented case moved the trained
    logits by 4.5e-4 after ten steps (3e-6 in the other two cases); at
    the learning rate used here all three stay near 3e-6."""
    h, w = shape
    d = tmp_path / "data"
    _write_dataset(d, n_tasks=12, h=h, w=w, c=4, g1=2)
    kw = dict(steps=10, batch_size=4, val_fraction=0.25, log_every=3,
              seed=5, conditioned=conditioned, augment=augment,
              learning_rate=LEARNING_RATE)
    c = 8 if conditioned else 4
    init = _numpy(JP.init_params(jax.random.PRNGKey(5), h, w, c))

    jax_losses, port_losses = [], []
    monkeypatch.setattr(JT, "train_step", _recording(JT, jax_losses, True))
    want = JT.fit(str(d), str(tmp_path / "jax-ckpt"), **kw)
    jax_log = capsys.readouterr().out

    _inject(monkeypatch, init)
    monkeypatch.setattr(TT, "train_step", _recording(TT, port_losses, False))
    out = str(tmp_path / "port" / "policy.pth")
    got = TT.fit(str(d), out, device="cpu", **kw)
    port_log = capsys.readouterr().out

    assert len(port_losses) == len(jax_losses) == 10
    np.testing.assert_allclose(port_losses, jax_losses, rtol=RTOL)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    jl, pl = _logged(jax_log), _logged(port_log)
    assert [r[0] for r in pl] == [r[0] for r in jl] == [1, 3, 6, 9]
    np.testing.assert_allclose([r[1:] for r in pl], [r[1:] for r in jl],
                               atol=1.5e-3)
    best = [min(range(len(r)), key=lambda i: r[i][2]) for r in (pl, jl)]
    assert best[0] == best[1]
    for a, b in zip(jax_log.splitlines(), port_log.splitlines()):
        if not a.startswith(("step", "saved")):
            assert a == b, (a, b)

    state = torch.load(out, map_location="cpu", weights_only=True)
    assert TP.input_channels(TP.from_state_dict(state, "cpu")) == c
    back = JP.load_reference_policy(out)
    jax_params = _numpy(load_pytree(str(tmp_path / "jax-ckpt")))
    x = np.random.RandomState(9).rand(2, h, w, c).astype(np.float32)
    got_logits = np.asarray(JP.goal_logits(back, x))
    want_logits = np.asarray(JP.goal_logits(jax_params, x))
    # the last conv's bias adds one constant to every logit, which the
    # softmax over cells ignores: its gradient is zero in exact
    # arithmetic, so each Adam step moves it by up to the learning rate
    # in a direction set by rounding noise, on each side its own.  The
    # logits are compared up to that constant, which is all the agent
    # samples from.
    shift = (got_logits - want_logits).mean(axis=1, keepdims=True)
    np.testing.assert_allclose(shift, float(back["params"]["Conv_4"][
        "bias"][0] - jax_params["params"]["Conv_4"]["bias"][0]), atol=1e-5)
    assert abs(shift).max() <= kw["steps"] * LEARNING_RATE
    np.testing.assert_allclose(got_logits - shift, want_logits,
                               rtol=RTOL, atol=ATOL)


def test_fit_refuses_data_parallel_and_a_non_pth_path(tmp_path):
    """A data-parallel batch must divide over the replicas (the JAX
    package's assertion, named with both numbers), on the CLI too; the
    output must be a .pth."""
    d = tmp_path / "data"
    _write_dataset(d, n_tasks=2)
    with pytest.raises(ValueError, match="batch_size 8 must divide over "
                                         "3 devices"):
        TT.fit(str(d), str(tmp_path / "p.pth"), data_parallel=True,
               devices=["cpu"] * 3)
    with pytest.raises(ValueError, match=r"\.pth"):
        TT.fit(str(d), str(tmp_path / "orbax-dir"), device="cpu")
    with pytest.raises(ValueError, match="batch_size 8 must divide over "
                                         "5 devices"):
        TT.main(["--data", str(d), "--out", str(tmp_path / "p.pth"),
                 "--data-parallel", "5", "--device", "cpu"])


def test_main_trains_on_the_cpu_and_the_cli_runs_its_pth(tmp_path):
    """``--platform cpu`` (the JAX spelling) trains; the .pth runs a
    small policy-head episode through the port's CLI."""
    from mass_tpu_torch.agent import cli

    d = tmp_path / "data"
    _write_dataset(d, n_tasks=4, h=32, w=32, c=54, g1=1)
    out = str(tmp_path / "policy.pth")
    TT.main(["--data", str(d), "--out", out, "--steps", "3",
             "--batch-size", "2", "--platform", "cpu"])
    metrics = cli.main([
        "--device", "cpu", "--backend", "gridworld", "--camera-size", "24",
        "--map-height", "32", "--map-width", "32", "--map-depth", "8",
        "--grid-resolution", "0.125", "--step-size", "2",
        "--obstacle-padding", "2", "--map-slice-start", "0",
        "--map-slice-stop", "4", "--ground-truth-segmentation",
        "--ground-truth-disagreement", "--semantic-search-walkthrough",
        "--policy-checkpoint", out, "--exploration-budget-one", "1",
        "--exploration-budget-two", "1", "--max-goal-steps", "10",
        "--max-steps", "20", "--num-objects", "1", "--num-misplaced", "1",
        "--num-opened", "0", "--total-tasks", "1",
        "--logdir", str(tmp_path / "run")])
    assert len(metrics) == 1
    assert (tmp_path / "run" / "results" / "0.json").exists()
