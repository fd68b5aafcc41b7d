"""The port's search policy (mass_tpu_torch/search/policy.py) against
mass_tpu.search.policy: logits on random weights carried across with
convert.policy_from_jax and on each committed .pth checkpoint, each
.pth equal to its orbax tree, and sampled and inhibited goal cells
exact."""

import jax
import numpy as np
import pytest
import torch

from mass_tpu.search import policy as JP
from mass_tpu_torch import convert
from mass_tpu_torch.search import policy as TP
from mass_tpu_torch.search import prng
from tests.torch_checkpoints import NAMES, load_orbax, pth_path

# float32 convs and group norms summed in another order (flax's norm
# takes E[x^2] - E[x]^2, torch's does not)
RTOL = ATOL = 1e-4


def _top_down(seed: int, h: int, w: int, c: int) -> np.ndarray:
    """A sparse top-down class map: most cells empty, the rest class
    probabilities in [0, 1)."""
    rng = np.random.RandomState(seed)
    x = rng.rand(1, h, w, c).astype(np.float32)
    return x * (rng.rand(1, h, w, 1) < 0.3)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("channels", [54, 108])
def test_logits_on_random_weights_match_jax(channels):
    params = _numpy(JP.init_params(jax.random.PRNGKey(channels), 24, 32,
                                   channels))
    policy = convert.policy_from_jax(params, "cpu")
    assert TP.input_channels(policy) == channels
    x = _top_down(1, 24, 32, channels)
    got = TP.goal_logits(policy, torch.from_numpy(x)).numpy()
    want = np.asarray(JP.goal_logits(params, x))
    assert got.shape == want.shape == (1, 24 * 32)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", NAMES)
def test_committed_checkpoint_equals_its_orbax_tree(name):
    """Each committed .pth holds its orbax tree's values bit for bit:
    read back by the JAX package's own reference-checkpoint import, it
    gives the tree; and the port's state dict of the tree is the file."""
    tree = load_orbax(name)
    state = torch.load(pth_path(name), map_location="cpu", weights_only=True)
    assert sorted(state) == sorted(
        f"{i}.{p}" for i in TP.CONV_INDICES + TP.NORM_INDICES
        for p in ("weight", "bias"))
    back = JP.params_from_torch_state_dict(
        {k: v.numpy() for k, v in state.items()})
    flat_tree = jax.tree_util.tree_leaves_with_path(tree)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(_numpy(back)))
    assert len(flat_tree) == len(flat_back) == 18
    for path, leaf in flat_tree:
        assert flat_back[path].dtype == leaf.dtype == np.float32
        np.testing.assert_array_equal(flat_back[path], leaf)
    for key, value in convert.policy_state_dict_from_jax(tree).items():
        assert torch.equal(state[key], value), key


@pytest.mark.parametrize("name", NAMES)
def test_committed_checkpoint_logits_match_jax(name):
    tree = load_orbax(name)
    policy = TP.load_reference_policy(pth_path(name), "cpu")
    channels = TP.input_channels(policy)
    assert channels == JP.input_channels(tree)
    x = _top_down(2, 40, 40, channels)
    got = TP.goal_logits(policy, torch.from_numpy(x)).numpy()
    want = np.asarray(JP.goal_logits(tree, x))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["policy-gridworld",
                                  "policy-conditioned-multiroom"])
def test_sampled_cells_are_exact(name):
    """Gumbel-max goal cells from the agent's key stream (one split per
    goal) equal JAX's on a 48x56 map, and so do the inhibited decoder's
    cells with prior cells masked."""
    tree = load_orbax(name)
    policy = TP.load_reference_policy(pth_path(name), "cpu")
    channels = TP.input_channels(policy)
    h, w = 48, 56
    key, got_key = jax.random.PRNGKey(11), prng.PRNGKey(11)
    prior = []
    for goal in range(8):
        x = _top_down(10 + goal, h, w, channels)
        key, sub = jax.random.split(key)
        got_key, got_sub = prng.split(got_key)
        want = np.asarray(JP.sample_goal_cell(tree, x, sub))
        got = TP.sample_goal_cell(policy, torch.from_numpy(x), got_sub)
        np.testing.assert_array_equal(got.numpy(), want)
        logits = JP.goal_logits(tree, x)[0]
        got_logits = TP.goal_logits(policy, torch.from_numpy(x))[0]
        want = JP.inhibited_sample_cell(logits, h, w, prior, 6.0, sub)
        got = TP.inhibited_sample_cell(got_logits, h, w, prior, 6.0,
                                       got_sub)
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, want)
        prior.append(got[:2])


def test_inhibited_decoder_never_masks_all_mass():
    logits = torch.zeros(4 * 5)
    cell = TP.inhibited_sample_cell(logits, 4, 5, [np.asarray([2, 2])],
                                    100.0, prng.PRNGKey(0))
    want = JP.inhibited_sample_cell(np.zeros(20, np.float32), 4, 5,
                                    [np.asarray([2, 2])], 100.0,
                                    jax.random.PRNGKey(0))
    np.testing.assert_array_equal(cell, want)


def test_policy_runs_without_global_cudnn_flags():
    """The convs pin deterministic, TF32-free cuDNN only while they run."""
    before = (torch.backends.cudnn.deterministic,
              torch.backends.cudnn.allow_tf32)
    policy = TP.SearchPolicy()
    out = policy(torch.zeros(2, 6, 7, TP.NUM_CLASSES))
    assert out.shape == (2, 6, 7, 1)
    assert (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.allow_tf32) == before
