"""The port's threefry stream (mass_tpu_torch/search/prng.py) against
jax.random with the installed jax's partitionable threefry: keys,
splits, random bits and uniforms bit for bit, the Gumbel noise within
one ulp of each of its two logs, and categorical samples exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from mass_tpu_torch.search import prng

SEEDS = st.integers(min_value=-(1 << 31), max_value=(1 << 31) - 1)
# a few shapes, so JAX compiles each sampler a few times only
SHAPES = st.sampled_from([(), (1,), (7,), (3, 5), (2, 3, 4), (1, 6400)])


def _key_words(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


def _same_bits(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    return got.dtype == torch.float32 and got.shape == want.shape and \
        np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_threefry_partitionable_is_the_installed_setting():
    assert jax.config.jax_threefry_partitionable


@settings(max_examples=60, deadline=None)
@given(seed=SEEDS, num=st.integers(min_value=1, max_value=7))
def test_keys_and_splits_equal_jax(seed, num):
    key = jax.random.PRNGKey(seed)
    got = prng.PRNGKey(seed)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), _key_words(key))
    np.testing.assert_array_equal(
        prng.split(got, num).numpy(), _key_words(jax.random.split(key, num)))
    # the agent's pattern: split once per goal, keep the first key
    for _ in range(3):
        key, sub = jax.random.split(key)
        got, got_sub = prng.split(got)
        np.testing.assert_array_equal(got.numpy(), _key_words(key))
        np.testing.assert_array_equal(got_sub.numpy(), _key_words(sub))


def test_seed_outside_int32_is_refused():
    with pytest.raises(ValueError, match="int32"):
        prng.PRNGKey(1 << 31)


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(min_value=0, max_value=(1 << 30) - 1),
       shape=SHAPES,
       bounds=st.sampled_from([(0.0, 1.0), (prng.TINY, 1.0), (-2.5, 3.0),
                               (1e-3, 1e-2)]))
def test_bits_and_uniforms_equal_jax(seed, shape, bounds):
    key = jax.random.split(jax.random.PRNGKey(seed))[1]
    got_key = prng.split(prng.PRNGKey(seed))[1]
    np.testing.assert_array_equal(
        prng.random_bits(got_key, shape).numpy(),
        np.asarray(jax.random.bits(key, shape, jnp.uint32)).astype(np.int64))
    assert _same_bits(prng.uniform(got_key, shape, *bounds),
                      jax.random.uniform(key, shape, jnp.float32, *bounds))


def test_scalar_uniform_is_the_inhibited_decoders_draw():
    """float(uniform(key)) as the inhibited decoder reads it."""
    key, got = jax.random.PRNGKey(7), prng.PRNGKey(7)
    for _ in range(20):
        key, sub = jax.random.split(key)
        got, got_sub = prng.split(got)
        assert float(prng.uniform(got_sub)) == float(
            jax.random.uniform(sub))


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 42, 123456789])
def test_gumbel_noise_within_one_ulp_of_each_log(seed):
    """The noise is -log(-log(u)) on JAX's exact uniforms.  torch's and
    XLA's float32 log each round to within one ulp of the other's, so
    each log is held to one ulp and the noise to one ulp of itself plus
    the inner log's ulp carried through the outer log (2**-23)."""
    key = jax.random.split(jax.random.PRNGKey(seed))[1]
    got_key = prng.split(prng.PRNGKey(seed))[1]
    shape = (1, 80 * 80)
    u = np.asarray(jax.random.uniform(key, shape, jnp.float32, prng.TINY))
    assert _same_bits(prng.uniform(got_key, shape, prng.TINY), u)
    inner = np.asarray(jnp.log(u))
    assert _ulps(torch.log(torch.tensor(u)).numpy(), inner).max() <= 1
    outer = np.asarray(jnp.log(-inner))
    assert _ulps(torch.log(torch.tensor(-inner)).numpy(), outer).max() <= 1
    got = prng.gumbel(got_key, shape).numpy()
    want = np.asarray(jax.random.gumbel(key, shape, jnp.float32))
    bound = np.spacing(np.abs(want)) + 2.0 ** -23
    assert (np.abs(got - want) <= bound).all()


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(min_value=0, max_value=(1 << 30) - 1),
       rows=st.sampled_from([1, 3]),
       cells=st.sampled_from([7, 6400]),
       scale=st.sampled_from([0.5, 3.0, 20.0]))
def test_categorical_samples_equal_jax(seed, rows, cells, scale):
    logits = (np.random.RandomState(seed % 9973).randn(rows, cells)
              * scale).astype(np.float32)
    key = jax.random.split(jax.random.PRNGKey(seed))[1]
    got_key = prng.split(prng.PRNGKey(seed))[1]
    want = np.asarray(jax.random.categorical(key, logits, axis=-1))
    got = prng.categorical(got_key, torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), want)


def test_categorical_ties_go_to_the_first_index():
    """Logits that cancel the noise exactly tie every cell at 0: both
    packages pick cell 0."""
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.gumbel(key, (1, 50), jnp.float32))
    got = prng.categorical(prng.PRNGKey(3),
                           -prng.gumbel(prng.PRNGKey(3), (1, 50)))
    want = np.asarray(jax.random.categorical(key, -noise))
    assert int(got[0]) == int(want[0]) == 0


@settings(max_examples=40, deadline=None)
@given(seed=SEEDS, data=st.sampled_from([0, 1, 2, 7, 12345, (1 << 31) - 1,
                                         (1 << 32) - 1]))
def test_fold_in_equals_jax(seed, data):
    """``fold_in`` (the Mask R-CNN trainer's background-ROI key) bit for
    bit, on a key and on a split of it."""
    key = jax.random.PRNGKey(seed)
    got = prng.PRNGKey(seed)
    for _ in range(2):
        np.testing.assert_array_equal(
            prng.fold_in(got, data).numpy(),
            _key_words(jax.random.fold_in(key, data)))
        key, got = jax.random.split(key)[1], prng.split(got)[1]


@pytest.mark.parametrize("seed", [0, 3, 2024])
def test_batched_keys_equal_vmap(seed):
    """A stack of keys ``[B, 2]`` through split, fold_in and uniform gives
    what ``jax.vmap`` over the keys gives, as the trainer draws one key a
    frame."""
    keys = jax.random.split(jax.random.PRNGKey(seed), 3)
    got = prng.split(prng.PRNGKey(seed), 3)
    np.testing.assert_array_equal(
        prng.split(got, 4).numpy(),
        _key_words(jax.vmap(lambda k: jax.random.split(k, 4))(keys)))
    np.testing.assert_array_equal(
        prng.fold_in(got, 1).numpy(),
        _key_words(jax.vmap(lambda k: jax.random.fold_in(k, 1))(keys)))
    assert _same_bits(prng.uniform(got, (5, 7)), jax.vmap(
        lambda k: jax.random.uniform(k, (5, 7)))(keys))
