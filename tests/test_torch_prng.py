"""The port's threefry2x32 (utils/prng.py) against ``jax.random`` on the CPU.

Keys, raw bits, ``split`` and ``fold_in`` must be bit-equal, ``uniform`` and
``randint`` exactly equal, and ``normal`` within 1e-6 (the two erf^-1 may
round a log1p differently in the last place), over seeds, keys made by
``split`` and ``fold_in``, and shapes from () to three dimensions; batched
keys must give what ``jax.vmap`` gives.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbss_tpu_torch.utils import prng

SHAPES = [(), (1,), (7,), (3, 5), (2, 3, 4), (1000,)]


def _keys():
    base = jax.random.PRNGKey(3)
    return [jax.random.PRNGKey(0), base, jax.random.split(base, 5)[4],
            jax.random.fold_in(base, 12345)]


def _t(key) -> torch.Tensor:
    return torch.from_numpy(np.asarray(key).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1, -1, -7])
def test_prng_key_is_jax(seed):
    want = np.asarray(jax.random.PRNGKey(seed)).astype(np.int64)
    np.testing.assert_array_equal(prng.PRNGKey(seed).numpy(), want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("k", range(4))
def test_bits_split_and_draws_are_jax(k, shape):
    key = _keys()[k]
    kt = _t(key)
    np.testing.assert_array_equal(
        prng.bits(kt, shape).numpy(),
        np.asarray(jax.random.bits(key, shape, jnp.uint32)).astype(np.int64))
    num = shape if shape else 1
    np.testing.assert_array_equal(prng.split(kt, num).numpy(),
                                  np.asarray(jax.random.split(key, num)).astype(np.int64))
    np.testing.assert_array_equal(
        prng.uniform(kt, shape, -0.3, 2.5).numpy(),
        np.asarray(jax.random.uniform(key, shape, minval=-0.3, maxval=2.5)))
    np.testing.assert_array_equal(prng.uniform(kt, shape).numpy(),
                                  np.asarray(jax.random.uniform(key, shape)))
    for lo, hi in ((0, 2), (0, 5), (-5, 100003), (3, 3), (0, 32001)):
        np.testing.assert_array_equal(prng.randint(kt, shape, lo, hi).numpy(),
                                      np.asarray(jax.random.randint(key, shape, lo, hi)))
    np.testing.assert_allclose(prng.normal(kt, shape).numpy(),
                               np.asarray(jax.random.normal(key, shape)), atol=1e-6, rtol=0)


@pytest.mark.parametrize("data", [0, 1, 7, 2 ** 31 - 1, -1, -123456])
def test_fold_in_is_jax(data):
    key = jax.random.PRNGKey(11)
    np.testing.assert_array_equal(
        prng.fold_in(_t(key), data).numpy(),
        np.asarray(jax.random.fold_in(key, np.int32(data))).astype(np.int64))


def test_batched_keys_are_vmap():
    """Keys [B, 2] draw what jax.vmap draws, and fold_in broadcasts seeds."""
    key = jax.random.PRNGKey(5)
    seeds = np.array([3, 99, 2 ** 30, 0], np.int32)
    keys = jax.vmap(lambda s: jax.random.fold_in(key, s))(jnp.asarray(seeds))
    kt = prng.fold_in(_t(key), torch.from_numpy(seeds))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(keys).astype(np.int64))
    ks = jax.vmap(lambda k: jax.random.split(k, 6))(keys)
    np.testing.assert_array_equal(prng.split(kt, 6).numpy(), np.asarray(ks).astype(np.int64))
    hi = jnp.asarray([5, 17, 1, 40000], jnp.int32)
    want = jax.vmap(lambda k, h: jax.random.randint(k, (), 0, h))(keys, hi)
    got = prng.randint(kt, (), 0, torch.from_numpy(np.asarray(hi).astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jax.vmap(lambda k: jax.random.uniform(k, (2, 3), minval=-1.0, maxval=4.0))(keys)
    np.testing.assert_array_equal(prng.uniform(kt, (2, 3), -1.0, 4.0).numpy(), np.asarray(want))
    want = jax.vmap(lambda k: jax.random.normal(k, (3, 500)))(keys)
    np.testing.assert_allclose(prng.normal(kt, (3, 500)).numpy(), np.asarray(want),
                               atol=1e-6, rtol=0)


def test_normal_tails_within_1e_6():
    """200k normals reach beyond 4.5 sigma, where one ulp is 4.8e-7."""
    key = jax.random.PRNGKey(8)
    want = np.asarray(jax.random.normal(key, (200_000,)))
    got = prng.normal(_t(key), (200_000,)).numpy()
    assert np.abs(want).max() > 4.5
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert (got == want).mean() > 0.95
