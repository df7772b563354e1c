"""The port's threefry2x32 (``repro_torch/core/prng.py``) against
``jax.random``: the same key data, ``fold_in`` and float32 ``uniform`` bits,
which the failure chains of both packages draw from."""
import pytest

pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro_torch.core import prng

SEEDS = (0, 1, 3, 12345, 2**31 - 1)
STEPS = np.arange(200)


def test_jax_runs_the_counter_layout_the_port_reproduces():
    """``random_bits`` for a shape (N,) hashes the 64-bit iota split into
    (hi, lo) words only under ``jax_threefry_partitionable``; the port
    reproduces that layout, so pin it."""
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_fold_in_match_jax(seed):
    key = jax.random.key(seed)
    np.testing.assert_array_equal(prng.key(seed), np.asarray(jax.random.key_data(key)))
    want = jax.vmap(lambda t: jax.random.key_data(jax.random.fold_in(key, t)))(
        jnp.asarray(STEPS, jnp.uint32))
    np.testing.assert_array_equal(prng.fold_in(prng.key(seed), STEPS), np.asarray(want))


@pytest.mark.parametrize("n", [None, 1, 4, 7, 33], ids=lambda n: f"shape{n}")
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bits_match_jax(seed, n):
    """Bit for bit over t in [0, 200), for a scalar draw and (N,) draws."""
    shape = () if n is None else (n,)
    key = jax.random.key(seed)
    want = jax.vmap(lambda t: jax.random.uniform(jax.random.fold_in(key, t), shape))(
        jnp.asarray(STEPS, jnp.uint32))
    got = prng.uniform(prng.fold_in(prng.key(seed), STEPS), shape)
    assert got.dtype == np.float32 and got.shape == (len(STEPS),) + shape
    np.testing.assert_array_equal(got.view(np.uint32), np.asarray(want).view(np.uint32))
    assert ((got >= 0) & (got < 1)).all()


def test_threefry_known_answer():
    """The Threefry-2x32 test vector (Random123, 20 rounds): key and counter
    all ones."""
    ones = 0xFFFFFFFF
    got = prng.threefry2x32(ones, ones, ones, ones)
    assert [int(x) for x in got] == [0x1CB996FC, 0xBB002BE7]


def test_negative_seed_raises():
    with pytest.raises(ValueError, match="seed"):
        prng.key(-1)
