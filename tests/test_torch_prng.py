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


@pytest.mark.parametrize("seed", SEEDS)
def test_split_and_bernoulli_match_jax(seed):
    key = jax.random.key(seed)
    for num in (2, 3, 5):
        want = np.asarray(jax.random.key_data(jax.random.split(key, num)))
        np.testing.assert_array_equal(prng.split(prng.key(seed), num), want)
    for p in (0.5, 0.08):
        want = np.asarray(jax.random.bernoulli(key, p, (33,)))
        np.testing.assert_array_equal(prng.bernoulli(prng.key(seed), p, (33,)), want)
    want = np.asarray(jax.random.uniform(key, (17,), minval=0.5, maxval=1.5))
    got = prng.uniform(prng.key(seed), (17,), minval=0.5, maxval=1.5)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_torch_twin_matches_numpy_and_jax(seed):
    """The int64 twin the step loops draw from on the device: ``fold_in``
    over a block of steps, ``uniform`` of a scalar and an (N,) shape, and
    ``bernoulli``, bit for bit the numpy functions' and ``jax.random``'s."""
    torch = pytest.importorskip("torch")
    key = jax.random.key(seed)
    kt = prng.key_t(prng.key(seed), "cpu")
    folded = prng.fold_in_t(kt, torch.arange(200))
    np.testing.assert_array_equal(folded.numpy().astype(np.uint32),
                                  prng.fold_in(prng.key(seed), STEPS))
    for shape in ((), (7,), (2, 3)):
        got = prng.uniform_t(folded, shape).numpy()
        want = jax.vmap(lambda t: jax.random.uniform(jax.random.fold_in(key, t), shape))(
            jnp.asarray(STEPS, jnp.uint32))
        np.testing.assert_array_equal(got.view(np.uint32), np.asarray(want).view(np.uint32))
    got = prng.bernoulli_t(kt, 0.5, (40,)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.random.bernoulli(key, 0.5, (40,))))
    # Keys broadcast against the counters: (K, 1, 2) keys over (B,) steps.
    keys = torch.stack([kt, prng.key_t(prng.key(seed + 1), "cpu")])[:, None, :]
    block = prng.fold_in_t(keys, torch.arange(5))
    assert block.shape == (2, 5, 2)
    np.testing.assert_array_equal(block[1].numpy().astype(np.uint32),
                                  prng.fold_in(prng.key(seed + 1), np.arange(5)))
