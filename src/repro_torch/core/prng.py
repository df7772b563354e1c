"""The part of ``jax.random`` that the failure chains draw from, in numpy.

``core/failures.py`` draws its per-step uniforms from JAX's counter-based
threefry2x32 generator (``uniform(fold_in(fold_in(key, t), slot))``), and
the numpy oracle of the JAX package replays the same draws.  The port
reproduces those bits exactly so that its chains are the reference's:

* ``key(seed)`` is the raw key data ``[seed >> 32, seed & 0xFFFFFFFF]``
  (``jax.random.key_data(jax.random.key(seed))``);
* ``fold_in(key, d)`` hashes the counter pair ``(0, d)`` under ``key``;
* ``uniform(key, shape)`` hashes the 64-bit iota over ``shape`` split into
  ``(hi, lo)`` words, XORs the two output words, and maps the top 23 bits
  into [0, 1) through the float32 bit pattern of [1, 2).  This is the
  counter layout of ``jax_threefry_partitionable=True``, the default of
  the JAX the reference runs on (``tests/test_torch_prng.py`` pins it).

The arithmetic is uint64 with a 32-bit mask, so no numpy operation ever
wraps.  Every function is vectorized: keys of shape ``(..., 2)`` broadcast
against the data, so a whole run's draws come out of one call.
"""
from __future__ import annotations

import numpy as np

_MASK = np.uint64(0xFFFFFFFF)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint64(0x1BD11BDA)


def _u64(x) -> np.ndarray:
    return np.asarray(x, dtype=np.uint64) & _MASK


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return ((x << np.uint64(r)) | (x >> np.uint64(32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the counter words ``(x1, x2)``
    under the key ``(k1, k2)``; all four broadcast.  Returns uint32 words."""
    k1, k2, x1, x2 = (_u64(v) for v in (k1, k2, x1, x2))
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + np.uint64(i + 1)) & _MASK
    return x1.astype(np.uint32), x2.astype(np.uint32)


def key(seed: int) -> np.ndarray:
    """Raw key data of ``jax.random.key(seed)``: (2,) uint32."""
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"seed must be >= 0, got {seed}")
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def fold_in(key_data, data) -> np.ndarray:
    """``jax.random.fold_in``: keys (..., 2) and uint32 data broadcast to
    keys of shape (broadcast, 2)."""
    key_data = np.asarray(key_data, np.uint32)
    data = np.asarray(data, np.uint64)
    o1, o2 = threefry2x32(key_data[..., 0], key_data[..., 1],
                          np.zeros_like(data), data)
    return np.stack([o1, o2], axis=-1)


def random_bits(key_data, shape: tuple = ()) -> np.ndarray:
    """32-bit ``random_bits`` of each key (..., 2): (..., *shape) uint32."""
    key_data = np.asarray(key_data, np.uint32)
    size = int(np.prod(shape, dtype=np.int64))
    lo = np.arange(size, dtype=np.uint64).reshape(shape)
    lead = key_data.shape[:-1]
    k1 = key_data[..., 0].reshape(lead + (1,) * len(shape))
    k2 = key_data[..., 1].reshape(lead + (1,) * len(shape))
    b1, b2 = threefry2x32(k1, k2, np.zeros_like(lo), lo)
    return b1 ^ b2


def uniform(key_data, shape: tuple = ()) -> np.ndarray:
    """``jax.random.uniform(key, shape)`` in float32 over [0, 1), for each
    key (..., 2): (..., *shape)."""
    bits = random_bits(key_data, shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    return np.maximum(np.float32(0.0), floats - np.float32(1.0))
