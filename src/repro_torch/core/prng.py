"""The part of ``jax.random`` that the failure chains and the arrival
generators draw from, in numpy and as a twin on torch tensors.

``core/failures.py`` draws its per-step uniforms from JAX's counter-based
threefry2x32 generator (``uniform(fold_in(fold_in(key, t), slot))``), and
``core/workload.py`` its stochastic arrivals (``fold_in(key, t)`` per step,
``split`` for a scenario library's keys).  The port reproduces those bits
exactly so that its chains and its synthesized arrivals are the
reference's:

* ``key(seed)`` is the raw key data ``[seed >> 32, seed & 0xFFFFFFFF]``
  (``jax.random.key_data(jax.random.key(seed))``);
* ``fold_in(key, d)`` hashes the counter pair ``(0, d)`` under ``key``;
* ``split(key, n)`` hashes the counters ``(0, i)`` for i < n, so its
  i-th key is ``fold_in(key, i)``;
* ``uniform(key, shape)`` hashes the 64-bit iota over ``shape`` split into
  ``(hi, lo)`` words, XORs the two output words, and maps the top 23 bits
  into [0, 1) through the float32 bit pattern of [1, 2).  This is the
  counter layout of ``jax_threefry_partitionable=True``, the default of
  the JAX the reference runs on (``tests/test_torch_prng.py`` pins it);
* ``bernoulli(key, p, shape)`` is ``uniform(key, shape) < p``.

The numpy arithmetic is uint64 with a 32-bit mask, so no numpy operation
ever wraps.  Every function is vectorized: keys of shape ``(..., 2)``
broadcast against the data, so a whole run's draws come out of one call.

The ``*_t`` functions are the same hash on int64 torch tensors masked to 32
bits (key data as ``(..., 2)`` int64), so that a step loop on the card
draws ``fold_in(key, t)`` without a copy from the host; they return the
numpy functions' bits (``tests/test_torch_prng.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device

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


def split(key_data, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) uint32 key data."""
    return fold_in(key_data, np.arange(num, dtype=np.uint64))


def uniform(key_data, shape: tuple = (), minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, minval=, maxval=)`` in float32, for
    each key (..., 2): (..., *shape)."""
    bits = random_bits(key_data, shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    floats = floats - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


def bernoulli(key_data, p: float = 0.5, shape: tuple = ()) -> np.ndarray:
    """``jax.random.bernoulli(key, p, shape)``: (..., *shape) bool."""
    return uniform(key_data, shape) < np.float32(p)


# ---------------------------------------------------------------------------
# The twin on torch tensors: int64 words masked to 32 bits, on any device.
# ---------------------------------------------------------------------------

_MASK_T = 0xFFFFFFFF


def _rotl_t(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK_T


def threefry2x32_t(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """``threefry2x32`` on int64 tensors holding uint32 words (broadcast)."""
    ks = (k1, k2, k1 ^ k2 ^ int(_PARITY))
    x1 = (x1 + ks[0]) & _MASK_T
    x2 = (x2 + ks[1]) & _MASK_T
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK_T
            x2 = _rotl_t(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK_T
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK_T
    return x1, x2


def key_t(key_data, device="cuda") -> torch.Tensor:
    """Raw key data (..., 2) uint32 as an int64 tensor on ``device``."""
    return torch.from_numpy(np.asarray(key_data, np.uint32).astype(np.int64)).to(
        resolve_device(device))


def fold_in_t(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``fold_in`` of int64 keys (..., 2) with int64 counters broadcast
    against the keys' leading shape: (broadcast, 2)."""
    o1, o2 = threefry2x32_t(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([o1, o2], dim=-1)


def uniform_t(key: torch.Tensor, shape: tuple = ()) -> torch.Tensor:
    """``uniform(key, shape)`` for int64 keys (..., 2): (..., *shape) float32."""
    size = int(np.prod(shape, dtype=np.int64))
    lo = torch.arange(size, dtype=torch.int64, device=key.device).reshape(shape)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(lead + (1,) * len(shape))
    k2 = key[..., 1].reshape(lead + (1,) * len(shape))
    b1, b2 = threefry2x32_t(k1, k2, torch.zeros_like(lo), lo)
    bits = ((b1 ^ b2) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32)
    return torch.clamp(floats - 1.0, min=0.0)


def bernoulli_t(key: torch.Tensor, p: float = 0.5, shape: tuple = ()) -> torch.Tensor:
    """``bernoulli(key, p, shape)`` for int64 keys (..., 2): (..., *shape) bool."""
    return uniform_t(key, shape) < float(np.float32(p))
