"""The port's plain attention against the JAX package's plain version and
its Pallas kernels (run in interpret mode, as tests/test_kernels.py runs
them), plus the dispatch rules of ``repro_torch.kernels.attention.ops``."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels.attention import ref as jax_ref
from repro.kernels.attention.decode_attention import decode_attention as pallas_decode
from repro.kernels.attention.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels.attention import decode_attention as decode_wrapper
from repro_torch.kernels.attention import flash_attention as flash_wrapper
from repro_torch.kernels.attention import ops, ref

ATOL = 2e-5  # float32 on both sides, as tests/test_kernels.py holds the kernels

# The shape cases of tests/test_kernels.py.
FLASH_CASES = [
    # (b, s_q, s_kv, h, kv, d, causal, window)
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 200, 200, 8, 8, 128, True, 0),     # MHA, non-divisible seq (padding)
    (2, 64, 256, 4, 1, 32, False, 0),      # cross/bidirectional, MQA
    (1, 256, 256, 4, 2, 64, True, 64),     # sliding window
    (2, 96, 96, 6, 3, 64, True, 0),
    (1, 128, 512, 4, 4, 128, True, 0),     # q shorter than kv (continuation)
]
DECODE_CASES = [
    # (b, h, kv, d, s_max, cache_len, window)
    (2, 8, 2, 64, 300, 150, 0),
    (1, 4, 4, 128, 512, 512, 0),
    (3, 16, 2, 64, 256, 256, 128),   # rolling sliding-window cache
    (2, 4, 1, 32, 1024, 700, 0),     # MQA, partially filled
    (1, 8, 8, 64, 96, 1, 0),         # single valid entry
]


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _flash_inputs(case, seed=0):
    b, s_q, s_kv, h, kv, d, causal, window = case
    rng = np.random.default_rng(seed)
    return _rand(rng, b, s_q, h, d), _rand(rng, b, s_kv, kv, d), _rand(rng, b, s_kv, kv, d)


@pytest.mark.parametrize("case", FLASH_CASES)
def test_mha_matches_jax_ref_and_pallas(case):
    b, s_q, s_kv, h, kv, d, causal, window = case
    q, k, v = _flash_inputs(case)
    off = s_kv - s_q if causal else 0
    got = ref.mha(*map(torch.from_numpy, (q, k, v)), causal=causal, window=window, q_offset=off)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = jax_ref.mha(jq, jk, jv, causal=causal, window=window, q_offset=off)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    kernel = pallas_flash(jq, jk, jv, causal=causal, window=window, q_offset=off,
                          block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), atol=ATOL)


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_gqa_matches_jax_ref_and_pallas(case):
    b, h, kv, d, s_max, clen, window = case
    rng = np.random.default_rng(1)
    q, kc, vc = _rand(rng, b, h, d), _rand(rng, b, s_max, kv, d), _rand(rng, b, s_max, kv, d)
    got = ref.decode_gqa(*map(torch.from_numpy, (q, kc, vc)), clen, window=window)
    jq, jk, jv = map(jnp.asarray, (q, kc, vc))
    want = jax_ref.decode_gqa(jq, jk, jv, jnp.int32(clen), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    kernel = pallas_decode(jq, jk, jv, jnp.int32(clen), window=window, block_k=128,
                           interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), atol=ATOL)


def test_decode_gqa_per_example_lengths():
    rng = np.random.default_rng(7)
    b, h, kv, d, s_max = 3, 4, 2, 32, 128
    q, kc, vc = _rand(rng, b, h, d), _rand(rng, b, s_max, kv, d), _rand(rng, b, s_max, kv, d)
    lens = np.asarray([5, 77, 128], np.int32)
    got = ref.decode_gqa(*map(torch.from_numpy, (q, kc, vc)), torch.from_numpy(lens))
    want = jax_ref.decode_gqa(*map(jnp.asarray, (q, kc, vc, lens)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_mixed_precision_decode_matches_jax_ref():
    """float32 queries against a bfloat16 cache, as the engine runs float32
    models: the same promotion and rounding points as the reference."""
    rng = np.random.default_rng(3)
    b, h, kv, d, s_max = 2, 4, 2, 32, 48
    q, kc, vc = _rand(rng, b, h, d), _rand(rng, b, s_max, kv, d), _rand(rng, b, s_max, kv, d)
    tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (kc, vc))
    got = ref.decode_gqa(torch.from_numpy(q), tk, tv, 20)
    want = jax_ref.decode_gqa(jnp.asarray(q), jnp.asarray(kc, jnp.bfloat16),
                              jnp.asarray(vc, jnp.bfloat16), jnp.int32(20))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-2)


def test_ops_on_cpu_tensors_take_the_plain_version():
    q, k, v = map(torch.from_numpy, _flash_inputs(FLASH_CASES[0]))
    before = (flash_wrapper.launches, decode_wrapper.launches)
    torch.testing.assert_close(ops.flash_attention(q, k, v), ref.mha(q, k, v), rtol=0, atol=0)
    kc = k[:, :100].contiguous()
    torch.testing.assert_close(ops.decode_attention(q[:, 0], kc, kc, 40),
                               ref.decode_gqa(q[:, 0], kc, kc, 40), rtol=0, atol=0)
    assert (flash_wrapper.launches, decode_wrapper.launches) == before


def test_explicit_kernel_route_raises_off_the_card():
    q, k, v = map(torch.from_numpy, _flash_inputs(FLASH_CASES[0]))
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.decode_attention(q[:, 0], k, v, 10, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        ops.flash_attention(q, k, v, impl="pallas")


def test_split_plan_covers_the_cache():
    for b, kv, s_max in ((4, 8, 1024), (4, 2, 1024), (1, 1, 96), (3, 2, 300), (64, 8, 4096),
                         (4, 8, 1), (1, 1, 32), (2, 4, 33)):
        chunk, n_split = decode_wrapper.split_plan(b, kv, s_max)
        assert chunk % 32 == 0 and n_split * chunk >= s_max > (n_split - 1) * chunk
        # about one block per SM at most, and one cluster per (b, kv head)
        assert b * kv * n_split <= decode_wrapper.TARGET_BLOCKS or n_split == 1
        assert n_split <= decode_wrapper.MAX_SPLIT


@pytest.mark.parametrize("case", DECODE_CASES + [
    (4, 32, 8, 128, 1024, 300, 0),     # granite-8b in the engine
    (4, 12, 2, 128, 1024, 300, 0),     # qwen2-vl-2b
    (4, 32, 8, 128, 1024, 1300, 0),    # length past S_max
    (2, 8, 2, 64, 4096, 3000, 500),    # window inside a long cache
    (1, 8, 8, 64, 96, 40, 100),        # window wider than the length
])
def test_split_plan_over_the_valid_range(case):
    """For an int length the chunks tile exactly the entries the plain
    version attends to, and every chunk holds some."""
    b, h, kv, d, s_max, clen, window = case
    begin, end = decode_wrapper.valid_range(clen, s_max, window)
    pos = torch.arange(s_max)
    valid = (pos < clen) & ((pos >= clen - window) if window > 0 else True)
    assert (begin, end) == (int(pos[valid].min()), int(pos[valid].max()) + 1)
    assert int(valid.sum()) == end - begin  # one contiguous range
    chunk, n_split = decode_wrapper.split_plan(b, kv, end - begin)
    chunks = [(begin + i * chunk, min(begin + (i + 1) * chunk, end)) for i in range(n_split)]
    assert chunks[0][0] == begin and chunks[-1][1] == end
    assert all(lo < hi for lo, hi in chunks)                          # none empty
    assert all(a[1] == b_[0] for a, b_ in zip(chunks, chunks[1:]))   # no gap, no overlap
    assert chunk % decode_wrapper.CHUNK_ALIGN == 0 and n_split <= decode_wrapper.MAX_SPLIT


def test_flash_route_is_chosen_by_dtype():
    assert flash_wrapper.route(torch.bfloat16) == "wgmma"
    assert flash_wrapper.route(torch.float32) == "fma"
    for dtype in (torch.float16, torch.float64, torch.int8):
        with pytest.raises(ValueError, match="dtype"):
            flash_wrapper.route(dtype)
