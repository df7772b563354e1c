"""The Hopper kernels against their plain versions, on the card.

Marked ``cuda``: they skip on hosts without a CUDA device of capability 9.0
and run on an H100 with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.attention import decode_attention as da
from repro_torch.kernels.attention import flash_attention as fa
from repro_torch.kernels.attention import ops, ref

pytestmark = pytest.mark.cuda

ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = list(ATOL)


@pytest.fixture
def card():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a CUDA device of compute capability 9.0 (the kernels are sm_90a)")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", [
    # (b, s_q, s_kv, h, kv, d, causal, window, q_offset)
    (1, 77, 77, 4, 2, 32, True, 0, 0),
    (2, 130, 200, 6, 2, 64, True, 0, 70),
    (1, 300, 300, 8, 4, 128, True, 40, 0),
    (3, 33, 65, 4, 4, 64, False, 0, 0),
])
def test_flash_kernel_matches_plain(case, dtype, card):
    b, s_q, s_kv, h, kv, d, causal, window, off = case
    q = _randn(card, (b, s_q, h, d), dtype)
    k, v = (_randn(card, (b, s_kv, kv, d), dtype) for _ in range(2))
    before = fa.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window, q_offset=off)
    want = ref.mha(q, k, v, causal=causal, window=window, q_offset=off)
    assert fa.launches == before + 1 and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", [
    # (b, h, kv, d, s_max, cache_len, window)
    (4, 32, 8, 128, 1024, [1, 300, 1024, 517], 0),
    (4, 12, 2, 128, 1024, [64, 65, 999, 2], 0),
    (2, 8, 8, 32, 200, [200, 3], 50),
    (3, 6, 3, 64, 96, [96, 96, 96], 0),
])
def test_decode_kernel_matches_plain(case, dtype, card):
    b, h, kv, d, s_max, lens, window = case
    q = _randn(card, (b, h, d), dtype)
    kc, vc = (_randn(card, (b, s_max, kv, d), dtype) for _ in range(2))
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    before = da.launches
    got = ops.decode_attention(q, kc, vc, lens, window=window)
    want = ref.decode_gqa(q, kc, vc, lens, window=window)
    assert da.launches == before + 1 and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=ATOL[dtype], rtol=0)


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    q = _randn(card, (1, 16, 4, 128), torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q, q, q)
    q = _randn(card, (1, 16, 4, 96), torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
    q = _randn(card, (1, 4, 16, 128), torch.bfloat16).transpose(1, 2)  # (1,16,4,128), strided
    k = _randn(card, (1, 16, 4, 128), torch.bfloat16)
    torch.testing.assert_close(fa.flash_attention(q, k, k).float(), ref.mha(q, k, k).float(),
                               atol=2e-2, rtol=0)
    with pytest.raises(ValueError, match="row-contiguous"):
        fa.flash_attention(q[..., ::2], k[..., :64], k[..., :64])
    qd = _randn(card, (2, 32, 128), torch.bfloat16)
    cache = _randn(card, (2, 64, 2, 128), torch.bfloat16)
    with pytest.raises(ValueError, match="group"):
        da.decode_attention(qd, cache, cache, 10)
