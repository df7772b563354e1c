"""The Hopper kernels against their plain versions, on the card.

Marked ``cuda``: they skip on hosts without a CUDA device of capability 9.0
and run on an H100 with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config
from repro_torch.core import allocator as alloc
from repro_torch.kernels.attention import decode_attention as da
from repro_torch.kernels.attention import flash_attention as fa
from repro_torch.kernels.attention import ops, ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.kernels.ssd import ssd_scan
from repro_torch.models.model import build_model

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


# The shape cases of tests/test_kernels.py, (b, s_q, s_kv, h, kv, d, causal,
# window), with the q_offset chip_smoke.py gives them: D = 32/64/128, the
# window, and non-causal S_q < S_kv (cross attention).
FLASH_CASES = [
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 200, 200, 8, 8, 128, True, 0),
    (2, 64, 256, 4, 1, 32, False, 0),
    (1, 256, 256, 4, 2, 64, True, 64),
    (2, 96, 96, 6, 3, 64, True, 0),
    (1, 128, 512, 4, 4, 128, True, 0),
]


def _flash_check(case, dtype, gen, q_offset=None):
    b, s_q, s_kv, h, kv, d, causal, window = case
    off = (s_kv - s_q if causal else 0) if q_offset is None else q_offset
    q = _randn(gen, (b, s_q, h, d), dtype)
    k, v = (_randn(gen, (b, s_kv, kv, d), dtype) for _ in range(2))
    before = fa.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window, q_offset=off)
    want = ref.mha(q, k, v, causal=causal, window=window, q_offset=off)
    assert fa.launches == before + 1 and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_routes_at_the_kernel_cases(case, dtype, card):
    """bf16 through the wgmma kernel, float32 through the FMA kernel."""
    _flash_check(case, dtype, card)


@pytest.mark.parametrize("s", [100, 200, 1000])
@pytest.mark.parametrize("heads", [(12, 4), (32, 8), (12, 2)], ids=["G3", "G4", "G6"])
def test_flash_wgmma_ragged_lengths_and_gqa_ratios(s, heads, card):
    h, kv = heads
    _flash_check((2, s, s, h, kv, 128, True, 0), torch.bfloat16, card)


@pytest.mark.parametrize("window", [0, 100])
def test_flash_wgmma_long_prompt_two_consumers(window, card):
    """2048 rows x 32 heads: the launch puts two consumer warpgroups in a block."""
    _flash_check((1, 2048, 2048, 32, 8, 128, True, window), torch.bfloat16, card)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_wgmma_reads_strided_views_of_one_projection(d, card):
    """q, k, v as the model could hand them: head slices of one (B, S, (H +
    2·KV)·D) projection, and a (B, H, S, D) tensor seen through a transpose."""
    b, s, h, kv = 2, 150, 8, 2
    proj = _randn(card, (b, s, (h + 2 * kv) * d), torch.bfloat16)
    q = proj[..., :h * d].unflatten(-1, (h, d))
    k = proj[..., h * d:(h + kv) * d].unflatten(-1, (kv, d))
    v = proj[..., (h + kv) * d:].unflatten(-1, (kv, d))
    assert not q.is_contiguous() and not k.is_contiguous()
    got = fa.flash_attention(q, k, v)
    torch.testing.assert_close(got.float(), ref.mha(q, k, v).float(), atol=2e-2, rtol=0)
    qt = _randn(card, (b, h, s, d), torch.bfloat16).transpose(1, 2)
    got = fa.flash_attention(qt, k, v, causal=False)
    want = ref.mha(qt, k, v, causal=False)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)


# The decode kernel: (b, h, kv, d, s_max, cache_len, window).
DECODE_INT_CASES = [
    (2, 8, 2, 64, 300, 150, 0),
    (1, 4, 4, 128, 512, 512, 0),      # len = S_max
    (3, 16, 2, 64, 256, 256, 128),    # rolling sliding-window cache
    (2, 4, 1, 32, 1024, 700, 0),
    (1, 8, 8, 64, 96, 1, 0),          # len 1
    (4, 32, 8, 128, 1024, 300, 0),    # granite-8b
    (4, 12, 2, 128, 1024, 1024, 0),   # qwen2-vl-2b, len = S_max
    (4, 24, 8, 128, 1024, 1, 0),      # minitron-4b, len 1
    (2, 8, 2, 128, 4096, 3000, 500),  # window inside a long cache
]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", DECODE_INT_CASES)
def test_decode_kernel_with_an_int_length(case, dtype, card):
    b, h, kv, d, s_max, clen, window = case
    q = _randn(card, (b, h, d), dtype)
    kc, vc = (_randn(card, (b, s_max, kv, d), dtype) for _ in range(2))
    want = ref.decode_gqa(q, kc, vc, clen, window=window)
    for _ in range(2):  # the second call reuses the scratch and its counters
        before = da.launches
        got = da.decode_attention(q, kc, vc, clen, window=window)
        assert da.launches == before + 1 and got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), atol=ATOL[dtype], rtol=0)
    lens = torch.full((b,), clen, dtype=torch.int32, device="cuda")
    torch.testing.assert_close(da.decode_attention(q, kc, vc, lens, window=window).float(),
                               want.float(), atol=ATOL[dtype], rtol=0)


def _lse_tol(q, kc, dtype):
    """The plain version rounds each bf16 score before its log-sum-exp (the
    kernel keeps float32 scores): within 2^-8 of the largest |score|."""
    if dtype == torch.float32:
        return 1e-4
    b, h, d = q.shape
    kv = kc.shape[2]
    s = torch.einsum("bngd,bknd->bngk", q.float().reshape(b, kv, h // kv, d), kc.float())
    return 1e-4 + 2.0 ** -8 * float(s.abs().max()) * ref.softmax_scale(d)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", DECODE_INT_CASES)
def test_decode_kernel_log_sum_exp(case, dtype, card):
    """With ``return_lse`` the kernel also writes each row's float32
    log-sum-exp, the plain version's within its bf16 score rounding; the
    output is the same bits as without it, int and tensor lengths alike."""
    b, h, kv, d, s_max, clen, window = case
    q = _randn(card, (b, h, d), dtype)
    kc, vc = (_randn(card, (b, s_max, kv, d), dtype) for _ in range(2))
    want, want_lse = ref.decode_gqa(q, kc, vc, clen, window=window, return_lse=True)
    for length in (clen, torch.full((b,), clen, dtype=torch.int32, device="cuda")):
        before = da.launches
        got, lse = da.decode_attention(q, kc, vc, length, window=window, return_lse=True)
        assert da.launches == before + 1 and lse.dtype == torch.float32 and lse.shape == (b, h)
        assert torch.equal(got, da.decode_attention(q, kc, vc, length, window=window))
        torch.testing.assert_close(lse, want_lse, atol=_lse_tol(q, kc, dtype), rtol=0)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", [
    (4, 32, 8, 128, 1024, 300, 0),        # granite G4, shards past the length empty
    (4, 16, 1, 256, 2048, 2048, 2048),    # recurrentgemma: rolled, full
    (4, 32, 8, 128, 4096, 2500, 4096),    # mixtral: rolled, partly filled
    (2, 8, 2, 128, 4096, 3000, 500),      # a window inside the cache
])
@pytest.mark.parametrize("n", [2, 4, 16])
def test_decode_kernel_slot_shards_merge_to_the_whole(case, n, dtype, card):
    """The cache cut into ``n`` slot shards, each call given its slot
    offset: a shard with no valid entry launches nothing (zeros, −inf), and
    the log-sum-exp merge of the shards is the whole-cache kernel's output
    within the dtype's tolerance and its log-sum-exp within 1e-4."""
    b, h, kv, d, s_max, clen, window = case
    q = _randn(card, (b, h, d), dtype)
    kc, vc = (_randn(card, (b, s_max, kv, d), dtype) for _ in range(2))
    whole, whole_lse = da.decode_attention(q, kc, vc, clen, window=window, return_lse=True)
    size = s_max // n
    outs, lses = [], []
    for i in range(n):
        lo, hi = da.valid_range(clen - i * size, size, window)
        before = da.launches
        o, s = da.decode_attention(q, kc[:, i * size:(i + 1) * size],
                                   vc[:, i * size:(i + 1) * size], clen, window=window,
                                   slot_offset=i * size, return_lse=True)
        assert da.launches == before + (hi > lo or i == 0)
        if hi == lo:
            assert not o.any() and bool((s == -torch.inf).all())
        outs.append(o)
        lses.append(s)

    def over_shards(t, op):
        return (t.amax(0) if op == "max" else t.sum(0)).expand_as(t)

    out, lse = ref.merge_decode_shards(torch.stack(outs), torch.stack(lses), over_shards)
    torch.testing.assert_close(out[0].float(), whole.float(), atol=ATOL[dtype], rtol=0)
    torch.testing.assert_close(lse[0], whole_lse, atol=1e-4, rtol=0)


def test_decode_is_one_launch_per_call(card):
    """One device kernel per call with an int length: no fill, no combine."""
    from torch.profiler import ProfilerActivity, profile

    q = _randn(card, (4, 32, 128), torch.bfloat16)
    kc, vc = (_randn(card, (4, 1024, 8, 128), torch.bfloat16) for _ in range(2))
    da.decode_attention(q, kc, vc, 300)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            da.decode_attention(q, kc, vc, 300)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    names = {e.name for e in kernels}
    assert len(kernels) == 3 and all("repro::" in n and "decode_" in n for n in names), names


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
    qd = _randn(card, (2, 64, 128), torch.bfloat16)  # 32 query heads per kv head
    cache = _randn(card, (2, 64, 2, 128), torch.bfloat16)
    with pytest.raises(ValueError, match="group"):
        da.decode_attention(qd, cache, cache, 10)
    qd = _randn(card, (2, 4, 96), torch.bfloat16)
    cache = _randn(card, (2, 64, 2, 96), torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        da.decode_attention(qd, cache, cache, 10)
    qd, cache = _randn(card, (2, 4, 64), torch.float16), _randn(card, (2, 64, 2, 64), torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        da.decode_attention(qd, cache, cache, 10)


# The SSD scan: tests/test_kernels.py's tolerances, plus one bfloat16 step of
# the output's magnitude (2^-7 relative), since the kernel and the plain
# version each round a float32 y to bfloat16 once and may land on the two
# sides of a rounding boundary; at N = 128 |y| reaches ~100, where one step
# is 0.5.
SSD_ATOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
SSD_RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7}


def _ssd_inputs(gen, b, s, h, p, n, dtype, h0=False):
    x = (torch.randn((b, s, h, p), generator=gen, device="cuda") * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen, device="cuda"))
    A = -torch.exp(torch.randn((h,), generator=gen, device="cuda") * 0.3)
    Bm, Cm = (_randn(gen, (b, s, n), dtype) for _ in range(2))
    D = torch.ones((h,), device="cuda")
    h0 = torch.randn((b, h, p, n), generator=gen, device="cuda") if h0 else None
    return x, dt, A, Bm, Cm, D, h0


def _assert_ssd_close(got, want, dtype):
    (gy, gh), (wy, wh) = got, want
    assert gy.dtype == dtype and gh.dtype == torch.float32
    torch.testing.assert_close(gy.float(), wy.float(), atol=SSD_ATOL[dtype], rtol=SSD_RTOL[dtype])
    torch.testing.assert_close(gh, wh, atol=SSD_ATOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", [
    # (b, s, h, p, n, chunk, h0)
    (2, 128, 4, 32, 16, 32, False),
    (1, 100, 2, 32, 16, 32, False),    # ragged last chunk
    (2, 77, 8, 16, 8, 16, True),       # ragged, with an initial state
    (1, 1, 2, 64, 32, 64, True),       # one token
    (3, 200, 3, 64, 24, 128, False),   # N not a multiple of 16
])
def test_ssd_kernel_matches_plain(case, dtype, card):
    b, s, h, p, n, chunk, with_h0 = case
    x, dt, A, Bm, Cm, D, h0 = _ssd_inputs(card, b, s, h, p, n, dtype, with_h0)
    before = ssd_scan.launches
    got = ssd_ops.ssd(x, dt, A, Bm, Cm, D, h0=h0, chunk=chunk)
    assert ssd_scan.launches == before + 1
    _assert_ssd_close(got, ssd_ref.ssd_naive(x, dt, A, Bm, Cm, D, h0=h0), dtype)


@pytest.mark.parametrize("s", [128, 700])
def test_ssd_kernel_at_mamba_width(s, card):
    x, dt, A, Bm, Cm, D, _ = _ssd_inputs(card, 1, s, 32, 64, 128, torch.bfloat16)
    _assert_ssd_close(ssd_ops.ssd(x, dt, A, Bm, Cm, D, chunk=128),
                      ssd_ref.ssd_chunked(x, dt, A, Bm, Cm, D, chunk=128), torch.bfloat16)


# tests/test_kernels.py's SSD cases, then test_ssd_initial_state's.
SSD_KERNEL_CASES = [
    # (b, s, h, p, n, chunk, h0)
    (2, 128, 4, 32, 16, 32, False),
    (1, 96, 2, 64, 32, 32, False),
    (2, 64, 8, 16, 8, 16, False),
    (1, 100, 2, 32, 16, 32, False),
    (1, 64, 2, 16, 8, 16, True),
]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", SSD_KERNEL_CASES)
def test_ssd_routes_at_the_kernel_cases(case, dtype, card):
    """bf16 on the tensor-core kernel, float32 on the FMA kernel, one count
    per call, against the plain scan at the caller's chunk."""
    b, s, h, p, n, chunk, with_h0 = case
    x, dt, A, Bm, Cm, D, h0 = _ssd_inputs(card, b, s, h, p, n, dtype, with_h0)
    assert ssd_scan.route(dtype) == {torch.bfloat16: "mma", torch.float32: "fma"}[dtype]
    before = ssd_scan.launches
    got = ssd_scan.ssd(x, dt, A, Bm, Cm, D, h0=h0, chunk=chunk)
    assert ssd_scan.launches == before + 1
    _assert_ssd_close(got, ssd_ref.ssd_chunked(x, dt, A, Bm, Cm, D, h0=h0, chunk=chunk), dtype)


@pytest.mark.parametrize("s", [1, 63, 64, 65, 129, 500])
def test_ssd_mma_ragged_lengths_at_mamba_width(s, card):
    """Lengths around the kernel's 64-token chunk, at mamba2-370m's widths."""
    x, dt, A, Bm, Cm, D, h0 = _ssd_inputs(card, 1, s, 32, 64, 128, torch.bfloat16, h0=s == 65)
    _assert_ssd_close(ssd_scan.ssd(x, dt, A, Bm, Cm, D, h0=h0, chunk=128),
                      ssd_ref.ssd_chunked(x, dt, A, Bm, Cm, D, h0=h0, chunk=128),
                      torch.bfloat16)


@pytest.mark.parametrize("n", [8, 16, 128])
@pytest.mark.parametrize("p", [16, 32, 64])
def test_ssd_mma_head_and_state_dims(p, n, card):
    """Every P the kernel takes (1, 2 or 4 blocks per head) and N padded in
    shared memory (8) or not (16, 128), from an initial state."""
    x, dt, A, Bm, Cm, D, h0 = _ssd_inputs(card, 2, 150, 3, p, n, torch.bfloat16, h0=True)
    _assert_ssd_close(ssd_scan.ssd(x, dt, A, Bm, Cm, D, h0=h0),
                      ssd_ref.ssd_naive(x, dt, A, Bm, Cm, D, h0=h0), torch.bfloat16)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_ssd_kernel_reads_strided_views(dtype, card):
    """x, B and C as the model hands them: column slices of one projection."""
    b, s, h, p, n = 2, 90, 4, 32, 16
    proj = (torch.randn((b, s, h * p + 2 * n), generator=card, device="cuda") * 0.5).to(dtype)
    x = proj[..., :h * p].reshape(b, s, h, p)
    Bm, Cm = proj[..., h * p:h * p + n], proj[..., h * p + n:]
    _, dt, A, _, _, D, _ = _ssd_inputs(card, b, s, h, p, n, torch.float32)
    assert not x.is_contiguous() and not Bm.is_contiguous()
    _assert_ssd_close(ssd_scan.ssd(x, dt, A, Bm, Cm, D),
                      ssd_ref.ssd_naive(x, dt, A, Bm, Cm, D), dtype)


def test_ssd_bf16_is_one_launch_per_call(card):
    """One device kernel per bf16 call: no scratch pass, no state walk.  On
    the card the profiler has lost all of a session's device events after
    an earlier session in the same process: a session that shows none is
    taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile

    x, dt, A, Bm, Cm, D, _ = _ssd_inputs(card, 1, 512, 32, 64, 128, torch.bfloat16)
    assert ssd_scan.plan(1, 512, 32, 64, 128, torch.bfloat16).scratch == ()
    ssd_scan.ssd(x, dt, A, Bm, Cm, D, chunk=128)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                ssd_scan.ssd(x, dt, A, Bm, Cm, D, chunk=128)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    assert len(names) == 3 and all("ssd_sm90_kernel" in nm for nm in names), names


def test_ssd_wrapper_refuses_what_the_kernel_does_not_take(card):
    x, dt, A, Bm, Cm, D, _ = _ssd_inputs(card, 1, 64, 2, 32, 16, torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        ssd_scan.ssd(x.half(), dt, A, Bm.half(), Cm.half(), D)
    with pytest.raises(ValueError, match="dtype"):
        ssd_scan.ssd(x, dt, A, Bm.bfloat16(), Cm, D)
    with pytest.raises(ValueError, match="head dim"):
        ssd_scan.ssd(torch.cat([x, x[..., :16]], -1), dt, A, Bm, Cm, D)
    big = torch.zeros((1, 64, 256), device="cuda")
    with pytest.raises(ValueError, match="state dim"):
        ssd_scan.ssd(x, dt, A, big, big, D)
    with pytest.raises(ValueError, match="chunk"):
        ssd_scan.ssd(x, dt, A, Bm, Cm, D, chunk=256)
    wide = torch.zeros((1, 64, 32), device="cuda")
    with pytest.raises(ValueError, match="strided last dim"):
        ssd_scan.ssd(x, dt, A, wide[..., ::2], Cm, D)
    with pytest.raises(ValueError, match="shapes"):
        ssd_scan.ssd(x, dt[:, :10], A, Bm, Cm, D)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ssd_scan.ssd(x, dt, A, Bm, Cm, D, h0=torch.zeros((1, 2, 32, 16)))
    xb, Bb, Cb = x.bfloat16(), Bm.bfloat16(), Cm.bfloat16()
    with pytest.raises(ValueError, match="head dim"):
        ssd_scan.ssd(torch.cat([xb, xb[..., :8]], -1), dt, A, Bb, Cb, D)
    with pytest.raises(ValueError, match="strided last dim"):
        ssd_scan.ssd(xb, dt, A, wide.bfloat16()[..., ::2], Cb, D)
    proj = torch.zeros((1, 64, 2 * 12), dtype=torch.bfloat16, device="cuda")  # N = 12
    with pytest.raises(ValueError, match="16-byte aligned"):
        ssd_scan.ssd(xb, dt, A, proj[..., :12], proj[..., 12:], D)


def test_mamba_prefill_goes_through_the_kernel(card):
    cfg = get_config("mamba2-370m", reduced=True)
    api = build_model(cfg)
    params = api.init(0, dtype=torch.float32)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), generator=card, device="cuda")
    before = ssd_scan.launches
    got, caches = api.prefill(params, {"tokens": tokens}, 48)
    assert ssd_scan.launches == before + cfg.num_layers
    want, ref_caches = api.prefill(params, {"tokens": tokens}, 48, impl="ref")
    assert ssd_scan.launches == before + cfg.num_layers
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    for c, r in zip(caches["blocks"], ref_caches["blocks"]):
        torch.testing.assert_close(c["h"], r["h"], atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# The serverless layers on the card: the simulator's step loop and the
# engine's scheduling agree with the CPU.
# ---------------------------------------------------------------------------

def _serverless_layers():
    from repro_torch.core import capacity, failures, routing

    return {"workflow": routing.coordinator_star(4),
            "capacity": capacity.capacity_config("reactive", cold_start_s=3.0,
                                                 min_instances=1.0),
            "failures": failures.failure_scenario_library(seed=1)[-1]}


@pytest.mark.parametrize("layers", ["none", "all"])
@pytest.mark.parametrize("policy", alloc.policy_names())
def test_simulate_on_the_card_matches_the_cpu(policy, layers, card):
    """Every registered policy, with no serverless layer and with all three
    on: the card's trace equals the CPU's within rtol 1e-5 (atol 1e-5)."""
    import numpy as np

    from repro_torch.core import agents, simulator

    arr = np.random.default_rng(0).poisson(
        np.asarray(agents.PAPER_ARRIVAL_RATES) * 2.0, (60, 4)).astype(np.float32)
    kw = {} if layers == "none" else _serverless_layers()
    config = simulator.SimConfig(num_gpus=8.0)
    fleet = agents.paper_fleet()
    got = simulator.simulate(policy, arr, fleet, config, **kw)
    want = simulator.simulate(policy, arr, fleet, config, device="cpu", **kw)
    for field, w in want.fields().items():
        g = got.fields()[field]
        assert g.device.type == "cuda"
        torch.testing.assert_close(g.cpu(), w, rtol=1e-5, atol=1e-5, msg=field)


def test_reduced_serverless_engine_schedules_identically_on_both_devices(card):
    """The dense fleet at reduced widths with routing, a reactive pool and
    failures on: the scheduling fields of the history and ``metrics()``
    are equal on the card and on the CPU (the schedule never reads the
    logits)."""
    import numpy as np

    from repro_torch.core import capacity, failures, routing
    from repro_torch.launch.serve import DENSE_FLEET, build_engine
    from repro_torch.serving.engine import FleetEngine

    def engine(device):
        base = build_engine("adaptive", fleet=DENSE_FLEET, budget_tokens=64, max_len=64,
                            batch_slots=2, device=device)
        return FleetEngine(
            base.fleet, {rt.name: rt for rt in base.runtimes}, budget_tokens=64,
            num_gpus=2.0, workflow=routing.coordinator_star(4, fan_out=3.0),
            capacity=capacity.capacity_config("reactive", cold_start_s=2,
                                              target_rate_per_instance=2,
                                              backlog_per_instance=4, min_instances=1),
            failures=failures.failure_spec("x", revoke_p_enter=0.3, revoke_p_exit=0.5,
                                           revoke_frac=0.5, outage_start=3, outage_len=2,
                                           outage_agent=2, deadline_s=3, retry_budget=1),
            device=device)

    engines = engine("cuda"), engine("cpu")
    rng = np.random.default_rng(0)
    for _ in range(8):
        for _ in range(rng.poisson(2)):
            prompt, new = rng.integers(0, 512, int(rng.integers(3, 20))), int(rng.integers(2, 6))
            for eng in engines:
                eng.submit("coordinator", prompt, new)
        for eng in engines:
            eng.step()
    card_eng, cpu_eng = engines
    keys = ("allocation", "queues", "decode_tokens", "routed", "warm", "pending",
            "revoked_frac", "down")
    for h_card, h_cpu in zip(card_eng.history, cpu_eng.history):
        assert {k: h_card[k] for k in keys} == {k: h_cpu[k] for k in keys}
    m_card, m_cpu = card_eng.metrics(), cpu_eng.metrics()
    assert m_card["routed_requests"] > 0
    assert json.dumps(m_card, sort_keys=True) == json.dumps(m_cpu, sort_keys=True)


@pytest.mark.parametrize("policy", ["adaptive", "sqrt_demand", "ema_water_filling"])
def test_the_card_keeps_subnormals(policy, card):
    """The port flushes no denormals on the card: float32 subnormals
    survive its elementwise kernels, and a simulate whose rates are
    subnormal (ROADMAP C's case) equals the CPU's."""
    import numpy as np

    from repro_torch.core import agents, simulator

    tiny = torch.tensor([1e-45, 1.18e-38, 1e-40], dtype=torch.float32)
    x = tiny.cuda()
    assert torch.equal((x * 1.0).cpu(), tiny) and torch.equal((x + 0.0).cpu(), tiny)
    assert ((x[1:] / 2).cpu() > 0).all()
    arr = np.tile(np.asarray([1e-45, 100.0, 300.0, 1.18e-38], np.float32), (6, 1))
    got = simulator.simulate(policy, arr, agents.paper_fleet())
    want = simulator.simulate(policy, arr, agents.paper_fleet(), device="cpu")
    for field, w in want.fields().items():
        torch.testing.assert_close(got.fields()[field].cpu(), w, rtol=1e-5, atol=1e-5,
                                   msg=field)


# ---------------------------------------------------------------------------
# The sweep grids on the card: each entry point against the CPU, and the
# loop synthesis's bits.
# ---------------------------------------------------------------------------

def _sweep_gap(got, want):
    """The largest distance in units of rtol 1e-5 with an atol of 1e-5 of
    each metric column's (each per-agent grid's) largest magnitude."""
    import numpy as np

    worst = 0.0
    for field in ("metrics", "per_agent_latency", "per_agent_throughput", "per_agent_queue"):
        g, w = (np.asarray(getattr(r, field), np.float64) for r in (got, want))
        assert g.shape == w.shape
        axes = tuple(range(w.ndim - 1)) if field == "metrics" else None
        atol = 1e-5 * np.maximum(np.abs(w).max(axis=axes), 1.0)
        worst = max(worst, float((np.abs(g - w) / (atol + 1e-5 * np.abs(w))).max()))
    return worst


def _sweep_grids():
    import importlib

    from repro_torch.core import agents, failures, simulator

    sw = importlib.import_module("repro_torch.core.sweep")
    fleet = agents.paper_fleet()
    lib = sw.scenario_library(agents.PAPER_ARRIVAL_RATES, 30)
    fleets = [agents.synthetic_fleet(n, seed=n) for n in (4, 16, 256)]
    return {
        "sweep": lambda **k: sw.sweep(fleet, lib, **k),
        "chaos": lambda **k: sw.sweep(fleet, lib[:3], failures=failures.failure_scenario_library(),
                                      **k),
        "fleets": lambda **k: sw.sweep_fleets(fleets, num_steps=20, **k),
        "workflows": lambda **k: sw.sweep_workflows(fleet, num_steps=30, **k),
        "capacity": lambda **k: sw.sweep_capacity(fleet, num_steps=30,
                                                  config=simulator.SimConfig(num_gpus=8.0), **k),
    }


@pytest.mark.parametrize("grid", ["sweep", "chaos", "fleets", "workflows", "capacity"])
def test_sweep_on_the_card_matches_the_cpu(grid, card):
    """Each entry point's stream on the card equals the CPU's within rtol
    1e-5 (atol 1e-5 of each column's magnitude), and returns device
    tensors with ``return_arrays``."""
    run = _sweep_grids()[grid]
    assert _sweep_gap(run(device="cuda"), run(device="cpu")) <= 1.0
    assert run(device="cuda", return_arrays=True)[0].device.type == "cuda"


def test_loop_synthesis_on_the_card_is_the_cpus_bits(card):
    """The whole scenario library synthesized on the card, per step and in
    blocks, is bit for bit the CPU's; so are the failure uniforms."""
    import numpy as np

    from repro_torch.core import failures, prng, workload

    specs = workload.stack_specs(workload.scenario_specs(workload.synthetic_rates(64, seed=3),
                                                         200, seed=5))
    rows = {}
    for dev in ("cuda", "cpu"):
        synth = workload.Synth(specs, dev)
        state = synth.init()
        block, _ = synth.block(state, 0, 200)
        step, _ = synth.step(state, 0)
        rows[dev] = (block.cpu(), step.cpu())
    for a, b in zip(rows["cuda"], rows["cpu"]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    spec = failures.failure_scenario_library(seed=4)[-1]
    u_rev, u_down = failures.failure_uniforms_t(prng.key_t(spec.key_data, "cuda"), 0, 50, 64)
    want_rev, want_down = failures.failure_uniforms(spec, np.arange(50), 64)
    assert torch.equal(u_rev.cpu(), want_rev) and torch.equal(u_down.cpu(), want_down)


def test_sweep_block_sizes_agree_on_the_card(card):
    """Block sizes 1, 8 and 64 give the same metrics on the card, with
    loop synthesis, capacity and failures on."""
    import importlib

    import numpy as np

    from repro_torch.core import agents, capacity, failures, simulator, workload

    sw = importlib.import_module("repro_torch.core.sweep")
    specs = workload.scenario_specs(workload.synthetic_rates(4, seed=0), 70, 0)
    kw = dict(config=simulator.SimConfig(num_gpus=8.0), device="cuda",
              capacity=capacity.capacity_config("reactive", cold_start_s=3.0,
                                                min_instances=1.0),
              failures=failures.failure_scenario_library()[-1])
    base = sw.sweep(agents.paper_fleet(), specs, block_size=1, **kw).metrics
    for b in (8, 64):
        assert np.array_equal(sw.sweep(agents.paper_fleet(), specs, block_size=b, **kw).metrics,
                              base)


def _moe_case(e, k, s, d=256, f=512, seed=0):
    import dataclasses

    cfg = dataclasses.replace(get_config("mixtral-8x7b", reduced=True), num_experts=e,
                              experts_per_token=k, d_model=d, d_ff=f)
    gen = torch.Generator().manual_seed(seed)
    n = lambda *shape: torch.randn(shape, generator=gen) / shape[-2] ** 0.5
    params = {"router": n(d, e), "w_gate": n(e, d, f), "w_up": n(e, d, f), "w_down": n(e, f, d)}
    return cfg, params, torch.randn((2, s, d), generator=gen)


@pytest.mark.parametrize("factor", [1.25, 0.25])
@pytest.mark.parametrize("ek", [(8, 2), (32, 8)], ids=["mixtral", "granite_moe"])
def test_moe_on_the_card_matches_the_cpu(ek, factor, card):
    """float32 MoE on the card (TF32 off) against the same call on the host:
    the same expert ids, drops and outputs."""
    from repro_torch.models import moe

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg, params, x = _moe_case(*ek, s=300)
    want, want_aux = moe.moe_ffn(x, params, cfg, capacity_factor=factor)
    on_card = {n: t.cuda() for n, t in params.items()}
    got, got_aux = moe.moe_ffn(x.cuda(), on_card, cfg, capacity_factor=factor)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)
    torch.testing.assert_close(got_aux.cpu(), want_aux, atol=1e-5, rtol=0)
    assert torch.equal(moe._router(x.cuda(), on_card, cfg)[1].cpu(), moe._router(x, params, cfg)[1])
    assert torch.equal((got.cpu() == 0).all(-1), (want == 0).all(-1))
    zeros = torch.zeros((2, 16, cfg.d_model), device="cuda")
    ids = moe._router(zeros, on_card, cfg)[1]
    assert torch.equal(ids.cpu(), torch.arange(cfg.experts_per_token).expand(2, 16, -1))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_decode_kernel_over_a_full_rolling_cache(dtype, card):
    """mixtral-8x7b's decode once its context has passed its window: 4 rows
    over a rolled cache of 4096 entries, every entry valid."""
    b, h, kv, d, s_max = 4, 32, 8, 128, 4096
    q = _randn(card, (b, h, d), dtype)
    kc, vc = (_randn(card, (b, s_max, kv, d), dtype) for _ in range(2))
    before = da.launches
    got = ops.decode_attention(q, kc, vc, s_max, window=s_max)
    want = ref.decode_gqa(q, kc, vc, s_max, window=s_max)
    assert da.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("prompt", [4100, 8192], ids=["rolled", "banded"])
def test_rolling_window_model_through_the_kernels(prompt, card):
    """Reduced mixtral with its published window of 4096, float32: a prompt
    past the window (rolled into the cache; at 8192 the plain route is
    banded), then 4 decode steps into the rolled cache, kernels against the
    plain versions."""
    import dataclasses

    cfg = dataclasses.replace(get_config("mixtral-8x7b", reduced=True), sliding_window=4096)
    api = build_model(cfg)
    params = api.init(0, dtype=torch.float32)
    tokens = torch.randint(0, cfg.vocab_size, (1, prompt), generator=card, device="cuda")
    before = (fa.launches, da.launches)
    got, caches = api.prefill(params, {"tokens": tokens}, 2 * prompt)
    want, ref_caches = api.prefill(params, {"tokens": tokens}, 2 * prompt, impl="ref")
    assert caches["blocks"][0]["k"].shape[1] == 4096
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    for i in range(4):
        tok = got.argmax(-1)
        got, caches = api.decode_step(params, caches, tok, prompt + i, 2 * prompt)
        want, ref_caches = api.decode_step(params, ref_caches, tok, prompt + i, 2 * prompt,
                                           impl="ref")
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    assert (fa.launches, da.launches) == (before[0] + cfg.num_layers,
                                          before[1] + 4 * cfg.num_layers)


# ---------------------------------------------------------------------------
# Head dim 256 and 16 query heads per kv head (recurrentgemma-9b's local
# attention: 16 on 1, window 2048), and flash without a causal mask at one
# query row (the enc-dec family's cross attention in decode).
# ---------------------------------------------------------------------------

D256_FLASH_CASES = [
    # (b, s_q, s_kv, h, kv, d, causal, window)
    (1, 200, 200, 16, 1, 256, True, 0),        # ragged, 16 heads on 1
    (2, 130, 130, 4, 2, 256, True, 64),        # a window
    (1, 96, 300, 8, 8, 256, False, 0),         # no mask, S_q < S_kv
    (1, 1024, 1024, 16, 1, 256, True, 512),    # one consumer per block
    (2, 2048, 2048, 16, 1, 256, True, 2048),   # a grid that takes two consumers at D <= 128
]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", D256_FLASH_CASES)
def test_flash_kernel_at_head_dim_256(case, dtype, card):
    _flash_check(case, dtype, card)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("s_kv", [64, 1000, 4096])
def test_flash_at_one_query_row_without_a_mask(s_kv, d, dtype, card):
    """Cross attention in decode: one query row per batch row over every
    encoder frame (seamless-m4t-large-v2: 16 heads on 16, D = 64)."""
    _flash_check((4, 1, s_kv, 16, 16, d, False, 0), dtype, card)


D256_DECODE_CASES = [
    # (b, h, kv, d, s_max, cache_len, window)
    (4, 16, 1, 256, 2048, 2048, 2048),   # recurrentgemma-9b over a full rolling cache
    (4, 16, 1, 256, 2048, 300, 2048),
    (2, 16, 1, 256, 1024, 1, 0),         # len 1
    (2, 32, 2, 256, 512, 400, 100),      # 16 on 1 for two kv heads, a window
    (3, 12, 1, 128, 700, 650, 0),        # 12 rows: 8..11 real, 12..15 padding
    (2, 16, 1, 64, 256, 256, 0),
    (1, 8, 1, 256, 512, 333, 0),         # 8 rows at D = 256
]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", D256_DECODE_CASES)
def test_decode_kernel_at_head_dim_256_and_16_rows(case, dtype, card):
    b, h, kv, d, s_max, clen, window = case
    q = _randn(card, (b, h, d), dtype)
    kc, vc = (_randn(card, (b, s_max, kv, d), dtype) for _ in range(2))
    want = ref.decode_gqa(q, kc, vc, clen, window=window)
    before = da.launches
    got = da.decode_attention(q, kc, vc, clen, window=window)
    assert da.launches == before + 1 and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=ATOL[dtype], rtol=0)
    lens = torch.tensor([clen - i % 2 if clen > 1 else 1 for i in range(b)], dtype=torch.int32,
                        device="cuda")
    torch.testing.assert_close(da.decode_attention(q, kc, vc, lens, window=window).float(),
                               ref.decode_gqa(q, kc, vc, lens, window=window).float(),
                               atol=ATOL[dtype], rtol=0)


def test_decode_split_fits_shared_memory(card):
    """At D = 256 with 16 rows, eight chunks' partials would not fit in
    shared memory beside the ring: the plan takes fewer, and every split the
    plan may pick launches."""
    assert da.max_split(torch.bfloat16, 128, 8) == da.MAX_SPLIT
    for dtype in DTYPES:
        most = da.max_split(dtype, 256, 16)
        assert 1 <= most < da.MAX_SPLIT
        assert da.split_plan(4, 1, 2048, most)[1] == most
    q = _randn(card, (1, 16, 256), torch.bfloat16)
    kc, vc = (_randn(card, (1, 4096, 1, 256), torch.bfloat16) for _ in range(2))
    torch.testing.assert_close(da.decode_attention(q, kc, vc, 4096).float(),
                               ref.decode_gqa(q, kc, vc, 4096).float(), atol=2e-2, rtol=0)


def _launches():
    return fa.launches, da.launches


@pytest.mark.parametrize("prompt", [300, 2100, 4096], ids=["inside", "rolled", "banded"])
def test_hybrid_model_through_the_kernels(prompt, card):
    """Reduced recurrentgemma-9b with its published head layout (16 heads of
    256 on one kv head) and window of 2048, float32: a prompt inside the
    window, past it (rolled into the cache) and of two windows (banded on
    the plain route), then 4 decode steps, kernels against plain versions."""
    import dataclasses

    cfg = dataclasses.replace(get_config("recurrentgemma-9b", reduced=True), num_heads=16,
                              num_kv_heads=1, head_dim=256, attention_window=2048)
    api = build_model(cfg)
    params = api.init(0, dtype=torch.float32)
    tokens = torch.randint(0, cfg.vocab_size, (1, prompt), generator=card, device="cuda")
    n_attn = cfg.block_pattern.count("attn")
    before = _launches()
    got, caches = api.prefill(params, {"tokens": tokens}, 2 * prompt)
    want, ref_caches = api.prefill(params, {"tokens": tokens}, 2 * prompt, impl="ref")
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    for i in range(4):
        tok = got.argmax(-1)
        got, caches = api.decode_step(params, caches, tok, prompt + i, 2 * prompt)
        want, ref_caches = api.decode_step(params, ref_caches, tok, prompt + i, 2 * prompt,
                                           impl="ref")
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    assert _launches() == (before[0] + n_attn, before[1] + 4 * n_attn)


def test_encdec_model_through_the_kernels(card):
    """Reduced seamless-m4t-large-v2, float32: 600 encoder frames, a
    50-token prompt and 4 steps; the encoder and the cross attention run
    flash without a causal mask (at one query row in decode)."""
    cfg = get_config("seamless-m4t-large-v2", reduced=True)
    api = build_model(cfg)
    params = api.init(0, dtype=torch.float32)
    tokens = torch.randint(0, cfg.vocab_size, (2, 50), generator=card, device="cuda")
    frames = torch.randn((2, 600, cfg.d_model), generator=card, device="cuda") * 0.02
    batch = {"tokens": tokens, "frontend_embeds": frames}
    before = _launches()
    got, caches = api.prefill(params, batch, 64)
    assert _launches() == (before[0] + cfg.encoder_layers + 2 * cfg.num_layers, before[1])
    want, ref_caches = api.prefill(params, batch, 64, impl="ref")
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    for i in range(4):
        tok = got.argmax(-1)
        got, caches = api.decode_step(params, caches, tok, 50 + i, 64)
        want, ref_caches = api.decode_step(params, ref_caches, tok, 50 + i, 64, impl="ref")
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    assert _launches() == (before[0] + cfg.encoder_layers + 6 * cfg.num_layers,
                           before[1] + 4 * cfg.num_layers)


# ---------------------------------------------------------------------------
# Training: flash attention's and the SSD scan's backward kernels, the
# decode kernel refusing a gradient, and
# a reduced train step on the card against the same step on the CPU.
# ---------------------------------------------------------------------------

# (b, s_q, s_kv, h, kv, d, causal, window, q_offset): every head dim, GQA
# groups up to 16, a window, S_q != S_kv with and without a causal mask.
FLASH_GRAD_CASES = [
    (1, 77, 77, 4, 2, 32, True, 0, 0),
    (2, 130, 200, 6, 2, 64, True, 0, 70),
    (1, 300, 300, 8, 4, 128, True, 40, 0),
    (3, 33, 65, 4, 4, 64, False, 0, 0),
    (2, 128, 128, 16, 1, 256, True, 0, 0),
    (1, 200, 200, 16, 1, 256, True, 64, 0),
    (1, 96, 300, 8, 8, 256, False, 0, 0),
    (1, 100, 100, 16, 1, 64, True, 0, 0),
    (1, 64, 80, 4, 2, 64, True, 16, 10),    # a window at an offset
]
BF16_STEP = 2.0 ** -7   # one bf16 step, relative to a gradient's max|g|
GRAD_F32_RTOL = 1e-5    # float32 kernel vs plain: the same sums in another order


def _rel_gap(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1e-30))


def _flash_grad_inputs(case, dtype, gen):
    b, s_q, s_kv, h, kv, d, causal, window, off = case
    qkv = [_randn(gen, shape, dtype) for shape in ((b, s_q, h, d), (b, s_kv, kv, d),
                                                    (b, s_kv, kv, d))]
    return qkv, _randn(gen, (b, s_q, h, d), dtype), dict(causal=causal, window=window,
                                                         q_offset=off)


def _flash_grad_reference(qkv, dout, kw, dtype):
    """(the gradients to hold the kernel's against, each input's tolerance
    relative to its max|g|).  float32: ``ref.flash_bwd_plain`` on the same
    inputs, within GRAD_F32_RTOL.  bf16: the float32 plain gradient of the
    same inputs upcast, within the larger of twice the bf16 plain route's
    own gap to it and one bf16 step."""
    up = [x.float() for x in qkv]
    out32, lse32 = ref.flash_plain_lse(*up, **kw)
    want = ref.flash_bwd_plain(*up, out32, lse32, dout.float(), **kw)
    if dtype == torch.float32:
        return want, [GRAD_F32_RTOL] * 3
    leaves = [x.clone().requires_grad_() for x in qkv]
    plain = torch.autograd.grad(ref.flash_plain(*leaves, **kw), leaves, dout)
    return want, [max(2 * _rel_gap(p, w), BF16_STEP) for p, w in zip(plain, want)]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", FLASH_GRAD_CASES)
def test_flash_backward_kernel_matches_plain(case, dtype, card):
    """The forward kernel's log-sum-exp within 1e-4 of the float32 plain one
    (the kernel's scores are float32 sums of exact bf16 products), and the
    backward kernel's dq, dk, dv against ``_flash_grad_reference``; a second
    call gives the same bits (no atomics)."""
    qkv, dout, kw = _flash_grad_inputs(case, dtype, card)
    out, lse = fa._launch(*qkv, lse=True, **kw)
    torch.testing.assert_close(lse, ref.flash_lse(*(x.float() for x in qkv[:2]), **kw),
                               atol=1e-4, rtol=0)
    torch.testing.assert_close(out.float(), ref.flash_plain(*qkv, **kw).float(),
                               atol=ATOL[dtype], rtol=0)
    before = fa.bwd_launches
    got = fa.flash_attention_bwd(*qkv, out, lse, dout, **kw)
    again = fa.flash_attention_bwd(*qkv, out, lse, dout, **kw)
    assert fa.bwd_launches == before + 2
    assert all(g.dtype == dtype and g.shape == x.shape for g, x in zip(got, qkv))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if dtype == torch.float32:  # against the plain backward on the kernel's own out and lse
        want = ref.flash_bwd_plain(*qkv, out, lse, dout, **kw)
        gaps = [_rel_gap(g, w) for g, w in zip(got, want)]
        assert max(gaps) <= GRAD_F32_RTOL, gaps
    want, tols = _flash_grad_reference(qkv, dout, kw, dtype)
    gaps = [_rel_gap(g, w) for g, w in zip(got, want)]
    assert all(g <= t for g, t in zip(gaps, tols)), (gaps, tols)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", FLASH_GRAD_CASES[:5])
def test_flash_gradients_through_the_kernel(case, dtype, card):
    """Autograd through ``ops.flash_attention``: one forward launch with the
    log-sum-exp and one backward launch, no plain backward; the gradients
    held as ``_flash_grad_reference`` says."""
    qkv, cot, kw = _flash_grad_inputs(case, dtype, card)
    leaves = [x.clone().requires_grad_() for x in qkv]
    before = (fa.launches, fa.bwd_launches)
    out = ops.flash_attention(*leaves, **kw)
    assert (fa.launches, fa.bwd_launches) == (before[0] + 1, before[1])
    assert out.grad_fn is not None
    torch.testing.assert_close(out.detach().float(), ref.flash_plain(*qkv, **kw).float(),
                               atol=ATOL[dtype], rtol=0)
    got = torch.autograd.grad(out, leaves, cot)
    assert (fa.launches, fa.bwd_launches) == (before[0] + 1, before[1] + 1)
    want, tols = _flash_grad_reference(qkv, cot, kw, dtype)
    gaps = [_rel_gap(g, w) for g, w in zip(got, want)]
    assert all(g <= t for g, t in zip(gaps, tols)), (gaps, tols)


# minitron-4b's group of 3 (24 q / 8 kv heads), which divides no tile; S_q
# != S_kv at a q_offset, with and without a window; qwen2-vl-2b's group of 6
# over ragged lengths.
FLASH_GRAD_ODD_CASES = [
    (1, 200, 200, 24, 8, 128, True, 0, 0),
    (2, 96, 96, 3, 1, 64, True, 0, 0),
    (1, 100, 260, 12, 4, 128, True, 0, 160),
    (2, 70, 190, 6, 2, 64, True, 48, 120),
    (1, 150, 333, 12, 2, 128, False, 0, 0),
]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", FLASH_GRAD_ODD_CASES)
def test_flash_backward_kernel_at_odd_groups_and_offsets(case, dtype, card):
    """``test_flash_backward_kernel_matches_plain``'s checks, two calls bit
    for bit included, at groups and offsets that no tile divides."""
    test_flash_backward_kernel_matches_plain(case, dtype, card)


def test_flash_backward_is_its_documented_device_kernels(card):
    """Each backward call is ``fa.bwd_plan``'s device kernels in their order
    (Δ, dK/dV, at G > 1 on the bf16 route the sum over the group, dQ), in
    both dtypes, at G = 3 and G = 1: the last three of four calls in one
    profiler session (the first call is not counted, as in
    ``test_ssd_backward_is_its_documented_device_kernels``); a session that
    does not show the pattern is taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile

    calls = 3
    for dtype in DTYPES:
        for case in ((1, 200, 200, 24, 8, 128, True, 0, 0), (2, 130, 130, 4, 4, 64, True, 0, 0)):
            qkv, dout, kw = _flash_grad_inputs(case, dtype, card)
            out, lse = fa._launch(*qkv, lse=True, **kw)
            b, s_q, s_kv, h, kv, d = case[:6]
            order = fa.bwd_plan(b, s_q, s_kv, h, kv, d, dtype=dtype, **kw).kernels
            assert len(order) == (4 if dtype == torch.bfloat16 and h > kv else 3)
            fa.flash_attention_bwd(*qkv, out, lse, dout, **kw)
            torch.cuda.synchronize()
            for _ in range(3):
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(1 + calls):
                        fa.flash_attention_bwd(*qkv, out, lse, dout, **kw)
                    torch.cuda.synchronize()
                events = sorted((e for e in prof.events()
                                 if e.device_type == torch.autograd.DeviceType.CUDA),
                                key=lambda e: e.time_range.start)
                names = [e.name for e in events]
                assert len(names) <= (1 + calls) * len(order), names
                kinds = [next((k for k in order if k in nm), nm) for nm in names]
                if kinds[-calls * len(order):] == list(order) * calls:
                    break
            assert kinds[-calls * len(order):] == list(order) * calls, names


def test_flash_backward_refuses_what_the_kernel_does_not_take(card):
    q = _randn(card, (1, 64, 4, 64), torch.bfloat16)
    k = _randn(card, (1, 64, 2, 64), torch.bfloat16)
    out, lse = fa._launch(q, k, k, lse=True, causal=True, window=0, q_offset=0)
    kw = dict(causal=True, window=0, q_offset=0)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd(q, k, k, out, lse[:, :2], out, **kw)
    with pytest.raises(ValueError, match="dtypes"):
        fa.flash_attention_bwd(q, k, k, out, lse, out.float(), **kw)
    with pytest.raises(ValueError, match="differ"):
        fa.flash_attention_bwd(q, k, k, out, lse, out[:, :32], **kw)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd(q, k, k, out, lse, out.cpu(), **kw)


SSD_GRAD_F32_RTOL = 1e-4   # float32 kernel vs plain: the same sums in another order
SSD_NAMES = ("x", "dt", "A", "Bm", "Cm", "D", "h0")


def _ssd_grad_reference(inputs, dy, dh_final, dtype, chunk):
    """(the gradients to hold the backward kernel's against, each input's
    tolerance relative to its max|g|), for the inputs given (h0 may be
    None).  float32: ``ssd_ref.ssd_bwd_plain`` on the same inputs, within
    SSD_GRAD_F32_RTOL.  bf16: the float32 plain gradient of the same inputs
    upcast, within the larger of twice the bf16 plain route's own gap to it
    (native autograd of ``ssd_ref.ssd_chunked`` on the bf16 inputs) and one
    bf16 step."""
    up = [None if t is None else t.float() for t in inputs]
    want = [g for g in ssd_ref.ssd_bwd_plain(*up, None if dy is None else dy.float(), dh_final,
                                             chunk=chunk) if g is not None]
    if dtype == torch.float32:
        return want, [SSD_GRAD_F32_RTOL] * len(want)
    leaves = [t.clone().requires_grad_() for t in inputs if t is not None]
    args = leaves + [None] * (7 - len(leaves))
    y, hf = ssd_ref.ssd_chunked(*args[:6], h0=args[6], chunk=chunk)
    pairs = [(o, c) for o, c in ((y, dy), (hf, dh_final)) if c is not None]
    plain = torch.autograd.grad([o for o, _ in pairs], leaves, [c for _, c in pairs],
                                allow_unused=True)
    return want, [max(2 * (0.0 if p is None else _rel_gap(p, w)), BF16_STEP)
                  for p, w in zip(plain, want)]


# SSD_KERNEL_CASES (tests/test_kernels.py's and test_ssd_initial_state's),
# then mamba2-370m's widths over ragged lengths, with and without h0.
SSD_GRAD_CASES = SSD_KERNEL_CASES + [
    (1, 300, 32, 64, 128, 128, True),
    (2, 129, 32, 64, 128, 128, False),
]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", SSD_GRAD_CASES)
def test_ssd_backward_kernel_matches_plain(case, dtype, card):
    """``ssd_scan_bwd`` (the final state's cotangent given) against
    ``_ssd_grad_reference``: every gradient, dh0 where h0 is given; a
    second call gives the same bits (no atomics)."""
    b, s, h, p, n, chunk, with_h0 = case
    inputs = list(_ssd_inputs(card, b, s, h, p, n, dtype, with_h0))
    dy = _randn(card, (b, s, h, p), dtype)
    dh = torch.randn((b, h, p, n), generator=card, device="cuda")
    before = ssd_scan.bwd_launches
    got = ssd_scan.ssd_scan_bwd(*inputs, dy, dh, chunk=chunk)
    again = ssd_scan.ssd_scan_bwd(*inputs, dy, dh, chunk=chunk)
    assert ssd_scan.bwd_launches == before + 2
    assert (got[6] is None) == (not with_h0)
    assert all(g is None or (g.dtype == t.dtype and g.shape == t.shape)
               for g, t in zip(got, inputs))
    assert all(g is None or torch.equal(g, a) for g, a in zip(got, again))
    want, tols = _ssd_grad_reference(inputs, dy, dh, dtype, chunk)
    gaps = [_rel_gap(g, w) for g, w in zip([g for g in got if g is not None], want)]
    assert all(g <= t for g, t in zip(gaps, tols)), (dict(zip(SSD_NAMES, gaps)), tols)


def _strided(t, dim):
    """``t`` as a view into a tensor twice as long on ``dim``: every other
    row there (dim 1, the sequence) or its first half (the last dim)."""
    shape = list(t.shape)
    shape[dim] *= 2
    wide = torch.zeros(shape, dtype=t.dtype, device=t.device)
    view = wide[:, ::2] if dim == 1 else wide[..., :t.shape[-1]]
    view.copy_(t)
    return view


# (b, s, h, p, n, h0, group, dh_final, strided): the heads a bf16 block
# takes as the plan picks them at that shape (``ssd_scan.bwd_group``): one
# each, tail groups (5 heads in groups of 2, 8 in groups of 3) and one
# group of every head; P 16 and 32, N 16 and 72, ragged lengths, the final
# state's cotangent given and absent, and x, dt, B, C and dy as strided
# views.  The float32 route takes one head a block.
SSD_GROUP_CASES = [
    (2, 130, 3, 64, 128, False, 1, True, False),
    (1, 2800, 5, 32, 72, True, 2, False, False),
    (2, 4224, 4, 16, 16, False, 4, True, False),
    (1, 77, 6, 64, 16, True, 1, True, True),
    (2, 4200, 3, 32, 72, False, 3, False, True),
    (1, 2900, 8, 16, 128, True, 3, True, False),
]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", SSD_GROUP_CASES)
def test_ssd_backward_kernel_at_groups_and_widths(case, dtype, card):
    """``ssd_scan_bwd`` at the head groups, widths, lengths and strides of
    ``SSD_GROUP_CASES`` against ``_ssd_grad_reference``; a second call
    gives the same bits."""
    b, s, h, p, n, with_h0, group, with_dh, strided = case
    chunk = 64
    inputs = list(_ssd_inputs(card, b, s, h, p, n, dtype, with_h0))
    dy = _randn(card, (b, s, h, p), dtype)
    dh = torch.randn((b, h, p, n), generator=card, device="cuda") if with_dh else None
    args = list(inputs)
    if strided:
        args[0], args[3], args[4] = (_strided(inputs[i], -1) for i in (0, 3, 4))
        args[1] = _strided(inputs[1], 1)
        dy_in = _strided(dy, 1)
        assert not args[0].is_contiguous() and not args[1].is_contiguous()
    else:
        dy_in = dy
    if dtype == torch.bfloat16:
        plan = ssd_scan.bwd_plan(b, s, h, p, n, dtype)
        assert plan.group == group and plan.groups == -(-h // group)
    got = ssd_scan.ssd_scan_bwd(*args, dy_in, dh, chunk=chunk)
    again = ssd_scan.ssd_scan_bwd(*args, dy_in, dh, chunk=chunk)
    assert all(g is None or torch.equal(g, a) for g, a in zip(got, again))
    assert all(g is None or (g.dtype == t.dtype and g.shape == t.shape)
               for g, t in zip(got, inputs))
    plain = None
    if dtype == torch.float32:
        # Against the plain version computed in float64 (the float32 plain
        # version's own gap to it is printed beside a failure).
        want = [g for g in ssd_ref.ssd_bwd_plain(*inputs, dy, dh, chunk=chunk,
                                                 work=torch.float64) if g is not None]
        tols = [SSD_GRAD_F32_RTOL] * len(want)
        plain = [_rel_gap(g, w) for g, w in zip(
            [g for g in ssd_ref.ssd_bwd_plain(*inputs, dy, dh, chunk=chunk) if g is not None],
            want)]
    else:
        want, tols = _ssd_grad_reference(inputs, dy, dh, dtype, chunk)
    gaps = [_rel_gap(g, w) for g, w in zip([g for g in got if g is not None], want)]
    assert all(g <= t for g, t in zip(gaps, tols)), (dict(zip(SSD_NAMES, gaps)), tols, plain)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("with_h0", [False, True], ids=["no_h0", "h0"])
def test_ssd_gradients_through_the_kernel(with_h0, dtype, card):
    """Autograd through ``ssd_ops.ssd``: one forward launch and one launch
    of the backward kernel (it was the plain version's backward until the
    kernel existed); the gradients held as ``_ssd_grad_reference`` says."""
    b, s, h, p, n, chunk = 2, 200, 4, 32, 16, 64
    x = (torch.randn((b, s, h, p), generator=card, device="cuda") * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=card, device="cuda"))
    A = -torch.exp(torch.randn((h,), generator=card, device="cuda") * 0.3)
    Bm, Cm = (_randn(card, (b, s, n), dtype) for _ in range(2))
    D = torch.randn((h,), generator=card, device="cuda")
    h0 = torch.randn((b, h, p, n), generator=card, device="cuda") if with_h0 else None
    inputs = [t for t in (x, dt, A, Bm, Cm, D, h0) if t is not None]
    leaves = [t.clone().requires_grad_() for t in inputs]
    plain = [t.clone().requires_grad_() for t in inputs]
    cots = [_randn(card, (b, s, h, p), dtype),
            torch.randn((b, h, p, n), generator=card, device="cuda")]

    def call(fn, args):
        args = args + [None] * (7 - len(args))
        return fn(*args[:6], h0=args[6], chunk=chunk)

    before = (ssd_scan.launches, ssd_scan.bwd_launches)
    out = call(ssd_ops.ssd, leaves)
    assert (ssd_scan.launches, ssd_scan.bwd_launches) == (before[0] + 1, before[1])
    want = call(ssd_ref.ssd_chunked, plain)
    _assert_ssd_close([t.detach() for t in out], [t.detach() for t in want], dtype)
    got = torch.autograd.grad(list(out), leaves, cots)
    assert (ssd_scan.launches, ssd_scan.bwd_launches) == (before[0] + 1, before[1] + 1)
    assert len(got) == (7 if with_h0 else 6)
    ref_grads, tols = _ssd_grad_reference(inputs + [None] * (7 - len(inputs)), *cots, dtype,
                                          chunk)
    gaps = [_rel_gap(g, w) for g, w in zip(got, ref_grads)]
    assert all(g <= t for g, t in zip(gaps, tols)), (gaps, tols)


def test_ssd_backward_is_its_documented_device_kernels(card):
    """Each backward call is the device kernels ``bwd_plan`` lays out for
    its dtype (``csrc/ssd_scan_bwd_sm90.cu`` for bf16, ``csrc/ssd_scan_bwd.cu``
    for float32), in the plan's order (chunk states, walk, gradients, last
    sums): the last three of four calls in one profiler session.  The first
    call is not counted: on the card the profiler has lost a session's
    first device events after earlier sessions in the same process (the
    training step's profile counts every launch).  A session that does not
    show the pattern is taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile

    calls = 3
    for dtype in DTYPES:
        order = ssd_scan.bwd_plan(2, 300, 32, 64, 128, dtype).kernels
        assert len(order) == 4
        inputs = _ssd_inputs(card, 2, 300, 32, 64, 128, dtype)
        dy = _randn(card, (2, 300, 32, 64), dtype)
        ssd_scan.ssd_scan_bwd(*inputs, dy, None)
        torch.cuda.synchronize()
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(1 + calls):
                    ssd_scan.ssd_scan_bwd(*inputs, dy, None)
                torch.cuda.synchronize()
            events = sorted((e for e in prof.events()
                             if e.device_type == torch.autograd.DeviceType.CUDA),
                            key=lambda e: e.time_range.start)
            names = [e.name for e in events]
            assert len(names) <= (1 + calls) * len(order), names
            kinds = [next((k for k in order if k in nm), nm) for nm in names]
            if kinds[-calls * len(order):] == list(order) * calls:
                break
        assert kinds[-calls * len(order):] == list(order) * calls, names


@pytest.mark.parametrize("group", [3, 32])
def test_ssd_backward_call_runs_the_plans_kernels_in_order(group, card):
    """One bf16 call at a length where the plan takes a tail group (1 x 768:
    32 heads in groups of 3) and where it takes one group of all 32 heads
    (1 x 8448): the plan's four device kernels, in order and nothing else
    (the second of two calls in a profiler session), and the gradients held
    as ``_ssd_grad_reference`` says."""
    from torch.profiler import ProfilerActivity, profile

    b, s, h, p, n = 1, {3: 768, 32: 8448}[group], 32, 64, 128
    plan = ssd_scan.bwd_plan(b, s, h, p, n, torch.bfloat16)
    assert plan.group == group
    order = plan.kernels
    inputs = _ssd_inputs(card, b, s, h, p, n, torch.bfloat16)
    dy = _randn(card, (b, s, h, p), torch.bfloat16)
    got = ssd_scan.ssd_scan_bwd(*inputs, dy, None)
    torch.cuda.synchronize()
    # Two calls a session, the first uncounted (the profiler can lose a
    # session's first device events after earlier sessions in the process).
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                ssd_scan.ssd_scan_bwd(*inputs, dy, None)
            torch.cuda.synchronize()
        names = [e.name for e in sorted((e for e in prof.events()
                                         if e.device_type == torch.autograd.DeviceType.CUDA),
                                        key=lambda e: e.time_range.start)]
        kinds = [next((k for k in order if k in nm), nm) for nm in names]
        if len(names) <= 2 * len(order) and kinds[-len(order):] == list(order):
            break
    assert len(names) <= 2 * len(order) and kinds[-len(order):] == list(order), names
    want, tols = _ssd_grad_reference(inputs, dy, None, torch.bfloat16, 64)
    gaps = [_rel_gap(g, w) for g, w in zip([g for g in got if g is not None], want)]
    assert all(g <= t for g, t in zip(gaps, tols)), (dict(zip(SSD_NAMES, gaps)), tols)


def test_ssd_backward_refuses_what_the_kernel_does_not_take(card):
    """A bf16 operand that ``_check`` refuses raises; nothing runs the plain
    version instead."""
    b, s, h, p, n = 1, 64, 2, 32, 16
    x, dt, A, Bm, Cm, D, _ = _ssd_inputs(card, b, s, h, p, n, torch.bfloat16)
    dy = _randn(card, (b, s, h, p), torch.bfloat16)
    before = ssd_scan.bwd_launches
    shifted = torch.empty(b * s * h * p + 1, dtype=torch.bfloat16, device="cuda")[1:].view(x.shape)
    shifted.copy_(x)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ssd_scan.ssd_scan_bwd(shifted, dt, A, Bm, Cm, D, None, dy, None)
    with pytest.raises(ValueError, match="dy"):
        ssd_scan.ssd_scan_bwd(x, dt, A, Bm, Cm, D, None, dy.float(), None)
    shifted_dy = torch.empty(dy.numel() + 1, dtype=torch.bfloat16, device="cuda")[1:].view(dy.shape)
    with pytest.raises(ValueError, match="dy .* 16-byte aligned"):
        ssd_scan.ssd_scan_bwd(x, dt, A, Bm, Cm, D, None, shifted_dy, None)
    with pytest.raises(ValueError, match="dh_final"):
        ssd_scan.ssd_scan_bwd(x, dt, A, Bm, Cm, D, None, dy,
                              torch.zeros((b, h, p, n + 1), device="cuda"))
    with pytest.raises(ValueError, match="float32"):
        ssd_scan.ssd_scan_bwd(x, dt.bfloat16(), A, Bm, Cm, D, None, dy, None)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan.ssd_scan_bwd(x.cpu(), dt, A, Bm, Cm, D, None, dy, None)
    assert ssd_scan.bwd_launches == before


def test_decode_kernel_refuses_a_gradient(card):
    q = _randn(card, (2, 8, 64), torch.bfloat16).requires_grad_()
    kc, vc = (_randn(card, (2, 96, 2, 64), torch.bfloat16) for _ in range(2))
    before = da.launches
    with pytest.raises(RuntimeError, match="no backward"):
        ops.decode_attention(q, kc, vc, 50)
    with torch.no_grad():
        ops.decode_attention(q, kc, vc, 50)
    assert da.launches == before + 1
    got = ops.decode_attention(q, kc, vc, 50, impl="ref")  # the plain version differentiates
    assert got.grad_fn is not None


@pytest.mark.parametrize("arch", ["granite-8b", "mamba2-370m", "granite-moe-1b-a400m"])
def test_train_step_on_the_card_matches_the_cpu(arch, card):
    """One step of reduced ``build_train_step`` from the same float32 state on
    the card (through the kernels) and on the CPU (the plain versions): the
    metrics within 1e-4 relative; the parameters within 1% of the learning
    rate wherever the CPU's gradient is above 1e-4 of its leaf's max (below,
    Adam's normalised step can turn a rounding-sized gradient into ±lr)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import build_train_step

    cfg = get_config(arch, reduced=True)
    api = build_model(cfg)
    ocfg = opt.OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    raw = SyntheticTokens(DataConfig(cfg.vocab_size, 64, 2, 0)).batch(0)
    cpu = api.init(0, dtype=torch.float32, device="cpu")
    leaves = [p.detach().requires_grad_() for p in tree_leaves(cpu)]
    it = iter(leaves)
    batch = {k: torch.from_numpy(v).long() for k, v in raw.items()}
    grads = torch.autograd.grad(api.train_loss(tree_map(lambda _: next(it), cpu), batch)[0],
                                leaves)
    gpu = tree_map(lambda p: p.to("cuda"), cpu)
    step = build_train_step(api, ocfg)
    cpu, _, m_cpu = step(cpu, opt.init_opt_state(cpu), batch)
    launches = (fa.launches, ssd_scan.launches)
    gpu, _, m_gpu = step(gpu, opt.init_opt_state(gpu), {k: v.cuda() for k, v in batch.items()})
    kernel = 1 if cfg.arch_type == "ssm" else 0
    assert (fa.launches, ssd_scan.launches)[kernel] == launches[kernel] + 2 * cfg.num_layers
    for k in ("loss", "ce", "aux", "grad_norm", "lr"):
        torch.testing.assert_close(m_gpu[k].cpu(), m_cpu[k], rtol=1e-4, atol=1e-6)
    for g, a, b in zip(grads, tree_leaves(cpu), tree_leaves(gpu)):
        held = g.abs() > 1e-4 * g.abs().max()
        torch.testing.assert_close(b.cpu()[held], a[held], atol=1e-2 * ocfg.lr, rtol=0)
