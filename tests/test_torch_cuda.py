"""The Hopper kernels against their plain versions, on the card.

Marked ``cuda``: they skip on hosts without a CUDA device of capability 9.0
and run on an H100 with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config
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
    qd = _randn(card, (2, 32, 128), torch.bfloat16)
    cache = _randn(card, (2, 64, 2, 128), torch.bfloat16)
    with pytest.raises(ValueError, match="group"):
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
    """One device kernel per bf16 call: no scratch pass, no state walk."""
    from torch.profiler import ProfilerActivity, profile

    x, dt, A, Bm, Cm, D, _ = _ssd_inputs(card, 1, 512, 32, 64, 128, torch.bfloat16)
    assert ssd_scan.plan(1, 512, 32, 64, 128, torch.bfloat16).scratch == ()
    ssd_scan.ssd(x, dt, A, Bm, Cm, D, chunk=128)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            ssd_scan.ssd(x, dt, A, Bm, Cm, D, chunk=128)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
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
