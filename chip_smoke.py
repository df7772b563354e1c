#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one H100 and check it end to end.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. Device: a CUDA device of compute capability 9.0; prints its name and
   ``nvidia-smi``'s name and power limit.  TF32 is switched off so the
   plain float32 versions compute in full float32.
2. Build: compiles the kernels from ``src/repro_torch/kernels`` (``nvcc``,
   sm_90a, one process per source) and prints the build time, ptxas'
   registers, shared memory and spills per kernel, and the number of
   tensor-core instructions in the library's SASS (``cuobjdump``): each
   bf16 flash kernel must have ``HGMMA`` (``wgmma``), and each bf16 SSD
   kernel both ``HGMMA`` (C·Bᵀ) and ``HMMA`` (``mma.sync``, the other
   products).
3. Kernel vs plain: each kernel against its plain PyTorch version on the
   card, at the shape cases of ``tests/test_kernels.py`` (attention: float32
   atol 1e-4, bfloat16 atol 2e-2; SSD: float32 atol 1e-4, bfloat16 atol
   5e-2, with the ``h0`` case) and at the serving slices' shapes; one JSON
   line per kernel and shape with the error, the kernel's, the plain
   version's and (attention) ``scaled_dot_product_attention``'s times, and
   the bound; flash and SSD rows also give the route (bf16 on the tensor
   cores, float32 on the FMA pipes), the TFLOP/s reached and the share of
   the bound.  The SSD scan has no single PyTorch call to time beside it.
4. Full-width models, kernels vs plain versions, one 512-token prefill and 8
   decode steps each, compared step by step, at published widths with
   seeded random weights: granite-8b in bfloat16, and mamba2-370m in
   float32 (held) and in bfloat16 (printed beside the spread that a mere
   change of the plain scan's chunk gives; see ``phase_model``).
5. The slices, each driven for 8 ticks of Poisson traffic under the paper's
   allocator with every kernel's launch counter zeroed just before and read
   just after: ``build_engine`` over the dense Table I fleet at full width,
   then the reference's two-agent engine fleet (``tests/test_serving.py``:
   minitron-4b and mamba2-370m) at full width.
6. Profile: full-width granite-8b decode steps (4 rows, a 300-entry
   cache) on the host clock and in ``torch.profiler``: the device's busy
   share of a step; then checks that a decode call with an int length is
   one device kernel, and that a bf16 SSD call is one device kernel that
   allocates only its outputs, with the SSD device time of a full-width
   mamba2-370m prefill of 512 tokens.

The line before the last is ``{"kernels": [...]}`` (one entry per kernel);
the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the repository's ``src/`` beside it, the script exits non-zero
before printing either.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"

# (name, bytes/s, {dtype: flop/s}) per SKU, dense rates, from NVIDIA's data
# sheets; the first entry whose key is in the nvidia-smi name applies.
PEAKS = (
    ("H200", 4.8e12, {torch.bfloat16: 989e12, torch.float32: 67e12}),
    ("H100 PCIe", 2.0e12, {torch.bfloat16: 756e12, torch.float32: 51e12}),
    ("H100 NVL", 3.9e12, {torch.bfloat16: 835e12, torch.float32: 60e12}),
    ("H100", 3.35e12, {torch.bfloat16: 989e12, torch.float32: 67e12}),  # SXM
)
ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# The SSD scan's tolerances, tests/test_kernels.py:111.  At mamba2-370m's
# widths |y| reaches ~100, where one bfloat16 step is 0.5: the kernel and
# the plain version each round a float32 y once and may land one step apart
# (the plain version at chunk 64 vs 128 already does), so there y is also
# allowed one step of its magnitude (2^-7 relative).
SSD_ATOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
SSD_WIDE_RTOL = 2.0 ** -7

# The shape cases of tests/test_kernels.py.
FLASH_CASES = [
    # (b, s_q, s_kv, h, kv, d, causal, window)
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 200, 200, 8, 8, 128, True, 0),
    (2, 64, 256, 4, 1, 32, False, 0),
    (1, 256, 256, 4, 2, 64, True, 64),
    (2, 96, 96, 6, 3, 64, True, 0),
    (1, 128, 512, 4, 4, 128, True, 0),
]
DECODE_CASES = [
    # (b, h, kv, d, s_max, cache_len, window)
    (2, 8, 2, 64, 300, 150, 0),
    (1, 4, 4, 128, 512, 512, 0),
    (3, 16, 2, 64, 256, 256, 128),
    (2, 4, 1, 32, 1024, 700, 0),
    (1, 8, 8, 64, 96, 1, 0),
]
# The slice's shapes: granite-8b (32 q / 8 kv heads) and qwen2-vl-2b (12 / 2).
HEADS = {"granite-8b": (32, 8), "qwen2-vl-2b": (12, 2)}
SLICE_FLASH = [(1, s, s, h, kv, 128, True, 0) for h, kv in HEADS.values() for s in (128, 512, 2048)]
SLICE_DECODE = [(4, h, kv, 128, 1024, n, 0) for h, kv in HEADS.values() for n in (1, 300, 1024)]
SSD_CASES = [
    # (b, s, h, p, n, chunk, h0): tests/test_kernels.py's cases, then
    # test_ssd_initial_state's
    (2, 128, 4, 32, 16, 32, False),
    (1, 96, 2, 64, 32, 32, False),
    (2, 64, 8, 16, 8, 16, False),
    (1, 100, 2, 32, 16, 32, False),
    (1, 64, 2, 16, 8, 16, True),
]
# mamba2-370m's prefill: 32 heads of P 64, N 128, chunk 128.
SLICE_SSD = [(1, s, 32, 64, 128, 128, False) for s in (128, 512, 2048, 8192)]
# minitron-4b's heads (24 q / 8 kv), the GQA ratio the two-agent fleet adds.
SLICE_FLASH += [(1, 512, 512, 24, 8, 128, True, 0)]
SLICE_DECODE += [(4, 24, 8, 128, 1024, 300, 0)]
# The shape each kernel's summary entry reports: granite-8b at the engine's
# prompt and cache sizes; mamba2-370m's 512-token prefill.
SUMMARY_FLASH = (1, 512, 512, 32, 8, 128, True, 0)
SUMMARY_DECODE = (4, 32, 8, 128, 1024, 300, 0)
SUMMARY_SSD = (1, 512, 32, 64, 128, 128, False)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def emit(obj) -> None:
    print(json.dumps(obj, default=lambda x: None), flush=True)


def _finite(x):
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


# ---------------------------------------------------------------------------
# Timing and bounds
# ---------------------------------------------------------------------------

_flush_buf = None


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, CUDA events around each call.

    Before each call the 50 MB L2 cache is flushed (the engine's callers
    find the layer's weights and caches cold) and the card is held busy
    for about half a millisecond, so that the host has queued the call's
    kernels before the start event fires: the events then time the
    device's work, not the host's launch overhead.
    """
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(32 * 2**20, dtype=torch.float32, device=DEVICE)  # 128 MB
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        _flush_buf.zero_()
        torch.cuda._sleep(1_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def peaks(gpu_name: str):
    for key, bw, flops in PEAKS:
        if key in gpu_name:
            return key, bw, flops
    raise RuntimeError(f"chip_smoke: no peak rates for {gpu_name!r}")


def bound(gpu_name: str, bytes_moved: int, flops: int, dtype) -> tuple[float, str]:
    """Least time in ms: the larger of bytes over the memory rate and
    operations over the peak rate for the inputs' type."""
    _, bw, rates = peaks(gpu_name)
    t_bytes, t_ops = bytes_moved / bw * 1e3, flops / rates[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 1 and 2
# ---------------------------------------------------------------------------

def phase_device() -> str:
    check(torch.cuda.is_available(), "no CUDA device")
    cap = torch.cuda.get_device_capability(0)
    check(cap == (9, 0), f"compute capability {cap}, the kernels are built for sm_90a")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {name}", flush=True)
    print(smi, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32 off for matmul and cudnn: plain float32 versions compute in full float32")
    return smi


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    took = time.perf_counter() - t0
    print(f"build: {took:.2f} s ({'compiled' if _build.build_seconds else 'cached'}, "
          f"{len(_build.SOURCES)} sources)", flush=True)
    for line in _build.build_log.splitlines():
        if "Compiling entry function" in line or "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")
    if not cuobjdump.is_file():
        print(f"sass: {cuobjdump} is missing; HGMMA not counted", flush=True)
        return
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build.build())], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, kernel = {}, None  # kernel -> {opcode: instructions}
    for line in sass.splitlines():
        if "Function :" in line:
            kernel = line.split("Function :")[1].strip()
        elif kernel:
            for op in ("HGMMA", "HMMA"):
                if op in line:
                    counts.setdefault(kernel, {}).setdefault(op, 0)
                    counts[kernel][op] += 1
    flash = {k: c.get("HGMMA", 0) for k, c in counts.items() if "flash_sm90_kernel" in k}
    ssd = {k: c for k, c in counts.items() if "ssd_sm90_kernel" in k}
    print(f"sass: {sum(c.get('HGMMA', 0) for c in counts.values())} HGMMA instructions, "
          f"{sum(flash.values())} in {len(flash)} bf16 flash kernels; bf16 SSD kernels "
          f"(HGMMA, HMMA): {sorted((c.get('HGMMA', 0), c.get('HMMA', 0)) for c in ssd.values())}",
          flush=True)
    check(len(flash) == 6 and all(flash.values()),
          "the bf16 flash kernels do not run on the tensor cores (no HGMMA in their SASS)")
    check(len(ssd) == 4 and all(c.get("HGMMA", 0) and c.get("HMMA", 0) for c in ssd.values()),
          f"the bf16 SSD kernels do not run on the tensor cores: {ssd}")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)


def _sdpa(q, k, v, mask=None, is_causal=False):
    """``scaled_dot_product_attention`` over (B, heads, S, D) views, as the
    timed yardstick; GQA through ``enable_gqa`` where torch has it."""
    try:
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, is_causal=is_causal,
                                              enable_gqa=True)
    except TypeError:
        g = q.shape[1] // k.shape[1]
        return F.scaled_dot_product_attention(
            q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1), attn_mask=mask,
            is_causal=is_causal)


def check_flash(case, dtype, gpu, seed=0) -> dict:
    from repro_torch.kernels.attention import flash_attention as fa, ref

    b, s_q, s_kv, h, kv, d, causal, window = case
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    q, k, v = (_randn(gen, (b, s, n, d), dtype) for s, n in ((s_q, h), (s_kv, kv), (s_kv, kv)))
    off = s_kv - s_q if causal else 0
    got = fa.flash_attention(q, k, v, causal=causal, window=window, q_offset=off)
    want = ref.mha(q, k, v, causal=causal, window=window, q_offset=off)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    mask = ref.attention_mask(s_q, s_kv, causal=causal, window=window, q_offset=off, device=DEVICE)
    pairs = int(mask.sum())
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    # The plain causal mask goes to SDPA as is_causal (its fast kernels);
    # other masks as a boolean mask.
    plain_causal = causal and window == 0 and s_q == s_kv
    if plain_causal:
        lib_args = {"is_causal": True}
    else:
        lib_args = {"mask": None if pairs == s_q * s_kv else mask}
    lib = _sdpa(qt, kt, vt, **lib_args)
    lib_err = float((lib.transpose(1, 2).float() - want.float()).abs().max())
    flops = 4 * b * h * d * pairs
    bms, by = bound(gpu, (2 * b * s_q * h + 2 * b * s_kv * kv) * d * q.element_size(),
                    flops, dtype)
    ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=causal, window=window, q_offset=off))
    return {
        "kernel": "flash_attention", "case": list(case), "dtype": str(dtype).split(".")[-1],
        "route": fa.route(dtype), "max_abs_err": err, "atol": ATOL[dtype],
        "sdpa_max_abs_err": lib_err, "ms": ms,
        "plain_ms": time_ms(lambda: ref.mha(q, k, v, causal=causal, window=window, q_offset=off)),
        "library_ms": time_ms(lambda: _sdpa(qt, kt, vt, **lib_args)),
        "bound_ms": bms, "bound_by": by, "tflops": flops / ms * 1e-9, "bound_share": bms / ms,
    }


def check_decode(case, dtype, gpu, seed=0) -> dict:
    from repro_torch.kernels.attention import decode_attention as da, ref

    b, h, kv, d, s_max, clen, window = case
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    q = _randn(gen, (b, h, d), dtype)
    kc, vc = (_randn(gen, (b, s_max, kv, d), dtype) for _ in range(2))
    got = da.decode_attention(q, kc, vc, clen, window=window)
    want = ref.decode_gqa(q, kc, vc, clen, window=window)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    pos = torch.arange(s_max, device=DEVICE)
    valid = pos < clen
    if window > 0:
        valid &= pos >= clen - window
    n_valid = int(valid.sum())
    mask = valid[None, None, None, :].expand(b, 1, 1, s_max)
    qt, kt, vt = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
    elem = q.element_size()
    bms, by = bound(gpu, (2 * b * n_valid * kv * d + 2 * b * h * d) * elem + 4 * b,
                    4 * b * h * d * n_valid, dtype)
    return {
        "kernel": "decode_attention", "case": list(case), "dtype": str(dtype).split(".")[-1],
        "max_abs_err": err, "atol": ATOL[dtype],
        "ms": time_ms(lambda: da.decode_attention(q, kc, vc, clen, window=window)),
        "plain_ms": time_ms(lambda: ref.decode_gqa(q, kc, vc, clen, window=window)),
        "library_ms": time_ms(lambda: _sdpa(qt, kt, vt, mask)),
        "bound_ms": bms, "bound_by": by,
    }


def _ssd_inputs(case, dtype, seed=0):
    """SSD inputs built as tests/test_kernels.py builds them."""
    b, s, h, p, n, _, with_h0 = case
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x = (torch.randn((b, s, h, p), generator=gen, device=DEVICE) * 0.5).to(dtype)
    dt = F.softplus(torch.randn((b, s, h), generator=gen, device=DEVICE))
    A = -torch.exp(torch.randn((h,), generator=gen, device=DEVICE) * 0.3)
    Bm, Cm = (_randn(gen, (b, s, n), dtype) for _ in range(2))
    D = torch.ones((h,), device=DEVICE)
    h0 = torch.randn((b, h, p, n), generator=gen, device=DEVICE) if with_h0 else None
    return x, dt, A, Bm, Cm, D, h0


def check_ssd(case, dtype, gpu, seed=0) -> dict:
    """The kernel against ``ref.ssd_chunked`` at the caller's chunk; y and
    the final state."""
    from repro_torch.kernels.ssd import ref, ssd_scan

    b, s, h, p, n, chunk, with_h0 = case
    x, dt, A, Bm, Cm, D, h0 = _ssd_inputs(case, dtype, seed)
    (gy, gh) = ssd_scan.ssd(x, dt, A, Bm, Cm, D, h0=h0, chunk=chunk)
    (wy, wh) = ref.ssd_chunked(x, dt, A, Bm, Cm, D, h0=h0, chunk=chunk)
    torch.cuda.synchronize()
    rtol = SSD_WIDE_RTOL if case in SLICE_SSD else 0.0
    dy = (gy.float() - wy.float()).abs()
    excess = float((dy - rtol * wy.float().abs()).max())  # <= atol passes
    elem = x.element_size()
    bytes_moved = (2 * x.numel() * elem + dt.numel() * 4 + 2 * Bm.numel() * elem
                   + (h0.numel() * 4 if with_h0 else 0) + gh.numel() * 4)
    chunks = -(-s // chunk)
    # C·Bᵀ once per (batch row, chunk): B and C are one group that all heads
    # share; the gated products and the state's per head.
    flops = (2 * chunk * chunk * n * b * chunks
             + 2 * chunk * (chunk * p + 2 * n * p) * b * h * chunks)
    bms, by = bound(gpu, bytes_moved, flops, dtype)
    pl = ssd_scan.plan(b, s, h, p, n, dtype)
    ms = time_ms(lambda: ssd_scan.ssd(x, dt, A, Bm, Cm, D, h0=h0, chunk=chunk))
    return {
        "kernel": "ssd", "case": list(case), "dtype": str(dtype).split(".")[-1],
        "route": pl.route, "max_abs_err": float(dy.max()),
        "h_max_abs_err": float((gh - wh).abs().max()),
        "atol": SSD_ATOL[dtype], "rtol": rtol, "excess_over_rtol": excess, "ms": ms,
        "plain_ms": time_ms(lambda: ref.ssd_chunked(x, dt, A, Bm, Cm, D, h0=h0, chunk=chunk)),
        "library_ms": None, "library": "none (no single PyTorch call computes the SSD scan)",
        "bound_ms": bms, "bound_by": by, "tflops": flops / ms * 1e-9, "bound_share": bms / ms,
        "grid": list(pl.grid), "device_kernels": pl.kernels,
    }


def check_ssd_launches(case=SUMMARY_SSD, calls: int = 3) -> dict:
    """A bf16 SSD call is one device kernel and allocates nothing but y and
    the final state; then the SSD device time of one full-width
    mamba2-370m prefill of ``case``'s length (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd import ssd_scan
    from repro_torch.models.model import build_model

    s, chunk = case[1], case[5]
    x, dt, A, Bm, Cm, D, _ = _ssd_inputs(case, torch.bfloat16)
    ssd_scan.ssd(x, dt, A, Bm, Cm, D, chunk=chunk)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = ssd_scan.ssd(x, dt, A, Bm, Cm, D, chunk=chunk)
    torch.cuda.synchronize()
    allocated = torch.cuda.max_memory_allocated() - base
    outputs = sum(-(-t.numel() * t.element_size() // 512) * 512 for t in out)  # allocator blocks
    del out
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            ssd_scan.ssd(x, dt, A, Bm, Cm, D, chunk=chunk)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    check(len(names) == calls and all("ssd_sm90_kernel" in nm for nm in names),
          f"ssd: {len(names)} device kernels for {calls} bf16 calls: {sorted(set(names))}")
    check(allocated <= outputs,
          f"ssd: a bf16 call allocated {allocated} bytes, its outputs take {outputs}")

    cfg = get_config("mamba2-370m")
    api = build_model(cfg)
    params = api.init(0, dtype=torch.bfloat16, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (1, s), generator=gen, device=DEVICE)
    with torch.no_grad():
        api.prefill(params, {"tokens": tokens}, 1024)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            api.prefill(params, {"tokens": tokens}, 1024)
            torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    scans = [e for e in kernels if "ssd_sm90_kernel" in e.name]
    row = {"phase": "ssd_launches", "case": list(case), "calls": calls,
           "device_kernels": len(names), "names": sorted(set(names)),
           "allocated_bytes": allocated, "output_bytes": outputs,
           "prefill_tokens": s, "prefill_ssd_kernels": len(scans),
           "prefill_ssd_device_ms": sum(e.time_range.elapsed_us() for e in scans) / 1e3,
           "prefill_device_ms": sum(e.time_range.elapsed_us() for e in kernels) / 1e3}
    emit(row)
    check(len(scans) == cfg.num_layers,
          f"ssd: {len(scans)} SSD kernels in a {cfg.num_layers}-layer mamba prefill")
    del params
    torch.cuda.empty_cache()
    return row


def check_decode_launches(case=SUMMARY_DECODE, calls: int = 3) -> None:
    """A decode call with an int length is one device kernel: no fill of
    the lengths, no combine pass (``torch.profiler``'s device events)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.attention import decode_attention as da

    b, h, kv, d, s_max, clen, window = case
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    q = _randn(gen, (b, h, d), torch.bfloat16)
    kc, vc = (_randn(gen, (b, s_max, kv, d), torch.bfloat16) for _ in range(2))
    da.decode_attention(q, kc, vc, clen, window=window)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            da.decode_attention(q, kc, vc, clen, window=window)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    emit({"phase": "decode_launches", "case": list(case), "calls": calls,
          "device_kernels": len(names), "names": sorted(set(names))})
    check(len(names) == calls and all("repro::" in n and "decode_" in n for n in names),
          f"decode: {len(names)} device kernels for {calls} calls: {sorted(set(names))}")


def phase_kernels(gpu: str) -> dict:
    summary = {}
    runs = ([(check_flash, c, dt) for c in FLASH_CASES for dt in ATOL]
            + [(check_decode, c, dt) for c in DECODE_CASES for dt in ATOL]
            + [(check_ssd, c, dt) for c in SSD_CASES for dt in SSD_ATOL]
            + [(check_flash, c, torch.bfloat16) for c in SLICE_FLASH]
            + [(check_decode, c, torch.bfloat16) for c in SLICE_DECODE]
            + [(check_ssd, c, torch.bfloat16) for c in SLICE_SSD])
    for fn, case, dtype in runs:
        row = fn(case, dtype, gpu)
        emit({"phase": "kernel", **row})
        err = row.get("excess_over_rtol", row["max_abs_err"])
        check(err <= row["atol"] and row.get("h_max_abs_err", 0.0) <= row["atol"],
              f"{row['kernel']} {case} {row['dtype']}: max abs err {row['max_abs_err']}")
        if (dtype == torch.bfloat16
                and tuple(case) in (SUMMARY_FLASH, SUMMARY_DECODE, SUMMARY_SSD)):
            summary[row["kernel"]] = row
    return summary


# ---------------------------------------------------------------------------
# Phase 4: full-width models through the kernels and the plain versions
# ---------------------------------------------------------------------------

def _compare(cfg, params, tokens, path, ref_path, held: bool, label: str,
             steps: int = 8, max_len: int = 1024) -> None:
    """Prefill ``tokens`` and decode ``steps`` tokens through two paths, each
    an (api, impl) pair, comparing the logits at every step.  Held: within
    5e-2 of max|logits| at every step and the same greedy token at all but
    two steps; otherwise the numbers are printed and only finiteness holds."""
    (api_a, impl_a), (api_b, impl_b) = path, ref_path
    prompt_len = tokens.shape[1]
    la, ca = api_a.prefill(params, {"tokens": tokens}, max_len, impl=impl_a)
    lb, cb = api_b.prefill(params, {"tokens": tokens}, max_len, impl=impl_b)
    rows = []
    for step in range(steps + 1):
        diff = float((la.float() - lb.float()).abs().max())
        scale = float(lb.float().abs().max())
        ta, tb = int(la[0].argmax()), int(lb[0].argmax())
        finite = bool(torch.isfinite(la).all() and torch.isfinite(lb).all())
        rows.append({"step": step, "max_abs_diff": diff, "max_abs_logit": scale,
                     "rel": diff / scale, "token_a": ta, "token_b": tb, "finite": finite})
        emit({"phase": "model", "arch": cfg.name, "compare": label, "held": held,
              "dtype": str(params["final_norm"]["scale"].dtype), **rows[-1]})
        check(finite, f"{cfg.name} {label}: non-finite logits at step {step}")
        if held:
            check(diff <= 5e-2 * scale,
                  f"{cfg.name} {label} step {step}: max|dlogits| {diff} > 5e-2 * {scale}")
        if step == steps:
            break
        tok = torch.tensor([ta], device=DEVICE)  # both paths decode the first path's token
        la, ca = api_a.decode_step(params, ca, tok, prompt_len + step, max_len, impl=impl_a)
        lb, cb = api_b.decode_step(params, cb, tok, prompt_len + step, max_len, impl=impl_b)
    agree = sum(r["token_a"] == r["token_b"] for r in rows)
    emit({"phase": "model", "arch": cfg.name, "compare": label, "held": held,
          "greedy_agreement": agree, "steps": len(rows),
          "max_rel": max(r["rel"] for r in rows)})
    if held:
        check(agree >= len(rows) - 2,
              f"{cfg.name} {label}: greedy tokens agree on {agree} of {len(rows)} steps")


def phase_model(arch: str, dtype=torch.bfloat16, held: bool = True, reduced: bool = False,
                prompt_len: int = 512) -> None:
    """Full-width ``arch`` through the kernels and through the plain versions.

    Not held (mamba2-370m in bfloat16): with seeded random weights the 48
    ssm layers amplify one-step bfloat16 differences, so that a mere change
    of the plain scan's chunk (128 to 64, another order of sums) moves the
    logits by ~0.1 of their maximum, in the JAX package as in the port.  The
    run then prints that yardstick beside the kernel's numbers, and the
    kernel is held in float32 instead.
    """
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd import ssd_scan
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import layer_kinds

    cfg = get_config(arch, reduced=reduced)
    api = build_model(cfg)
    params = api.init(0, dtype=dtype, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, prompt_len), generator=gen, device=DEVICE)
    with torch.no_grad():
        before = ssd_scan.launches
        _compare(cfg, params, tokens, (api, None), (api, "ref"), held, "kernels_vs_plain")
        check(ssd_scan.launches - before == layer_kinds(cfg).count("ssm"),
              f"{arch}: {ssd_scan.launches - before} SSD launches in one prefill")
        if not held:
            half = build_model(dataclasses.replace(cfg, ssm_chunk_size=cfg.ssm_chunk_size // 2))
            _compare(cfg, params, tokens, (half, "ref"), (api, "ref"), False,
                     f"plain_chunk_{cfg.ssm_chunk_size // 2}_vs_{cfg.ssm_chunk_size}")
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 5: the slices end to end
# ---------------------------------------------------------------------------

def _launch_counters():
    from repro_torch.kernels.attention import decode_attention as da, flash_attention as fa
    from repro_torch.kernels.ssd import ssd_scan

    return {"flash_attention": fa, "decode_attention": da, "ssd": ssd_scan}


def drive(eng, rates: dict, label: str, ticks: int = 8, prompt=(64, 513)) -> dict:
    """Drive ``eng`` for ``ticks`` ticks of Poisson arrivals at ``rates`` per
    agent, prompts of ``prompt`` tokens and 32 new tokens each; check what
    comes out and return the kernels' launches and the prefill counts."""
    print(f"{label}: {torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated", flush=True)
    finite = [torch.ones((), dtype=torch.bool, device=DEVICE)]
    # calls and seconds (host clock, synced) per agent and kind
    spent = {rt.name: {"prefill": [0, 0.0], "decode": [0, 0.0]} for rt in eng.runtimes}

    def checked(fn, name, kind):
        def call(*args, **kwargs):
            t = time.perf_counter()
            logits, caches = fn(*args, **kwargs)
            finite[0] &= torch.isfinite(logits).all()
            torch.cuda.synchronize()
            spent[name][kind][0] += 1
            spent[name][kind][1] += time.perf_counter() - t
            return logits, caches
        return call

    for rt in eng.runtimes:
        rt.api = dataclasses.replace(rt.api, prefill=checked(rt.api.prefill, rt.name, "prefill"),
                                     decode_step=checked(rt.api.decode_step, rt.name, "decode"))
    vocab = min(rt.api.cfg.vocab_size for rt in eng.runtimes)
    rng = np.random.default_rng(0)
    tick_s = []
    counters = _launch_counters()
    for mod in counters.values():
        mod.launches = 0
    for tick in range(ticks):
        for name in eng.fleet.names:
            for _ in range(rng.poisson(rates[name])):
                eng.submit(name, rng.integers(0, vocab, int(rng.integers(*prompt))), 32)
        before = {n: {k: list(v) for k, v in kinds.items()} for n, kinds in spent.items()}
        t = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        tick_s.append(time.perf_counter() - t)
        per_agent = {n: {f"{k}_calls": kinds[k][0] - before[n][k][0] for k in kinds}
                     | {f"{k}_s": kinds[k][1] - before[n][k][1] for k in kinds}
                     for n, kinds in spent.items()}
        total = {k: sum(a[k] for a in per_agent.values())
                 for k in ("prefill_calls", "prefill_s", "decode_calls", "decode_s")}
        emit({"phase": "engine_tick", "fleet": label, "tick": tick, "wall_s": tick_s[-1],
              "prefill_calls": total["prefill_calls"], "prefill_s": total["prefill_s"],
              "decode_steps": total["decode_calls"], "decode_s": total["decode_s"],
              "other_s": tick_s[-1] - total["prefill_s"] - total["decode_s"],
              "tokens": eng.history[-1]["decode_tokens"], "per_agent": per_agent})
    launches = {name: mod.launches for name, mod in counters.items()}
    m = eng.metrics()
    emit({"phase": "engine", "fleet": label, "metrics": _finite(m), "launches": launches,
          "tick_wall_s": tick_s, "allocation": [h["allocation"] for h in eng.history],
          "prefills": {n: kinds["prefill"][0] for n, kinds in spent.items()}})
    check(m["completed"] > 0, f"{label}: no request completed")
    check(bool(finite[0]), f"{label}: non-finite logits in the engine")
    for h in eng.history:
        check(sum(h["allocation"]) <= 1.0 + 1e-6, f"{label} tick {h['tick']}: Σ allocation > 1")
    return {"launches": launches, "prefills": {n: k["prefill"][0] for n, k in spent.items()},
            "completed": {n: sum(r.agent == n for r in eng.completed) for n in eng.fleet.names}}


def phase_engine(reduced: bool = False, max_len: int = 1024, budget_tokens: int = 2048) -> dict:
    """The dense Table I fleet (``build_engine``) at full width."""
    from repro_torch.launch.serve import DEFAULT_FLEET, DENSE_FLEET, build_engine

    t0 = time.perf_counter()
    eng = build_engine("adaptive", reduced=reduced, fleet=DENSE_FLEET,
                       budget_tokens=budget_tokens, max_len=max_len, batch_slots=4,
                       device=DEVICE)
    print(f"engine built in {time.perf_counter() - t0:.1f} s", flush=True)
    out = drive(eng, {name: rate for name, *_, rate in DEFAULT_FLEET}, "dense")
    for name in ("flash_attention", "decode_attention"):
        check(out["launches"][name] > 0, f"{name} was never launched on the dense fleet")
    return out["launches"]


def phase_two_agent_engine(reduced: bool = False, max_len: int = 1024,
                           budget_tokens: int = 2048) -> dict:
    """tests/test_serving.py's engine fleet (``_fleet_2``, ``_engine``) at full
    width: ``fast`` on minitron-4b, ``slow`` on mamba2-370m."""
    from repro_torch.configs import get_config
    from repro_torch.core.agents import AgentSpec, Fleet
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import AgentRuntime, FleetEngine

    t0 = time.perf_counter()
    fleet = Fleet.from_specs([
        AgentSpec("fast", 100.0, 100.0, 0.2, 1),
        AgentSpec("slow", 500.0, 20.0, 0.3, 2),
    ])
    rts, archs = {}, {"fast": "minitron-4b", "slow": "mamba2-370m"}
    for name, arch in archs.items():
        api = build_model(get_config(arch, reduced=reduced))
        params = api.init(0, dtype=torch.bfloat16, device=DEVICE)
        rts[name] = AgentRuntime(name, api, params, max_len=max_len, batch_slots=4)
    eng = FleetEngine(fleet, rts, policy="adaptive", budget_tokens=budget_tokens, device=DEVICE)
    print(f"two-agent engine built in {time.perf_counter() - t0:.1f} s", flush=True)
    out = drive(eng, {"fast": 2, "slow": 2}, "two_agent")
    for name, done in out["completed"].items():
        check(done > 0, f"agent {name!r} ({archs[name]}) completed no request")
    for name, n in out["launches"].items():
        check(n > 0, f"{name} was never launched on the two-agent fleet")
    n_ssm = rts["slow"].api.cfg.num_layers
    check(out["launches"]["ssd"] == n_ssm * out["prefills"]["slow"],
          f"{out['launches']['ssd']} SSD launches for {out['prefills']['slow']} mamba prefills")
    return out["launches"]


# ---------------------------------------------------------------------------
# Phase 6: where a decode step's time goes
# ---------------------------------------------------------------------------

def phase_profile(arch: str = "granite-8b", batch: int = 4, prompt_len: int = 300,
                  steps: int = 20, profiled: int = 5) -> None:
    """Full-width ``arch``: the host-clock time of a decode step at ``batch``
    rows and a ``prompt_len`` cache, against the device time of the same
    steps in ``torch.profiler`` (summed over every kernel), so the device's
    busy share of a step is device time over host time.  Run last: once
    started, the profiler's device tracing stays attached to the process."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    cfg = get_config(arch)
    api = build_model(cfg)
    params = api.init(0, dtype=torch.bfloat16, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen, device=DEVICE)

    def run(n, caches, tok, pos):
        times = []
        for step in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, caches = api.decode_step(params, caches, tok, pos + step, 1024)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            tok = logits.argmax(-1).reshape(-1)
        return times, caches, tok

    with torch.no_grad():
        logits, caches = api.prefill(params, {"tokens": tokens}, 1024)
        tok = logits.argmax(-1).reshape(-1)
        host, caches, tok = run(steps, caches, tok, prompt_len)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, caches, tok = run(profiled, caches, tok, prompt_len + steps)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / profiled / 1e3
    decode_ms = sum(e.time_range.elapsed_us() for e in kernels
                    if "repro::" in e.name and "decode_" in e.name) / profiled / 1e3
    host_ms = statistics.median(host) * 1e3
    emit({"phase": "profile", "arch": arch, "batch": batch, "cache_len": prompt_len,
          "host_step_ms": host_ms, "host_step_ms_min": min(host) * 1e3,
          "device_ms_per_step": device_ms, "busy_share": device_ms / host_ms,
          "decode_attention_device_ms_per_step": decode_ms,
          "device_kernels_per_step": len(kernels) / profiled})
    check(device_ms > 0, "the profiler saw no device time in a decode step")
    del params
    torch.cuda.empty_cache()


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repository)

    t0 = time.perf_counter()
    smi = phase_device()
    gpu = smi.split(",")[0]
    phase_build()
    summary = phase_kernels(gpu)
    phase_model("granite-8b")
    phase_model("mamba2-370m", torch.float32)
    phase_model("mamba2-370m", torch.bfloat16, held=False)
    dense = phase_engine()
    gc.collect()
    torch.cuda.empty_cache()
    two_agent = phase_two_agent_engine()
    gc.collect()
    torch.cuda.empty_cache()
    # Last: the profiler's device tracing, once started, stays attached to
    # the process and would slow every later launch on the host.
    phase_profile()
    check_decode_launches()
    check_ssd_launches()
    sources = {
        # the bf16 route, which the summary shape and the fleets run
        "flash_attention": ("src/repro_torch/kernels/attention/csrc/flash_attention_sm90.cu",
                            "src/repro/kernels/attention/flash_attention.py:90"),
        "decode_attention": ("src/repro_torch/kernels/attention/csrc/decode_attention.cu",
                             "src/repro/kernels/attention/decode_attention.py:70"),
        "ssd": ("src/repro_torch/kernels/ssd/csrc/ssd_scan_sm90.cu",
                "src/repro/kernels/ssd/ssd_scan.py:82"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        row = summary[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": two_agent[name],
            "launches_by_fleet": {"dense": dense[name], "two_agent": two_agent[name]},
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": row["case"], "dtype": row["dtype"],
        })
    print(f"total {time.perf_counter() - t0:.1f} s | {smi}", flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
