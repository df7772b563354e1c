#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one H100 and check it end to end.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. Device: a CUDA device of compute capability 9.0; prints its name and
   ``nvidia-smi``'s name and power limit.  TF32 is switched off so the
   plain float32 versions compute in full float32.
2. Build: compiles the attention kernels from ``src/repro_torch/kernels``
   (``nvcc``, sm_90a) and prints the build time and ptxas' register counts.
3. Kernel vs plain: each kernel against its plain PyTorch version on the
   card, at the shape cases of ``tests/test_kernels.py`` (float32, atol
   1e-4; bfloat16, atol 2e-2) and at the serving slice's shapes; one JSON
   line per kernel and shape with the error, the kernel's, the plain
   version's and ``scaled_dot_product_attention``'s times, and the bound.
4. Full-width model: granite-8b at its published widths in bfloat16 with
   seeded random weights; one 512-token prefill and 8 decode steps through
   the kernels and through the plain attention, compared step by step.
5. The slice: ``build_engine`` over the dense Table I fleet at full width,
   8 ticks of Poisson traffic under the paper's allocator; the kernels'
   launch counters are zeroed just before and read just after.

The line before the last is ``{"kernels": [...]}`` (one entry per kernel);
the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the repository's ``src/`` beside it, the script exits non-zero
before printing either.
"""
from __future__ import annotations

import dataclasses
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
# The shape each kernel's summary entry reports: granite-8b at the engine's
# prompt and cache sizes.
SUMMARY_FLASH = (1, 512, 512, 32, 8, 128, True, 0)
SUMMARY_DECODE = (4, 32, 8, 128, 1024, 300, 0)


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
    bms, by = bound(gpu, (2 * b * s_q * h + 2 * b * s_kv * kv) * d * q.element_size(),
                    4 * b * h * d * pairs, dtype)
    return {
        "kernel": "flash_attention", "case": list(case), "dtype": str(dtype).split(".")[-1],
        "max_abs_err": err, "atol": ATOL[dtype], "sdpa_max_abs_err": lib_err,
        "ms": time_ms(lambda: fa.flash_attention(q, k, v, causal=causal, window=window,
                                                 q_offset=off)),
        "plain_ms": time_ms(lambda: ref.mha(q, k, v, causal=causal, window=window, q_offset=off)),
        "library_ms": time_ms(lambda: _sdpa(qt, kt, vt, **lib_args)),
        "bound_ms": bms, "bound_by": by,
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


def phase_kernels(gpu: str) -> dict:
    summary = {}
    runs = ([(check_flash, c, dt) for c in FLASH_CASES for dt in ATOL]
            + [(check_decode, c, dt) for c in DECODE_CASES for dt in ATOL]
            + [(check_flash, c, torch.bfloat16) for c in SLICE_FLASH]
            + [(check_decode, c, torch.bfloat16) for c in SLICE_DECODE])
    for fn, case, dtype in runs:
        row = fn(case, dtype, gpu)
        emit({"phase": "kernel", **row})
        check(row["max_abs_err"] <= row["atol"],
              f"{row['kernel']} {case} {row['dtype']}: max abs err {row['max_abs_err']}")
        if dtype == torch.bfloat16 and tuple(case) in (SUMMARY_FLASH, SUMMARY_DECODE):
            summary[row["kernel"]] = row
    return summary


# ---------------------------------------------------------------------------
# Phase 4: full-width granite-8b through the kernels and the plain attention
# ---------------------------------------------------------------------------

def phase_model(reduced: bool = False, prompt_len: int = 512, steps: int = 8) -> None:
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    cfg = get_config("granite-8b", reduced=reduced)
    api = build_model(cfg)
    params = api.init(0, dtype=torch.bfloat16, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, prompt_len), generator=gen, device=DEVICE)
    max_len = 1024
    with torch.no_grad():
        lk, ck = api.prefill(params, {"tokens": tokens}, max_len)
        lr, cr = api.prefill(params, {"tokens": tokens}, max_len, impl="ref")
        rows = []
        for step in range(steps + 1):
            diff = float((lk.float() - lr.float()).abs().max())
            scale = float(lr.float().abs().max())
            tk, tr = int(lk[0].argmax()), int(lr[0].argmax())
            finite = bool(torch.isfinite(lk).all() and torch.isfinite(lr).all())
            rows.append({"step": step, "max_abs_diff": diff, "max_abs_logit": scale,
                         "rel": diff / scale, "token_kernel": tk, "token_plain": tr,
                         "finite": finite})
            emit({"phase": "model", "arch": cfg.name, **rows[-1]})
            check(finite, f"non-finite logits at step {step}")
            check(diff <= 5e-2 * scale, f"step {step}: max|dlogits| {diff} > 5e-2 * {scale}")
            if step == steps:
                break
            tok = torch.tensor([tk], device=DEVICE)  # both paths decode the kernel path's token
            lk, ck = api.decode_step(params, ck, tok, prompt_len + step, max_len)
            lr, cr = api.decode_step(params, cr, tok, prompt_len + step, max_len, impl="ref")
    agree = sum(r["token_kernel"] == r["token_plain"] for r in rows)
    emit({"phase": "model", "arch": cfg.name, "greedy_agreement": agree, "steps": len(rows)})
    check(agree >= len(rows) - 2, f"greedy tokens agree on {agree} of {len(rows)} steps")
    del params, ck, cr
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 5: the slice end to end
# ---------------------------------------------------------------------------

def phase_engine(reduced: bool = False, ticks: int = 8, prompt=(64, 513), max_len: int = 1024,
                 budget_tokens: int = 2048) -> dict:
    from repro_torch.kernels.attention import decode_attention as da, flash_attention as fa
    from repro_torch.launch.serve import DEFAULT_FLEET, DENSE_FLEET, build_engine

    t0 = time.perf_counter()
    eng = build_engine("adaptive", reduced=reduced, fleet=DENSE_FLEET,
                       budget_tokens=budget_tokens, max_len=max_len, batch_slots=4,
                       device=DEVICE)
    print(f"engine built in {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated", flush=True)
    finite = [torch.ones((), dtype=torch.bool, device=DEVICE)]
    spent = {"prefill": [0, 0.0], "decode": [0, 0.0]}  # calls, seconds (host clock, synced)

    def checked(fn, kind):
        def call(*args, **kwargs):
            t = time.perf_counter()
            logits, caches = fn(*args, **kwargs)
            finite[0] &= torch.isfinite(logits).all()
            torch.cuda.synchronize()
            spent[kind][0] += 1
            spent[kind][1] += time.perf_counter() - t
            return logits, caches
        return call

    for rt in eng.runtimes:
        rt.api = dataclasses.replace(rt.api, prefill=checked(rt.api.prefill, "prefill"),
                                     decode_step=checked(rt.api.decode_step, "decode"))
    vocab = min(rt.api.cfg.vocab_size for rt in eng.runtimes)
    rng = np.random.default_rng(0)
    rates = {name: rate for name, *_, rate in DEFAULT_FLEET}
    tick_s = []
    fa.launches = 0
    da.launches = 0
    for tick in range(ticks):
        for name in eng.fleet.names:
            for _ in range(rng.poisson(rates[name])):
                eng.submit(name, rng.integers(0, vocab, int(rng.integers(*prompt))), 32)
        before = {k: list(v) for k, v in spent.items()}
        t = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        tick_s.append(time.perf_counter() - t)
        calls = {k: spent[k][0] - before[k][0] for k in spent}
        secs = {k: spent[k][1] - before[k][1] for k in spent}
        emit({"phase": "engine_tick", "tick": tick, "wall_s": tick_s[-1],
              "prefill_calls": calls["prefill"], "prefill_s": secs["prefill"],
              "decode_steps": calls["decode"], "decode_s": secs["decode"],
              "other_s": tick_s[-1] - secs["prefill"] - secs["decode"],
              "tokens": eng.history[-1]["decode_tokens"]})
    launches = {"flash_attention": fa.launches, "decode_attention": da.launches}
    m = eng.metrics()
    emit({"phase": "engine", "metrics": _finite(m), "launches": launches,
          "tick_wall_s": tick_s, "allocation": [h["allocation"] for h in eng.history]})
    check(m["completed"] > 0, "no request completed")
    check(bool(finite[0]), "non-finite logits in the engine")
    for h in eng.history:
        check(sum(h["allocation"]) <= 1.0 + 1e-6, f"tick {h['tick']}: Σ allocation > 1")
    for name, n in launches.items():
        check(n > 0, f"{name} was never launched on the main path")
    return launches


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
    phase_model()
    launches = phase_engine()
    sources = {
        "flash_attention": ("src/repro_torch/kernels/attention/csrc/flash_attention.cu",
                            "src/repro/kernels/attention/flash_attention.py:90"),
        "decode_attention": ("src/repro_torch/kernels/attention/csrc/decode_attention.cu",
                             "src/repro/kernels/attention/decode_attention.py:70"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        row = summary[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": row["case"], "dtype": row["dtype"],
        })
    print(f"total {time.perf_counter() - t0:.1f} s | {smi}", flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
