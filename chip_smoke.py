#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one H100 and check it end to end.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. Device: a CUDA device of compute capability 9.0; prints its name and
   ``nvidia-smi``'s name and power limit.  TF32 is switched off so the
   plain float32 versions (and the MoE router) compute in full float32;
   the MoE phases and the end check that it stayed off.
2. Build: compiles the kernels from ``src/repro_torch/kernels`` (``nvcc``,
   sm_90a, one process per source) and prints the build time, ptxas'
   registers, shared memory and spills per kernel, and the number of
   tensor-core instructions in the library's SASS (``cuobjdump``): each
   bf16 flash kernel (D = 32, 64, 128 with one and two consumer warpgroups,
   D = 256 with one) must have ``HGMMA`` (``wgmma``), and each bf16 SSD
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
   mixtral-8x7b's shapes (32 q / 8 kv heads, window 4096): flash at 512,
   6144 and 8192 tokens (at 8192 the plain route is banded, SDPA gets the
   band as an explicit mask, and the bound counts the band's work only),
   decode over a full rolling cache of 4096 entries.  Head dim 256 and 16
   query heads per kv head at the sizes of ``tests/test_kernels.py``, both
   dtypes; recurrentgemma-9b's local attention (16 q heads of 256 on 1 kv
   head, window 2048) at 512, 2048 and 4096 tokens (banded plain route at
   4096) and decode over a full rolling cache of 2048; seamless-m4t-large-
   v2's encoder (4096 frames, no mask) and cross attention in decode (one
   query row over 64 and 4096 frames), both dtypes.
3b. Gradients: the flash and SSD kernels inside autograd
   (``_common.PlainGrad``: the kernel's forward, the plain version's
   backward) against the plain versions' own autograd with the same
   cotangent, both dtypes, at the shape cases of ``tests/test_kernels.py``
   and at the training shapes (flash at qwen2-vl-2b's 2 x 4096 tokens, 12 q
   / 2 kv heads; SSD at mamba2-370m's 4 x 4096, with and without ``h0``),
   each input's largest gap held at 1e-5 of its max|g|; at the training
   shapes three times: the kernel forward with the plain backward, the
   plain forward and backward, and SDPA's forward and backward as a
   yardstick.  The decode kernel must refuse an operand that requires grad.
4. Full-width models, kernels vs plain versions, a prefill and decode steps
   each, compared step by step, at published widths with seeded random
   weights: granite-8b in bfloat16 and mamba2-370m in float32 (held) and in
   bfloat16 (printed beside the spread that a mere change of the plain
   scan's chunk gives; see ``phase_model``), 512-token prompts, 8 steps;
   then the MoE family (``phase_long_model``): mixtral-8x7b in float32 cut
   to 4 layers, an 8192-token prompt (banded on the plain route) and 8
   steps into the rolled cache, held at 1e-3 of max|logits|; granite-moe-
   1b-a400m whole in float32 (24 layers, 32 experts, top-8), 512 tokens and
   4 steps, held the same; mixtral-8x7b in bfloat16 at the fleet's 16
   layers, not held: the logits gap and the share of (token, layer) pairs
   routed to another set of experts, beside the same numbers for the plain
   route's masked attention against its banded form; recurrentgemma-9b
   (the hybrid family) in float32 cut to 6 layers (two superblocks), a
   4096-token prompt (two windows: banded on the plain route) and 8 steps
   into the rolled cache, held at 1e-3, and whole in bfloat16 (38 layers),
   held as granite-8b is, beside the masked-vs-banded yardstick;
   seamless-m4t-large-v2 (the enc-dec family) whole in float32, 4096
   encoder frames, a 512-token prompt and 8 steps, held at 1e-3.
5. The slices, each driven for up to 8 ticks of Poisson traffic under the paper's
   allocator with every kernel's launch counter zeroed just before and read
   just after (``engine_tick`` lines: per-agent prefill and decode seconds,
   launches, device GiB allocated): ``build_engine`` over the dense Table I
   fleet at full width, then the reference's two-agent engine fleet
   (``tests/test_serving.py``: minitron-4b and mamba2-370m) at full width,
   then the Table I fleet itself (``DEFAULT_FLEET``, mixtral-8x7b cut to 16
   of its 32 layers, ``FULL_WIDTH_CUT``, printed), then the hybrid fleet
   (``hybrid_fleet``: the same rows with recurrentgemma-9b, all 38 layers,
   as the reasoning specialist), each of whose reduced twins on the CPU must
   schedule exactly as the card.  The dense fleet runs 4 ticks
   (``DENSE_TICKS``), the Table I and hybrid fleets 6
   (``TWIN_FLEET_TICKS``), each cut from 8 to keep the script's time;
   printed.
6. The serverless layers: ``table2`` runs every registered policy through
   the simulator on the card (Table II's fleet and workload), its step loop
   under sync debug mode "error", checks the Table II anchors and each
   trace against the CPU's, then all three layers on (a coordinator star,
   a reactive pool, the ``chaos`` scenario) and the conservation of queue
   mass with capacity and failures on; ``sweep`` runs the four sweep grids
   on the card as streams (the Table II grid and its chaos axis, five
   fleets of 4–256 agents, five workflows, four capacity policies; the
   chaos, workflow and capacity grids at 50 steps and the fleet grid at 25,
   ``SWEEP_AXIS_STEPS`` and ``SWEEP_FLEET_STEPS``, each cut by half to keep
   the script's time), each loop under the same sync check: the anchors, every cell against the
   CPU's stream and the card's trace oracle (and one or two lead rows of
   each grid against the oracle at the grid's own horizon, each oracle
   run timed), block sizes 1, 8 and 64
   identical on a synthesized grid, the card's synthesized arrivals the
   CPU's bits, and the N = 1024 frontier synthesized on the card at the
   longest horizon that fits ``SWEEP_FRONTIER_S`` of loop (the reference's
   is 10^4 steps; the cut is printed; ``SWEEP_FRONTIER_S`` was cut from 20
   s to 3 s to keep the script's time); ``serverless_engine`` serves the
   full-width dense fleet with routing, a reactive warm pool and failures
   on (launch counters zeroed and read as in phase 5), and checks that the
   same engine at reduced widths on the CPU schedules exactly as the card.
   ``table2_oracle`` holds each Table II trace on the card, with no layer and
   with all three on, to the port's float64 numpy oracle
   (``core/reference_sim.py``) at the reference's tolerances; the sweep mesh
   (``phase_sweep_mesh``): ``sweep_blocks`` runs the four entry points'
   grids at ``tests/test_sharding.py``'s sizes as the 8 rank blocks of a
   (2, 2, 2) mesh in this process and a stream in 3 policy blocks, each
   bit for bit the unsharded run; ``sweep_nccl`` runs the same grids over
   a (1, 1, 1) mesh of a one-rank NCCL group (the gather on the card), bit
   for bit ``shard=False``, and destroys the group.
6c. Train (``phase_train``, run when no fleet is resident on the card):
   qwen2-vl-2b, mamba2-370m and granite-moe-1b-a400m at published widths
   cut to 4 layers, float32, 3 ``build_train_step`` steps through the
   kernels and 3 through the plain versions from the same parameters
   (batch 2 x seq 1024): loss, ce, aux and grad_norm held at each step,
   the parameters after the last where the gradient is not at rounding
   level (``train_compare``); then qwen2-vl-2b whole in bf16 (2 x 4096, the
   reference's ``train_4k`` length at a batch cut from 256) and mamba2-370m
   whole (4 x 4096), 20 steps each of the launcher's AdamW on
   ``SyntheticTokens``, one ``train_step`` line a step (loss, grad_norm,
   lr, host-clock step time after a sync, tokens/s, kernel launches: each
   layer in the forward and in remat's recompute, peak GiB, ``mfu``); the
   loss must stay finite and drop by at least 0.3; on mamba2-370m a
   checkpoint saved after step 10 and restored into a fresh tree must
   resume step 11 bit for bit.
7. Profile: full-width granite-8b and mixtral-8x7b (the fleet's 16 layers)
   decode steps (4 rows, a 300-entry cache) on the host clock and in
   ``torch.profiler``: the device's busy share of a step and its device
   kernels per layer; then checks that a decode call with an int length is
   one device kernel, and that a bf16 SSD call is one device kernel that
   allocates only its outputs, with the SSD device time of a full-width
   mamba2-370m prefill of 512 tokens; then recurrentgemma-9b's decode step
   the same way (its host clock read before the first profile), the device
   kernels and time of one layer of each kind (``profile_layer_kinds``), and
   the RG-LRU scan's share of the device time of a 2048-token prefill
   (``rglru_scan``); then the device kernels per step and the busy share of
   a Table II ``simulate`` under ``adaptive`` and of the Table II grid's
   stream (``sweep_profile``); last, one training step of each whole model
   of the train phase (``profile_train``: busy share over its median step,
   the kernel's device time, the plain backward's, the forward's and the
   optimizer's, and the logits and CE timed alone at the step's shapes).
   A ``time`` line after each group of phases gives the script's time so
   far.
8. Roofline (``phase_roofline``): the card as ``launch/mesh.py`` reads it
   (name, memory, SMs, the data sheet's peaks); the dry-run and the
   roofline of every (arch, shape) pair of ``INPUT_SHAPES`` at published
   widths on ``meta`` in ``ROOFLINE_WORKERS`` processes (one
   ``roofline_pair`` line each: the terms, the bottleneck, peak GiB,
   ``fits``, the largest batch that fits; artifacts under
   ``experiments/*_torch``); the roofline of each step phases 6c and 7 timed
   at its own shape, held at most ``ROOFLINE_SLACK`` times its device time, and
   the dry-run's peak of each whole-model training step within
   ``PEAK_RTOL`` of ``max_memory_allocated``; the Table I architectures'
   derived (T, R, M) at ``decode_32k`` and at the engine's decode shape
   beside the paper's Table I, and that fleet through ``simulate`` on the
   card under four policies (``roofline_fleet`` lines).

9. Examples (``phase_examples``): each ``examples/*_torch.py`` once on the
   card at its defaults through its ``main`` (``example`` lines: wall
   time, every printed number finite; quickstart's Table II anchors).

The line before the last is ``{"kernels": [...]}`` (one entry per kernel);
the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the repository's ``src/`` beside it, the script exits non-zero
before printing either.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import re
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
# mixtral-8x7b's heads (32 q / 8 kv) and window of 4096: a prompt inside the
# window, one past it, and one that the plain route computes banded
# (ref.uses_banded); decode over a full rolling cache of 4096 entries.
MIXTRAL_WINDOW = 4096
MIXTRAL_FLASH = [(1, s, s, 32, 8, 128, True, MIXTRAL_WINDOW) for s in (512, 6144, 8192)]
MIXTRAL_DECODE = [(4, 32, 8, 128, MIXTRAL_WINDOW, MIXTRAL_WINDOW, MIXTRAL_WINDOW)]
# Head dim 256 and 16 query heads per kv head at the sizes of
# tests/test_kernels.py's cases, both dtypes.
D256_FLASH_CASES = [
    (2, 128, 128, 16, 1, 256, True, 0),
    (1, 200, 200, 8, 8, 256, True, 0),
    (2, 64, 256, 16, 1, 256, False, 0),
    (1, 256, 256, 16, 1, 256, True, 64),
]
D256_DECODE_CASES = [
    (2, 16, 1, 256, 300, 150, 0),
    (1, 16, 1, 256, 512, 512, 0),
    (3, 32, 2, 256, 256, 256, 128),
    (2, 16, 1, 64, 1024, 700, 0),
    (1, 16, 1, 128, 96, 1, 0),
]
# recurrentgemma-9b's local attention (16 q heads of 256 on 1 kv head,
# window 2048): prompts inside the window, of one window and of two (the
# plain route banded); decode over a full rolling cache of 2048 entries.
RG_WINDOW = 2048
RG_FLASH = [(1, s, s, 16, 1, 256, True, RG_WINDOW) for s in (512, 2048, 4096)]
RG_DECODE = [(4, 16, 1, 256, RG_WINDOW, RG_WINDOW, RG_WINDOW)]
# seamless-m4t-large-v2 (16 heads on 16, D 64): the encoder over 4096
# frames, and cross attention in decode, one query row per batch row over
# 64 frames (the engine's stub) and 4096.
SEAMLESS_FLASH = [(1, 4096, 4096, 16, 16, 64, False, 0)]
SEAMLESS_FLASH += [(4, 1, s, 16, 16, 64, False, 0) for s in (64, 4096)]
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


def bound(gpu_name: str, cost) -> tuple[float, str]:
    """Least time in ms of a kernel call's ``cost`` (its wrapper's ``cost``
    function): the larger of its bytes over the memory rate and its
    operations over the peak rate for the inputs' type, from the data-sheet
    row of ``launch/mesh.py`` that the card's name matches."""
    from repro_torch.launch import mesh

    return mesh.bound_ms(cost, mesh.hw(gpu_name))


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
    check_tf32_off()
    print("tf32 off for matmul and cudnn: plain float32 versions compute in full float32")
    return smi


def check_tf32_off() -> None:
    """The MoE router's float32 product, and every float32 comparison, is
    float32 only while TF32 stays off."""
    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "TF32 is on: float32 products would round to TF32")


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
    # D = 32, 64, 128 with one and two consumers; D = 256 with one.
    flash = {k: c.get("HGMMA", 0) for k, c in counts.items() if "flash_sm90_kernel" in k}
    ssd = {k: c for k, c in counts.items() if "ssd_sm90_kernel" in k}
    print(f"sass: {sum(c.get('HGMMA', 0) for c in counts.values())} HGMMA instructions, "
          f"{sum(flash.values())} in {len(flash)} bf16 flash kernels; bf16 SSD kernels "
          f"(HGMMA, HMMA): {sorted((c.get('HGMMA', 0), c.get('HMMA', 0)) for c in ssd.values())}",
          flush=True)
    check(len(flash) == 7 and all(flash.values()),
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
    # the plain route: banded where ref.uses_banded holds, masked elsewhere
    want = ref.flash_plain(q, k, v, causal=causal, window=window, q_offset=off)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    mask = ref.attention_mask(s_q, s_kv, causal=causal, window=window, q_offset=off, device=DEVICE)
    pairs = int(mask.sum())
    counted = fa.pairs(s_q, s_kv, causal=causal, window=window, q_offset=off)
    check(pairs == counted,
          f"flash_attention {case}: cost counts {counted} pairs, the mask holds {pairs}")
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
    cost = fa.cost(b, s_q, s_kv, h, kv, d, causal=causal, window=window, q_offset=off,
                   dtype=dtype)
    flops = cost.flops[dtype]
    bms, by = bound(gpu, cost)
    ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=causal, window=window, q_offset=off))
    return {
        "kernel": "flash_attention", "case": list(case), "dtype": str(dtype).split(".")[-1],
        "route": fa.route(dtype), "max_abs_err": err, "atol": ATOL[dtype],
        "plain_route": "banded" if ref.uses_banded(s_q, s_kv, causal=causal, window=window,
                                                   q_offset=off) else "masked",
        "sdpa_max_abs_err": lib_err, "ms": ms,
        "plain_ms": time_ms(lambda: ref.flash_plain(q, k, v, causal=causal, window=window,
                                                    q_offset=off)),
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
    begin, end = da.valid_range(clen, s_max, window)
    check(end - begin == n_valid,
          f"decode_attention {case}: cost counts {end - begin} entries, the mask holds {n_valid}")
    mask = valid[None, None, None, :].expand(b, 1, 1, s_max)
    qt, kt, vt = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
    bms, by = bound(gpu, da.cost(b, h, kv, d, s_max, clen, window=window, dtype=dtype))
    ms = time_ms(lambda: da.decode_attention(q, kc, vc, clen, window=window))
    return {
        "kernel": "decode_attention", "case": list(case), "dtype": str(dtype).split(".")[-1],
        "max_abs_err": err, "atol": ATOL[dtype], "ms": ms,
        "plain_ms": time_ms(lambda: ref.decode_gqa(q, kc, vc, clen, window=window)),
        "library_ms": time_ms(lambda: _sdpa(qt, kt, vt, mask)),
        "bound_ms": bms, "bound_by": by, "bound_share": bms / ms,
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
    cost = ssd_scan.cost(b, s, h, p, n, chunk=chunk, h0=with_h0, dtype=dtype)
    flops = cost.flops[dtype]
    bms, by = bound(gpu, cost)
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


def _device_session(fn, calls: int, sessions: int = 3) -> list:
    """The device events of ``calls`` calls of ``fn`` in one
    ``torch.profiler`` session (CUDA activity only).  A session that saw no
    device event at all is taken again, up to ``sessions`` in all: the
    profiler once dropped a whole session's device events on the card
    (``check_ssd_launches``, three bf16 calls, 0 events), which says nothing
    of the kernels; any event it does see is held by the caller's checks."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = _device_events(prof)
        if events:
            break
        print(f"profiler: no device event in a session of {calls} calls; taken again",
              flush=True)
    return events


def check_ssd_launches(case=SUMMARY_SSD, calls: int = 3) -> dict:
    """A bf16 SSD call is one device kernel and allocates nothing but y and
    the final state; then the SSD device time of one full-width
    mamba2-370m prefill of ``case``'s length (``torch.profiler``)."""
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
    names = [e.name for e in _device_session(lambda: ssd_scan.ssd(x, dt, A, Bm, Cm, D,
                                                                  chunk=chunk), calls)]
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
        kernels = _device_session(lambda: api.prefill(params, {"tokens": tokens}, 1024), 1)
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
    from repro_torch.kernels.attention import decode_attention as da

    b, h, kv, d, s_max, clen, window = case
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    q = _randn(gen, (b, h, d), torch.bfloat16)
    kc, vc = (_randn(gen, (b, s_max, kv, d), torch.bfloat16) for _ in range(2))
    da.decode_attention(q, kc, vc, clen, window=window)
    torch.cuda.synchronize()
    names = [e.name for e in _device_session(
        lambda: da.decode_attention(q, kc, vc, clen, window=window), calls)]
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
            + [(check_ssd, c, torch.bfloat16) for c in SLICE_SSD]
            + [(check_flash, c, torch.bfloat16) for c in MIXTRAL_FLASH]
            + [(check_decode, c, torch.bfloat16) for c in MIXTRAL_DECODE]
            + [(check_flash, c, dt) for c in D256_FLASH_CASES for dt in ATOL]
            + [(check_decode, c, dt) for c in D256_DECODE_CASES for dt in ATOL]
            + [(check_flash, c, dt) for c in RG_FLASH + SEAMLESS_FLASH for dt in ATOL]
            + [(check_decode, c, dt) for c in RG_DECODE for dt in ATOL])
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
# Phase 3b: gradients through the kernels' autograd Functions
# ---------------------------------------------------------------------------

# The training shapes: qwen2-vl-2b's attention (12 q / 2 kv heads of 128,
# causal) at 2 x 4096 tokens; mamba2-370m's SSD (32 heads of P 64, N 128,
# chunk 128) at 4 x 4096, without and with h0.
GRAD_FLASH_TRAIN = [(2, 4096, 4096, 12, 2, 128, True, 0)]
GRAD_SSD_TRAIN = [(4, 4096, 32, 64, 128, 128, False), (4, 4096, 32, 64, 128, 128, True)]
# The Function's backward is the plain version's, recomputed from the same
# inputs, and both runs get the same cotangent: the gradients can differ
# only where the card sums in another order.  Each input's largest gap over
# its gradient's max|g|.
GRAD_RTOL = 1e-5


def _grad_gaps(out, want, inputs, plain_inputs, cots) -> list:
    got = torch.autograd.grad(out, inputs, cots)
    ref_grads = torch.autograd.grad(want, plain_inputs, cots)
    return [float((g.float() - w.float()).abs().max() / w.float().abs().max())
            for g, w in zip(got, ref_grads)]


def _grad_bound(cost) -> tuple[float, str]:
    """Least time in ms of a kernel call's forward and backward
    (``Cost.with_backward``) on this card."""
    from repro_torch.launch import mesh

    return mesh.bound_ms(cost.with_backward(), mesh.hw())


def check_flash_grad(case, dtype, timed: bool) -> dict:
    from repro_torch.kernels.attention import flash_attention as fa, ref

    b, s_q, s_kv, h, kv, d, causal, window = case
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    qkv = [_randn(gen, (b, s, n, d), dtype) for s, n in ((s_q, h), (s_kv, kv), (s_kv, kv))]
    cot = _randn(gen, (b, s_q, h, d), dtype)
    kw = dict(causal=causal, window=window, q_offset=s_kv - s_q if causal else 0)
    leaves = [x.clone().requires_grad_() for x in qkv]
    plain = [x.clone().requires_grad_() for x in qkv]
    out = fa.flash_attention(*leaves, **kw)
    check(out.grad_fn is not None, "flash_attention: the kernel's output is cut off from the graph")
    want = ref.flash_plain(*plain, **kw)
    err = float((out.detach().float() - want.detach().float()).abs().max())
    gaps = _grad_gaps(out, want, leaves, plain, cot)
    row = {"kernel": "flash_attention", "case": list(case), "dtype": str(dtype).split(".")[-1],
           "max_abs_err": err, "atol": ATOL[dtype],
           "grad_gap": dict(zip(("q", "k", "v"), gaps)), "rtol": GRAD_RTOL}
    if timed:
        bhsd = [x.transpose(1, 2).detach().requires_grad_() for x in qkv]
        cot_t = cot.transpose(1, 2)
        row["bound_ms"], row["bound_by"] = _grad_bound(fa.cost(
            b, s_q, s_kv, h, kv, d, dtype=dtype, **kw))
        row.update({
            "kernel_fwd_plain_bwd_ms": time_ms(lambda: torch.autograd.grad(
                fa.flash_attention(*leaves, **kw), leaves, cot), iters=5, warmup=1),
            "plain_fwd_bwd_ms": time_ms(lambda: torch.autograd.grad(
                ref.flash_plain(*plain, **kw), plain, cot), iters=5, warmup=1),
            "sdpa_fwd_bwd_ms": time_ms(lambda: torch.autograd.grad(
                _sdpa(*bhsd, is_causal=True), bhsd, cot_t), iters=5, warmup=1),
        })
    return row


def check_ssd_grad(case, dtype, timed: bool) -> dict:
    from repro_torch.kernels.ssd import ref, ssd_scan

    chunk, with_h0 = case[5], case[6]
    x, dt, A, Bm, Cm, D, h0 = _ssd_inputs(case, dtype, seed=6)
    inputs = [t for t in (x, dt, A, Bm, Cm, D, h0) if t is not None]
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    cots = [_randn(gen, x.shape, dtype),
            torch.randn((x.shape[0], x.shape[2], x.shape[3], Bm.shape[-1]), generator=gen,
                        device=DEVICE)]

    def call(fn, args, chunk=chunk):
        args = list(args) + [None] * (7 - len(args))
        return list(fn(*args[:6], h0=args[6], chunk=chunk))

    leaves = [t.clone().requires_grad_() for t in inputs]
    plain = [t.clone().requires_grad_() for t in inputs]
    out = call(ssd_scan.ssd, leaves)
    check(all(o.grad_fn is not None for o in out), "ssd: the kernel's outputs are cut off")
    want = call(ref.ssd_chunked, plain)
    (gy, gh), (wy, wh) = ([t.detach().float() for t in o] for o in (out, want))
    # The forward held as phase 3 holds it: y within SSD_ATOL plus, at
    # mamba2-370m's widths in bf16, one step of its magnitude; the state
    # within SSD_ATOL.  In float32 at those widths y is allowed, beyond
    # SSD_ATOL, the plain version's own spread when only its chunk length
    # changes (chunk vs chunk/2, the same sums in another order): the plain
    # version takes each decay as exp of a difference of float32 cumulative
    # sums of A·dt, which reach ~100 over a chunk (the kernel keeps them in
    # double, csrc/ssd_scan.cu).
    wide = tuple(case[2:5]) == SLICE_SSD[0][2:5]
    rtol = SSD_WIDE_RTOL if wide and dtype == torch.bfloat16 else 0.0
    yard = 0.0
    if wide and dtype == torch.float32:
        with torch.no_grad():
            half = call(ref.ssd_chunked, inputs, chunk=chunk // 2)
        yard = float((half[0].float() - wy).abs().max())
    dy = (gy - wy).abs()
    gaps = _grad_gaps(out, want, leaves, plain, cots)
    names = ("x", "dt", "A", "Bm", "Cm", "D", "h0")
    row = {"kernel": "ssd", "case": list(case), "dtype": str(dtype).split(".")[-1],
           "max_abs_err": float(dy.max()), "excess_over_rtol": float((dy - rtol * wy.abs()).max()),
           "h_max_abs_err": float((gh - wh).abs().max()), "atol": SSD_ATOL[dtype] + yard,
           "h_atol": SSD_ATOL[dtype], "fwd_rtol": rtol,
           "plain_chunk_half_spread": yard if wide and dtype == torch.float32 else None,
           "grad_gap": dict(zip(names, gaps)), "rtol": GRAD_RTOL}
    if timed:
        b, s, h, p, n = case[:5]
        row["bound_ms"], row["bound_by"] = _grad_bound(ssd_scan.cost(
            b, s, h, p, n, chunk=chunk, h0=with_h0, dtype=dtype))
        row.update({
            "kernel_fwd_plain_bwd_ms": time_ms(lambda: torch.autograd.grad(
                call(ssd_scan.ssd, leaves), leaves, cots), iters=5, warmup=1),
            "plain_fwd_bwd_ms": time_ms(lambda: torch.autograd.grad(
                call(ref.ssd_chunked, plain), plain, cots), iters=5, warmup=1),
            "library_fwd_bwd_ms": None,
        })
    return row


def check_decode_refuses_grad() -> None:
    from repro_torch.kernels.attention import decode_attention as da

    gen = torch.Generator(device=DEVICE).manual_seed(8)
    q = _randn(gen, (4, 32, 128), torch.bfloat16).requires_grad_()
    kc, vc = (_randn(gen, (4, 1024, 8, 128), torch.bfloat16) for _ in range(2))
    try:
        da.decode_attention(q, kc, vc, 300)
    except RuntimeError as e:
        emit({"phase": "decode_refuses_grad", "error": str(e)})
        return
    raise RuntimeError("chip_smoke: the decode kernel returned a tensor cut off from the graph")


def phase_gradients() -> dict:
    """The Functions' outputs and gradients against the plain versions' own,
    both dtypes, at tests/test_kernels.py's cases and the training shapes.
    The backward recomputes the plain version from the inputs and never
    reads the kernel's output, so the output is held on its own, within
    phase 3's tolerances.  Timed at the training shapes: the kernel forward
    with the plain backward, the plain forward and backward, and SDPA's
    forward and backward as a yardstick.  The decode wrapper must refuse an
    operand that requires grad."""
    rows = {}
    runs = ([(check_flash_grad, c, dt, False) for c in FLASH_CASES for dt in ATOL]
            + [(check_ssd_grad, c, dt, False) for c in SSD_CASES for dt in SSD_ATOL]
            + [(check_flash_grad, c, dt, True) for c in GRAD_FLASH_TRAIN for dt in ATOL]
            + [(check_ssd_grad, c, dt, True) for c in GRAD_SSD_TRAIN for dt in SSD_ATOL])
    for fn, case, dtype, timed in runs:
        row = fn(case, dtype, timed)
        emit({"phase": "kernel_grad", **row})
        err = row.get("excess_over_rtol", row["max_abs_err"])
        check(err <= row["atol"] and row.get("h_max_abs_err", 0.0) <= row.get("h_atol", 0.0),
              f"{row['kernel']} {case} {row['dtype']} forward: max abs err {row['max_abs_err']}")
        worst = max(row["grad_gap"].values())
        check(worst <= GRAD_RTOL,
              f"{row['kernel']} {case} {row['dtype']} gradients: {row['grad_gap']}")
        if timed:
            rows[(row["kernel"], tuple(case), row["dtype"])] = row
    check_decode_refuses_grad()
    gc.collect()
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phase 4: full-width models through the kernels and the plain versions
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _recorded_routes():
    """Record the expert ids (B, S, K) of every ``moe._router`` call made
    inside the block, in call order: layer by layer, prefill then decode."""
    from repro_torch.models import moe

    routes, router = [], moe._router

    def recording(x, p, cfg):
        out = router(x, p, cfg)
        routes.append(out[1])
        return out

    moe._router = recording
    try:
        yield routes
    finally:
        moe._router = router


@contextlib.contextmanager
def _masked_plain():
    """The plain route without its banded form: ``ref.mha`` for every window."""
    from repro_torch.kernels.attention import ref

    rule = ref.uses_banded
    ref.uses_banded = lambda *args, **kwargs: False
    try:
        yield
    finally:
        ref.uses_banded = rule


def _run_path(api, impl, params, tokens, steps: int, max_len: int, feed=None, frames=None):
    """Prefill ``tokens`` (with the enc-dec family's encoder ``frames``), then
    ``steps`` greedy decode steps (or the tokens of ``feed``) through ``api``
    with ``impl``.  Returns (float32 logits per step, the tokens fed, the
    expert ids of every MoE router call)."""
    batch = {"tokens": tokens} if frames is None else {"tokens": tokens, "frontend_embeds": frames}
    with _recorded_routes() as routes:
        logits, caches = api.prefill(params, batch, max_len, impl=impl)
        out, fed = [logits.float()], []
        for step in range(steps):
            tok = feed[step] if feed is not None else logits.argmax(-1)
            fed.append(tok)
            logits, caches = api.decode_step(params, caches, tok, tokens.shape[1] + step,
                                             max_len, impl=impl)
            out.append(logits.float())
    return out, fed, routes


def _route_flip_share(ra, rb) -> float:
    """The share of (token, layer) pairs whose set of experts differs."""
    pairs = differ = 0
    for a, b in zip(ra, rb, strict=True):
        a, b = a.sort(-1).values, b.sort(-1).values
        differ += int((a != b).any(-1).sum())
        pairs += a[..., 0].numel()
    return differ / pairs


def _compare_runs(cfg, dtype, run_a, run_b, held: bool, label: str, rtol: float = 5e-2) -> dict:
    """Compare two runs of ``_run_path`` (the second fed the first's tokens)
    step by step.  Held: within ``rtol`` of max|logits| at every step and the
    same greedy token at all but two steps; otherwise the numbers are
    printed and only finiteness holds.  For an MoE model the share of
    (token, layer) pairs routed to another set of experts is printed too."""
    (la, _, ra), (lb, _, rb) = run_a, run_b
    rows = []
    for step, (a, b) in enumerate(zip(la, lb, strict=True)):
        diff = float((a - b).abs().max())
        scale = float(b.abs().max())
        ta, tb = int(a[0].argmax()), int(b[0].argmax())
        finite = bool(torch.isfinite(a).all() and torch.isfinite(b).all())
        rows.append({"step": step, "max_abs_diff": diff, "max_abs_logit": scale,
                     "rel": diff / scale, "token_a": ta, "token_b": tb, "finite": finite})
        emit({"phase": "model", "arch": cfg.name, "compare": label, "held": held,
              "dtype": str(dtype), **rows[-1]})
        check(finite, f"{cfg.name} {label}: non-finite logits at step {step}")
        if held:
            check(diff <= rtol * scale,
                  f"{cfg.name} {label} step {step}: max|dlogits| {diff} > {rtol} * {scale}")
    agree = sum(r["token_a"] == r["token_b"] for r in rows)
    summary = {"phase": "model", "arch": cfg.name, "layers": cfg.num_layers, "compare": label,
               "held": held, "rtol": rtol if held else None, "greedy_agreement": agree,
               "steps": len(rows), "max_rel": max(r["rel"] for r in rows)}
    if ra:
        summary["route_flip_share"] = _route_flip_share(ra, rb)
        summary["routed_pairs"] = sum(r[..., 0].numel() for r in ra)
    emit(summary)
    if held:
        check(agree >= len(rows) - 2,
              f"{cfg.name} {label}: greedy tokens agree on {agree} of {len(rows)} steps")
    return summary


def _compare(cfg, params, tokens, path, ref_path, held: bool, label: str,
             steps: int = 8, max_len: int = 1024, rtol: float = 5e-2) -> dict:
    """Prefill ``tokens`` and decode ``steps`` tokens through two paths, each
    an (api, impl) pair, the second fed the first's greedy tokens; compare
    the logits at every step (``_compare_runs``)."""
    run_a = _run_path(*path, params, tokens, steps, max_len)
    run_b = _run_path(*ref_path, params, tokens, steps, max_len, feed=run_a[1])
    return _compare_runs(cfg, params["final_norm"]["scale"].dtype, run_a, run_b, held, label,
                         rtol)


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


def _attention_launches(cfg, steps: int) -> tuple[int, int]:
    """The flash and decode launches of one prefill and ``steps`` decode
    steps: one flash per attention layer of a decoder-only model; for the
    enc-dec family one per encoder layer and two per decoder layer (self
    and cross), and in decode one decode launch and one flash (cross) per
    decoder layer."""
    from repro_torch.models.transformer import layer_kinds

    if cfg.arch_type == "encdec":
        return (cfg.encoder_layers + 2 * cfg.num_layers + steps * cfg.num_layers,
                steps * cfg.num_layers)
    n_attn = sum(kind.startswith("attn") for kind in layer_kinds(cfg))
    return n_attn, steps * n_attn


def phase_long_model(arch: str, dtype, num_layers: int | None = None, prompt_len: int = 512,
                     steps: int = 8, held: bool = True, rtol: float = 5e-2,
                     yardstick: bool = False, frames: int = 0) -> dict:
    """``arch`` at published widths, cut in depth to ``num_layers`` if given,
    through the kernels and through the plain versions: a prompt of
    ``prompt_len`` tokens (after ``frames`` seeded random encoder frames for
    the enc-dec family), then ``steps`` decode steps.  With a window (mixtral-
    8x7b's 4096, recurrentgemma-9b's local 2048) and a prompt of two windows
    the plain prefill is banded and every decode step writes into a rolled
    cache.  One line per run, ``<arch_type>_model`` (``moe_model``,
    ``hybrid_model``, ``encdec_model``), then the step-by-step comparison.

    Held in float32.  MoE in bfloat16 is not held: with seeded random
    weights a one-step bfloat16 difference between the routes flips the
    top-k choice where two experts nearly tie, and the flip moves that
    token's output by the whole difference of two experts.  The run prints
    the logits gap and the share of (token, layer) pairs routed to another
    set of experts, and with ``yardstick`` the same two numbers for a mere
    change of the plain route's attention form (masked ``mha`` against
    banded)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import decode_attention as da, flash_attention as fa
    from repro_torch.models.model import build_model

    check_tf32_off()
    cfg = get_config(arch)
    if num_layers is not None:
        print(f"{arch}: depth cut to {num_layers} of {cfg.num_layers} layers", flush=True)
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    api = build_model(cfg)
    params = api.init(0, dtype=dtype, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, prompt_len), generator=gen, device=DEVICE)
    enc = (torch.randn((1, frames, cfg.d_model), generator=gen, device=DEVICE) * 0.02).to(dtype) \
        if frames else None
    max_len = 2 * prompt_len  # a window's cache holds min(window, max_len) entries
    decls = api.cache_decls(1, max_len)
    kv_decls = decls["self"] if cfg.arch_type == "encdec" else decls["blocks"]
    label = "kernels_vs_plain"
    with torch.no_grad():
        before = (fa.launches, da.launches)
        torch.cuda.reset_peak_memory_stats()
        kernels = _run_path(api, None, params, tokens, steps, max_len, frames=enc)
        launches = (fa.launches - before[0], da.launches - before[1])
        plain = _run_path(api, "ref", params, tokens, steps, max_len, feed=kernels[1], frames=enc)
        check((fa.launches - before[0], da.launches - before[1]) == launches,
              f"{arch}: the plain route launched a kernel")
        emit({"phase": f"{cfg.arch_type}_model", "arch": arch, "layers": cfg.num_layers,
              "dtype": str(dtype), "prompt": prompt_len, "frames": frames, "steps": steps,
              "cache_entries": next(c["k"].shape[1] for c in kv_decls if "k" in c),
              "flash_launches": launches[0], "decode_launches": launches[1],
              "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
        check(launches == _attention_launches(cfg, steps),
              f"{arch}: {launches} flash and decode launches for one prefill and {steps} steps")
        out = _compare_runs(cfg, dtype, kernels, plain, held, label, rtol)
        if yardstick:
            with _masked_plain():
                masked = _run_path(api, "ref", params, tokens, steps, max_len, feed=kernels[1],
                                   frames=enc)
            _compare_runs(cfg, dtype, masked, plain, False, "plain_masked_vs_banded")
    check_tf32_off()
    del params, kernels, plain
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 5: the slices end to end
# ---------------------------------------------------------------------------

def _launch_counters():
    from repro_torch.kernels.attention import decode_attention as da, flash_attention as fa
    from repro_torch.kernels.ssd import ssd_scan

    return {"flash_attention": fa, "decode_attention": da, "ssd": ssd_scan}


def submit_tick(eng, arrivals) -> None:
    """Submit one tick of a pre-drawn schedule: (agent, raw token ids, new
    tokens) triples, the ids taken modulo the smallest vocabulary of
    ``eng``'s agents, so engines over different widths get the same
    prompt lengths."""
    vocab = min(rt.api.cfg.vocab_size for rt in eng.runtimes)
    for name, ids, new in arrivals:
        eng.submit(name, ids % vocab, new)


def poisson_schedule(rates: dict, ticks: int = 8, prompt=(64, 513), new: int = 32,
                     seed: int = 0) -> list:
    """Poisson arrivals at ``rates`` per agent and tick, prompts of ``prompt``
    tokens (raw ids below 2^31), ``new`` new tokens each."""
    rng = np.random.default_rng(seed)
    return [[(name, rng.integers(0, 2**31, int(rng.integers(*prompt))), new)
             for name, rate in rates.items() for _ in range(rng.poisson(rate))]
            for _ in range(ticks)]


def drive(eng, rates: dict, label: str, ticks: int = 8, prompt=(64, 513),
          schedule=None) -> dict:
    """Drive ``eng`` for ``ticks`` ticks of Poisson arrivals at ``rates`` per
    agent, prompts of ``prompt`` tokens and 32 new tokens each (or of the
    pre-drawn ``schedule``, see ``submit_tick``); check what comes out and
    return the kernels' launches and the prefill counts."""
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
        if schedule is not None:
            submit_tick(eng, schedule[tick])
        else:
            for name in eng.fleet.names:
                for _ in range(rng.poisson(rates[name])):
                    eng.submit(name, rng.integers(0, vocab, int(rng.integers(*prompt))), 32)
        before = {n: {k: list(v) for k, v in kinds.items()} for n, kinds in spent.items()}
        launched = {name: mod.launches for name, mod in counters.items()}
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
              "tokens": eng.history[-1]["decode_tokens"], "per_agent": per_agent,
              "launches": {name: mod.launches - launched[name] for name, mod in counters.items()},
              "gib_allocated": torch.cuda.memory_allocated() / 2**30,
              **{k: eng.history[-1][k] for k in ("warm", "pending", "revoked_frac", "down",
                                                 "routed")}})
    launches = {name: mod.launches for name, mod in counters.items()}
    m = eng.metrics()
    emit({"phase": "engine", "fleet": label, "metrics": _finite(m), "launches": launches,
          "tick_wall_s": tick_s, "allocation": [h["allocation"] for h in eng.history],
          "prefills": {n: kinds["prefill"][0] for n, kinds in spent.items()}})
    check(m["completed"] > 0, f"{label}: no request completed")
    check(bool(finite[0]), f"{label}: non-finite logits in the engine")
    for h in eng.history:
        budget = h["warm"] * (1.0 - h["revoked_frac"])
        check(sum(h["allocation"]) <= budget + 1e-6,
              f"{label} tick {h['tick']}: Σ allocation > warm · (1 - revoked) = {budget}")
    return {"launches": launches, "prefills": {n: k["prefill"][0] for n, k in spent.items()},
            "completed": {n: sum(r.agent == n for r in eng.completed) for n in eng.fleet.names}}


DENSE_TICKS = 4  # cut from 8 to keep the script's time: the Table I and hybrid fleets run 8


def phase_engine(reduced: bool = False, max_len: int = 1024, budget_tokens: int = 2048) -> dict:
    """The dense Table I fleet (``build_engine``) at full width, for
    ``DENSE_TICKS`` ticks."""
    from repro_torch.launch.serve import DEFAULT_FLEET, DENSE_FLEET, build_engine

    t0 = time.perf_counter()
    eng = build_engine("adaptive", reduced=reduced, fleet=DENSE_FLEET,
                       budget_tokens=budget_tokens, max_len=max_len, batch_slots=4,
                       device=DEVICE)
    print(f"engine built in {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"dense: {DENSE_TICKS} of 8 ticks (cut to keep the script's time)", flush=True)
    out = drive(eng, {name: rate for name, *_, rate in DEFAULT_FLEET}, "dense", ticks=DENSE_TICKS)
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


HISTORY_FIELDS = ("allocation", "queues", "decode_tokens", "routed", "warm", "pending",
                  "revoked_frac", "down")


def same_schedule(eng, twin) -> dict:
    """Which scheduling fields of the history, and whether ``metrics()``,
    are equal between an engine and its twin."""
    same = {k: [h[k] for h in eng.history] == [h[k] for h in twin.history]
            for k in HISTORY_FIELDS}
    same["metrics"] = _finite(eng.metrics()) == _finite(twin.metrics())
    return same


def hybrid_fleet() -> tuple:
    """``DEFAULT_FLEET``'s four rows with recurrentgemma-9b as the reasoning
    specialist in mixtral-8x7b's place (the reference names no such fleet)."""
    from repro_torch.launch.serve import DEFAULT_FLEET

    return tuple((name, "recurrentgemma-9b" if arch == "mixtral-8x7b" else arch, *rest)
                 for name, arch, *rest in DEFAULT_FLEET)


def phase_fleet_with_twin(fleet, label: str, num_layers=None, ticks: int = 8,
                          max_len: int = 1024, budget_tokens: int = 2048) -> dict:
    """``fleet`` at published widths, cut in depth by ``num_layers`` where
    given, over ``ticks`` ticks of Poisson arrivals at its rates; then the
    same engine at reduced widths on the CPU over the same arrival schedule
    must schedule exactly as the card (the schedule depends on prompt
    lengths, token counts, budgets, slots and ``max_len``, never on the
    logits)."""
    from repro_torch.launch.serve import build_engine

    t0 = time.perf_counter()
    eng = build_engine("adaptive", reduced=False, fleet=fleet, num_layers=num_layers,
                       budget_tokens=budget_tokens, max_len=max_len, batch_slots=4,
                       device=DEVICE)
    print(f"{label} engine built in {time.perf_counter() - t0:.1f} s; "
          f"{[arch for _, arch, *_ in fleet]}; depth cut {num_layers or 'none'}, widths uncut; "
          f"{ticks} of 8 ticks", flush=True)
    schedule = poisson_schedule({name: rate for name, *_, rate in fleet}, ticks=ticks)
    out = drive(eng, {}, label, ticks=ticks, schedule=schedule)
    for name in ("flash_attention", "decode_attention"):
        check(out["launches"][name] > 0, f"{name} was never launched on the {label} fleet")
    for name, done in out["completed"].items():
        check(done > 0, f"agent {name!r} completed no request on the {label} fleet")

    t0 = time.perf_counter()
    twin = build_engine("adaptive", reduced=True, fleet=fleet, budget_tokens=budget_tokens,
                        max_len=max_len, batch_slots=4, device="cpu")
    for tick in range(ticks):
        submit_tick(twin, schedule[tick])
        twin.step()
    same = same_schedule(eng, twin)
    emit({"phase": f"{label}_schedule", "same_as_cpu": same,
          "cpu_twin_s": time.perf_counter() - t0, "metrics_cpu": _finite(twin.metrics())})
    check(all(same.values()), f"{label}: the card and the CPU schedule differently: {same}")
    return out["launches"]


# Cut from 8 to keep the script's time (the train phase's); at 6 ticks every
# agent of both fleets still completes requests (at 4 the vision agent
# completes none).
TWIN_FLEET_TICKS = 6


def phase_table_i_engine() -> dict:
    """The paper's Table I fleet (``DEFAULT_FLEET``) at published widths, with
    mixtral-8x7b cut in depth to fit the card (``FULL_WIDTH_CUT``)."""
    from repro_torch.launch.serve import DEFAULT_FLEET, FULL_WIDTH_CUT

    return phase_fleet_with_twin(DEFAULT_FLEET, "table_i", num_layers=FULL_WIDTH_CUT,
                                 ticks=TWIN_FLEET_TICKS)


def phase_hybrid_engine() -> dict:
    """The hybrid fleet (``hybrid_fleet``): recurrentgemma-9b at all 38
    layers beside the Table I fleet's qwen2-vl-2b and granite-8b, ~39 GB of
    weights, no depth cut."""
    return phase_fleet_with_twin(hybrid_fleet(), "hybrid", ticks=TWIN_FLEET_TICKS)


# ---------------------------------------------------------------------------
# Phase 6: the serverless layers (the simulator's Table II, the engine)
# ---------------------------------------------------------------------------

def _simulate_on_card(policy, arrivals, fleet, config, **layers):
    """One ``simulate`` on the card with its step loop under sync debug mode
    "error" (any host sync inside the loop raises); returns the trace and
    the wall time of the loop up to the device's last kernel."""
    from repro_torch.core import simulator

    args = simulator.simulate_inputs(policy, arrivals, fleet, config, device=DEVICE, **layers)
    torch.cuda.synchronize()
    t = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        trace = simulator.simulate_core(**args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return trace, time.perf_counter() - t


def _trace_gap(card, cpu) -> float:
    """Largest distance of the card's trace from the CPU's, in units of the
    tolerance rtol 1e-5 with an atol of 1e-5 of each field's largest
    magnitude (the form of tests/test_failures.py's 5e-3 tolerance: a
    float32 difference of operands carries their rounding, not the
    result's); at most 1 means within.  The two devices sum small vectors
    in different orders, so last-bit differences start at step 0."""
    worst = 0.0
    for field, want in cpu.fields().items():
        got, want = card.fields()[field].cpu().double(), want.double()
        atol = 1e-5 * max(float(want.abs().max()), 1.0)
        worst = max(worst, float(((got - want).abs() / (atol + 1e-5 * want.abs())).max()))
    return worst


ORACLE_FIELDS = ("allocation", "served", "queue", "latency", "completed", "warm", "pending")
ORACLE_FAILURE_FIELDS = ("dropped", "retried", "expired", "recovery")


def _oracle_gap(card, oracle: dict, failing: bool, slack: dict | None = None) -> tuple:
    """Largest distance of a card trace from the numpy oracle, in units of
    the reference's tolerance (tests/test_reference_sim.py: rtol 2e-4, atol
    2e-3, the queue's atol 0.5; with failures tests/test_failures.py's rtol
    5e-3, atol 5e-3 of the field's largest magnitude), widened elementwise
    by ``slack``; at most 1 means within.  And the field it is in."""
    worst, where = 0.0, ""
    for field in ORACLE_FIELDS + (ORACLE_FAILURE_FIELDS if failing else ()):
        got = card.fields()[field].cpu().double().numpy()
        want = oracle[field]
        if failing:
            tol = 5e-3 * max(np.abs(want).max(), 1.0) + 5e-3 * np.abs(want)
        else:
            tol = (0.5 if field == "queue" else 2e-3) + 2e-4 * np.abs(want)
        gap = np.abs(got - want)
        if slack is not None:
            gap = np.maximum(gap - slack[field], 0.0)
        g = float((gap / tol).max())
        if g > worst:
            worst, where = g, field
    return worst, where


# Where the float32 simulators (JAX's and the port's CPU trace alike) leave
# the float64 oracle at the Table II inputs with all three layers on.
TABLE2_ORACLE_GAPS = {("all", "round_robin")}


def table2_oracle(arr, fleet, config, cards: dict) -> None:
    """The card's ``simulate`` trace against the port's float64 numpy oracle
    (``core/reference_sim.py::simulate_numpy``) at the Table II fleet and the
    paper's constant arrivals, every policy, with no layer (``cards``, the
    Table II traces) and with all three layers on (tests/test_torch_simulator.py's
    ``"all"``: a coordinator star, a reactive pool with a 3 s cold start,
    ``failure_scenario_library(seed=2)[-1]``, 8 GPUs).  Where the JAX package's
    own trace leaves the oracle (``REFERENCE_ORACLE_GAPS``: all layers under
    objective_descent), the card is held within the CPU trace's own distance
    from the oracle (the CPU trace stands for JAX's; the tests hold them
    together).  One ``table2_oracle`` line per policy and setting.

    At these inputs that set is not the tests' one (all layers under
    objective_descent, at their Poisson arrivals) but all layers under
    round_robin: there the recovery indicator, a comparison of two queue
    totals of ~220 that agree to 3e-5, reads 0 at steps 86 and 94 in JAX's
    float32 trace and the port's CPU trace, and 1 in the float64 oracle
    (``TABLE2_ORACLE_GAPS``)."""
    from repro_torch.core import allocator as alloc, capacity, failures, routing, simulator
    from repro_torch.core.reference_sim import simulate_numpy

    all_layers = {"workflow": routing.coordinator_star(4),
                  "capacity": capacity.capacity_config("reactive", cold_start_s=3.0,
                                                       min_instances=1.0),
                  "failures": failures.failure_scenario_library(seed=2)[-1]}
    elastic = simulator.SimConfig(num_gpus=8.0)
    for policy in alloc.policy_names():
        for setting, layers, cfg in (("none", {}, config), ("all", all_layers, elastic)):
            card = cards[policy] if setting == "none" else _simulate_on_card(
                policy, arr, fleet, cfg, **layers)[0]
            t = time.perf_counter()
            oracle = simulate_numpy(policy, arr, fleet, num_gpus=cfg.num_gpus, **layers)
            oracle_s = time.perf_counter() - t
            failing = "failures" in layers
            slack = None
            if (setting, policy) in TABLE2_ORACLE_GAPS:
                cpu = simulator.simulate(policy, arr, fleet, cfg, device="cpu", **layers)
                slack = {f: np.abs(cpu.fields()[f].double().numpy() - oracle[f])
                         for f in ORACLE_FIELDS + ORACLE_FAILURE_FIELDS}
            gap, where = _oracle_gap(card, oracle, failing, slack)
            emit({"phase": "table2_oracle", "policy": policy, "layers": setting,
                  "steps": arr.shape[0], "gap": gap, "worst_field": where,
                  "slack": slack is not None, "oracle_s": oracle_s})
            check(gap <= 1.0, f"table2_oracle {setting}/{policy}: the card's trace is {gap} "
                  f"tolerances from the numpy oracle ({where})")


def phase_table2() -> dict:
    """Table II on the card: every registered policy through the port's
    ``simulate`` on ``paper_fleet()`` and the paper's constant workload;
    the anchors, rounded as ``benchmarks/table2_metrics.py`` rounds them;
    each trace against the port's CPU trace; then once with all three
    serverless layers on (a coordinator star, a reactive pool with a 3 s
    cold start, the ``chaos`` scenario), and once with capacity and
    failures on, where the card's run must conserve queue mass.  Returns each
    policy's wall time of one ``simulate`` (the median of three)."""
    from repro_torch.core import agents, allocator as alloc, capacity, failures, routing
    from repro_torch.core import simulator, workload

    fleet = agents.paper_fleet()
    arr = workload.constant(agents.PAPER_ARRIVAL_RATES, 100)
    config = simulator.SimConfig()
    rows, walls, cards = {}, {}, {}
    for policy in alloc.policy_names():
        _simulate_on_card(policy, arr, fleet, config)  # first run: lazy loads, not timed
        runs = [_simulate_on_card(policy, arr, fleet, config) for _ in range(3)]
        trace, wall = runs[0][0], statistics.median(r[1] for r in runs)
        walls[policy], cards[policy] = wall, trace
        cpu = simulator.simulate(policy, arr, fleet, config, device="cpu")
        s = simulator.summarize(policy, trace, config, fleet.active)
        rows[policy] = s
        gap = _trace_gap(trace, cpu)
        emit({"phase": "table2", "policy": policy, "avg_latency": s.avg_latency,
              "latency_std": s.latency_std, "total_throughput": s.total_throughput,
              "cost": s.cost, "simulate_s": wall, "steps": arr.shape[0],
              "trace_gap_vs_cpu": gap})
        check(gap <= 1.0, f"table2 {policy}: the card's trace is {gap} tolerances from the CPU's")
    check(round(rows["static_equal"].avg_latency, 1) == 110.3, "table2: static_equal latency")
    check(round(rows["adaptive"].avg_latency, 1) == 111.9, "table2: adaptive latency")
    check(round(rows["adaptive"].total_throughput, 2) == 58.12, "table2: adaptive throughput")
    check(abs(round(rows["round_robin"].avg_latency, 1) - 756.1) <= 1.0,
          "table2: round_robin latency")
    check(all(round(r.cost, 3) == 0.020 for r in rows.values()), "table2: cost")

    elastic = simulator.SimConfig(num_gpus=8.0)
    chaos = failures.failure_scenario_library()[-1]
    reactive = capacity.capacity_config("reactive", cold_start_s=3.0, min_instances=1.0)
    layers = {"workflow": routing.coordinator_star(4), "capacity": reactive, "failures": chaos}
    for policy in alloc.policy_names():
        trace, wall = _simulate_on_card(policy, arr, fleet, elastic, **layers)
        gap = _trace_gap(trace, simulator.simulate(policy, arr, fleet, elastic, device="cpu",
                                                   **layers))
        s = simulator.summarize(policy, trace, elastic, fleet.active, layers["workflow"])
        emit({"phase": "table2_serverless", "policy": policy, "avg_latency": s.avg_latency,
              "sink_throughput": s.sink_throughput, "cost": s.cost,
              "mean_warm_instances": s.mean_warm_instances, "dropped": s.dropped,
              "slo_violations": s.slo_violations, "simulate_s": wall,
              "trace_gap_vs_cpu": gap})
        check(gap <= 1.0, f"table2 all layers {policy}: {gap} tolerances from the CPU's trace")

    table2_oracle(arr, fleet, config, cards)

    trace, _ = _simulate_on_card("adaptive", arr, fleet, elastic, capacity=reactive,
                                 failures=chaos)
    arrived, served = float(trace.arrivals.sum()), float(trace.served.sum())
    dropped, final_q = float(trace.dropped.sum()), float(trace.queue[-1].sum())
    slack = arr.shape[0] * fleet.num_agents * 1e-4 + 0.05  # tests/test_failures.py
    emit({"phase": "table2_conservation", "arrived": arrived, "served": served,
          "dropped": dropped, "final_queue": final_q,
          "imbalance": arrived - served - dropped - final_q, "slack": slack})
    check(dropped > 0, "table2: the chaos scenario dropped nothing")
    check(abs(arrived - served - dropped - final_q) <= slack + 1e-3 * arrived,
          "table2: queue mass is not conserved on the card")
    return walls


# ---------------------------------------------------------------------------
# Phase 6b: the streaming sweep grids
# ---------------------------------------------------------------------------

SWEEP_FLEET_SIZES = (4, 8, 16, 64, 256)   # benchmarks/fleet_scaling.py
# The grids' horizons, cut to keep the script's time (the train phase's):
# the fleet-scaling grid from 50 steps to 25, the chaos, workflow and
# capacity grids from the scenario library's 100 steps to 50.  The Table II
# grid keeps its 100 steps (its anchors are 100-step numbers).
SWEEP_FLEET_STEPS = 25
SWEEP_AXIS_STEPS = 50
# Every cell of a lead-axis grid is held to the card's trace oracle at this
# horizon (the oracle runs one simulate per cell), and the lead rows of
# SWEEP_LEAD_ROWS at the grid's own horizon; the grids themselves and the
# CPU comparisons run at full length.
SWEEP_ORACLE_STEPS = 5   # cut from 10 to keep the script's time (the train phase's)
SWEEP_LEAD_ROWS = {"chaos": ("chaos",), "fleets": ("fleet4_n256",),
                   "workflows": ("synthetic_s0",), "capacity": ("reactive_cold", "scale_to_zero")}
# The frontier: the reference benchmark's is 10^4 steps at N = 1024; here the
# horizon is cut to what fits SWEEP_FRONTIER_S of loop time on this card, at
# the Table II grid's measured rate (the same 72 cells a step).
SWEEP_FRONTIER_N = 1024
SWEEP_FRONTIER_STEPS = 10_000
SWEEP_FRONTIER_S = 3.0    # cut from 20 s, then 5 s, to keep the script's time
SWEEP_FRONTIER_BLOCK = 64
SWEEP_BLOCKS = (1, 8, 64)


def _sweep_module():
    import importlib

    return importlib.import_module("repro_torch.core.sweep")


class _StreamClock:
    """Runs the sweep module's stream with its step loop under sync debug
    mode "error" (a host sync inside raises) and keeps each run's wall time
    up to the device's last kernel.  The grid's inputs reach the card
    before the stream starts."""

    def __init__(self):
        self.sw = _sweep_module()
        self.walls = []

    def __enter__(self):
        inner = self.orig = self.sw.simulate_stream_core

        def clocked(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = inner(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            self.walls.append(time.perf_counter() - t)
            return out

        self.sw.simulate_stream_core = clocked
        return self

    def __exit__(self, *exc):
        self.sw.simulate_stream_core = self.orig


def _grid_where(res, field, idx) -> str:
    """A readable name of one entry of a sweep's grid."""
    from repro_torch.core.simulator import METRIC_NAMES

    lead = res._leading_axis()
    parts = [] if lead is None else [lead[1][idx[0]]]
    idx = idx if lead is None else idx[1:]
    parts += [res.policy_names[idx[0]], res.scenario_names[idx[1]]]
    parts.append(METRIC_NAMES[idx[2]] if field == "metrics" else f"{field}[{idx[2]}]")
    return "/".join(parts)


def _grid_gap(got, want) -> tuple[float, str]:
    """Largest distance of one sweep's grids from another's, in units of
    the phase-6 tolerance: rtol 1e-5 with an atol of 1e-5 of the largest
    magnitude of each metric column (and of each per-agent grid); and
    where it is."""
    worst, where = 0.0, ""
    for field in ("metrics", "per_agent_latency", "per_agent_throughput", "per_agent_queue"):
        g = np.asarray(getattr(got, field), np.float64)
        w = np.asarray(getattr(want, field), np.float64)
        check(g.shape == w.shape, f"sweep {field}: shape {g.shape} vs {w.shape}")
        check(np.isfinite(g).all(), f"sweep {field}: non-finite values")
        axes = tuple(range(w.ndim - 1)) if field == "metrics" else None
        atol = 1e-5 * np.maximum(np.abs(w).max(axis=axes), 1.0)
        gap = np.abs(g - w) / (atol + 1e-5 * np.abs(w))
        if gap.max() > worst:
            worst = float(gap.max())
            idx = np.unravel_index(gap.argmax(), gap.shape)
            where = (f"{_grid_where(want, field, idx)}: {g[idx]!r} vs {w[idx]!r}")
    return worst, where


def _lead_rows(res, names):
    """The rows ``names`` of a sweep's leading axis, as a result of their own."""
    axis, lead = res._leading_axis()
    rows = [lead.index(n) for n in names]
    pick = lambda a: None if a is None else a[rows]
    return dataclasses.replace(
        res, metrics=pick(res.metrics), per_agent_latency=pick(res.per_agent_latency),
        per_agent_throughput=pick(res.per_agent_throughput),
        per_agent_queue=pick(res.per_agent_queue), **{f"{axis}_names": tuple(names)})


def _timed(fn):
    """``fn()`` and its wall time up to the device's last kernel."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def phase_sweep() -> dict:
    """The four grids on the card through the port's entry points, each
    stream's step loop under sync debug mode "error": the Table II grid
    (``sweep`` over ``scenario_library(PAPER_ARRIVAL_RATES, 100)``, the whole
    registry, 72 cells), the same with the chaos axis
    (``failure_scenario_library()``), ``sweep_fleets`` over
    ``synthetic_fleet(n, seed=n)`` for n in SWEEP_FLEET_SIZES at SWEEP_FLEET_STEPS,
    and ``sweep_workflows`` and ``sweep_capacity`` on the paper fleet.
    Checks the Table II anchors in the constant column, every cell against
    the CPU's stream and against the card's trace oracle (the lead-axis
    grids' cells at SWEEP_ORACLE_STEPS, and their SWEEP_LEAD_ROWS at the
    grid's own horizon), timing each oracle run, that every block
    size of SWEEP_BLOCKS gives the same metrics on a synthesized grid with
    capacity and failures on, that the card's synthesized arrivals are the
    CPU's bits, and runs the N = 1024 frontier in the loop-synthesis mode at
    the longest horizon that fits SWEEP_FRONTIER_S.  Returns the Table II
    stream's wall time for ``profile_sweep``."""
    from repro_torch.core import agents, allocator as alloc, capacity, failures, workload
    from repro_torch.core.simulator import SimConfig

    sw = _sweep_module()
    t_phase = time.perf_counter()
    fleet = agents.paper_fleet()
    rates = agents.PAPER_ARRIVAL_RATES
    lib = sw.scenario_library(rates, 100)
    lib_axis = sw.scenario_library(rates, SWEEP_AXIS_STEPS)
    lib_short = sw.scenario_library(rates, SWEEP_ORACLE_STEPS)
    chaos_lib = failures.failure_scenario_library()
    elastic = SimConfig(num_gpus=8.0)
    fleets = [agents.synthetic_fleet(n, seed=n) for n in SWEEP_FLEET_SIZES]
    p = len(alloc.policy_names())
    n_big = SWEEP_FLEET_SIZES[-1]
    lead_oracles = {  # each grid's SWEEP_LEAD_ROWS alone, at the grid's horizon
        "chaos": lambda **k: sw.sweep(fleet, lib_axis, failures=chaos_lib[-1:], **k),
        "fleets": lambda **k: sw.sweep_fleets(
            fleets[-1:], rate_vectors=[workload.synthetic_rates(n_big, seed=len(fleets) - 1)],
            fleet_names=SWEEP_LEAD_ROWS["fleets"], num_steps=SWEEP_FLEET_STEPS, **k),
        "workflows": lambda **k: sw.sweep_workflows(
            fleet, workflows=sw.workflow_scenario_library(fleet.num_agents)[-1:],
            num_steps=SWEEP_AXIS_STEPS, **k),
        "capacity": lambda **k: sw.sweep_capacity(
            fleet, capacities=sw.capacity_scenario_library()[2:], config=elastic,
            num_steps=SWEEP_AXIS_STEPS, **k),
    }
    grids = {
        "table2": (lambda s, **k: sw.sweep(fleet, lib if s is None else s, **k), 100, 8),
        "chaos": (lambda s, **k: sw.sweep(fleet, lib_axis if s is None else s,
                                          failures=chaos_lib, **k),
                  SWEEP_AXIS_STEPS, 8 * len(chaos_lib)),
        "fleets": (lambda s, **k: sw.sweep_fleets(
            fleets, num_steps=SWEEP_FLEET_STEPS if s is None else SWEEP_ORACLE_STEPS, **k),
            SWEEP_FLEET_STEPS, 8 * len(fleets)),
        "workflows": (lambda s, **k: sw.sweep_workflows(
            fleet, num_steps=SWEEP_AXIS_STEPS if s is None else SWEEP_ORACLE_STEPS, **k),
            SWEEP_AXIS_STEPS, 8 * 5),
        "capacity": (lambda s, **k: sw.sweep_capacity(
            fleet, config=elastic,
            num_steps=SWEEP_AXIS_STEPS if s is None else SWEEP_ORACLE_STEPS, **k),
            SWEEP_AXIS_STEPS, 8 * 4),
    }
    walls = {}
    with _StreamClock() as clock:
        sw.sweep(fleet, lib_short, device=DEVICE)  # first run: lazy loads, not timed
        for name, (run, steps, cols) in grids.items():
            card = run(None, device=DEVICE)
            wall = clock.walls[-1]
            cpu = run(None, device="cpu")
            short = None if name == "table2" else lib_short
            card_short = card if short is None else run(short, device=DEVICE)
            oracle, oracle_s = _timed(lambda: run(short, device=DEVICE, stream=False))
            (gap_cpu, at_cpu), (gap_oracle, at_oracle) = (_grid_gap(card, cpu),
                                                          _grid_gap(card_short, oracle))
            cells = cols * p
            walls[name] = wall
            line = {"phase": "sweep", "grid": name, "shape": list(card.metrics.shape),
                    "cells": cells, "steps": steps, "loop_s": wall,
                    "host_ms_per_step": wall / steps * 1e3,
                    "us_per_step_per_cell": wall / steps / cells * 1e6,
                    "gap_vs_cpu": gap_cpu, "worst_vs_cpu": at_cpu, "gap_vs_oracle": gap_oracle,
                    "worst_vs_oracle": at_oracle,
                    "oracle_steps": steps if short is None else SWEEP_ORACLE_STEPS,
                    "oracle_s": oracle_s}
            if name in lead_oracles:
                rows = SWEEP_LEAD_ROWS[name]
                full, lead_s = _timed(lambda: lead_oracles[name](device=DEVICE, stream=False))
                check(full._leading_axis()[1] == rows, f"sweep {name}: lead rows {rows}")
                gap_lead, at_lead = _grid_gap(_lead_rows(card, rows), full)
                line.update({"lead_rows": list(rows), "lead_oracle_steps": steps,
                             "lead_oracle_s": lead_s, "gap_lead_vs_oracle": gap_lead,
                             "worst_lead_vs_oracle": at_lead})
                check(gap_lead <= 1.0, f"sweep {name}: the stream's rows {rows} are "
                      f"{gap_lead} tolerances from the trace oracle at {steps} steps")
            emit(line)
            check(gap_cpu <= 1.0, f"sweep {name}: the card is {gap_cpu} tolerances from the CPU")
            check(gap_oracle <= 1.0,
                  f"sweep {name}: the stream is {gap_oracle} tolerances from the trace oracle")
            if name == "table2":
                s = {pol: card.summary(pol, "constant") for pol in card.policy_names}
                emit({"phase": "sweep_table2", **{pol: [r.avg_latency, r.total_throughput,
                                                        r.cost] for pol, r in s.items()}})
                check(round(s["static_equal"].avg_latency, 1) == 110.3,
                      "sweep table2: static_equal latency")
                check(round(s["adaptive"].avg_latency, 1) == 111.9, "sweep table2: adaptive latency")
                check(round(s["adaptive"].total_throughput, 2) == 58.12,
                      "sweep table2: adaptive throughput")
                check(abs(round(s["round_robin"].avg_latency, 1) - 756.1) <= 1.0,
                      "sweep table2: round_robin latency")
                check(all(round(r.cost, 3) == 0.020 for r in s.values()), "sweep table2: cost")

        # Every block size, on a synthesized grid with capacity and failures on.
        specs = workload.scenario_specs(workload.synthetic_rates(4, seed=0), 100, 0)
        reactive = capacity.capacity_config("reactive", cold_start_s=3.0, min_instances=1.0)
        by_block = {b: sw.sweep(fleet, specs, config=elastic, capacity=reactive,
                                failures=chaos_lib[-1], block_size=b, device=DEVICE)
                    for b in SWEEP_BLOCKS}
        same = all(np.array_equal(by_block[b].metrics, by_block[1].metrics)
                   and np.array_equal(by_block[b].per_agent_queue, by_block[1].per_agent_queue)
                   for b in SWEEP_BLOCKS)
        synth_cpu = sw.sweep(fleet, specs, config=elastic, capacity=reactive,
                             failures=chaos_lib[-1], block_size=8, device="cpu")
        gap_synth, at_synth = _grid_gap(by_block[8], synth_cpu)
        stacked = workload.stack_specs(specs)
        rows_card = workload.Synth(stacked, DEVICE).block(
            workload.Synth(stacked, DEVICE).init(), 0, 100)[0].cpu()
        rows_cpu = workload.Synth(stacked, "cpu").block(
            workload.Synth(stacked, "cpu").init(), 0, 100)[0]
        bits = torch.equal(rows_card.view(torch.int32), rows_cpu.view(torch.int32))
        emit({"phase": "sweep_blocks", "blocks": list(SWEEP_BLOCKS), "identical": same,
              "gap_vs_cpu": gap_synth, "worst_vs_cpu": at_synth, "synth_bits_equal_cpu": bits,
              "loop_s": {b: clock.walls[-len(SWEEP_BLOCKS) - 1 + i]
                         for i, b in enumerate(SWEEP_BLOCKS)}})
        check(same, "sweep: block sizes gave different metrics")
        check(gap_synth <= 1.0, f"sweep synthesized: {gap_synth} tolerances from the CPU")
        check(bits, "sweep: synthesized arrivals on the card are not the CPU's bits")

        # The frontier: the longest horizon that fits at the Table II grid's rate.
        big = [agents.synthetic_fleet(SWEEP_FRONTIER_N, seed=SWEEP_FRONTIER_N)]
        per_step = walls["table2"] / 100
        steps = min(SWEEP_FRONTIER_STEPS, max(SWEEP_FRONTIER_BLOCK, int(
            SWEEP_FRONTIER_S / per_step) // SWEEP_FRONTIER_BLOCK * SWEEP_FRONTIER_BLOCK))
        res = sw.sweep_fleets(big, num_steps=steps, synthesize=True,
                              block_size=SWEEP_FRONTIER_BLOCK, device=DEVICE)
        wall = clock.walls[-1]
        finite = bool(np.isfinite(res.metrics).all())
        emit({"phase": "sweep_frontier", "agents": SWEEP_FRONTIER_N, "steps": steps,
              "reference_steps": SWEEP_FRONTIER_STEPS, "cut": steps < SWEEP_FRONTIER_STEPS,
              "block": SWEEP_FRONTIER_BLOCK, "shape": list(res.metrics.shape), "loop_s": wall,
              "host_ms_per_step": wall / steps * 1e3,
              "us_per_step_per_cell": wall / steps / (8 * p) * 1e6,
              "adaptive_constant_latency": float(res.summary(
                  "adaptive", "constant", fleet=res.fleet_names[0]).avg_latency),
              "finite": finite})
        check(finite, "sweep frontier: non-finite metrics")
    emit({"phase": "sweep_total", "s": time.perf_counter() - t_phase})
    return walls


MESH_STEPS = 12                        # tests/test_sharding.py's grids
MESH_POLICIES = ("static_equal", "adaptive", "water_filling")
MESH_ODD_FLEETS = (2, 3, 4, 5, 3)      # non-divisible on purpose
MESH_BLOCKS = (2, 2, 2)                # the mesh 8 ranks build under shard="3d"


def _mesh_grids(sw, shard) -> dict:
    """The four entry points' grids at ``tests/test_sharding.py``'s sizes,
    each with the wall time of its streams (``_StreamClock``)."""
    from repro_torch.core import agents, workload

    fleet = agents.synthetic_fleet(4, seed=0)
    lib = sw.scenario_library(workload.synthetic_rates(4, seed=0), num_steps=MESH_STEPS)
    odd = [agents.synthetic_fleet(n, seed=i) for i, n in enumerate(MESH_ODD_FLEETS)]
    kw = dict(policies=MESH_POLICIES, shard=shard, device=DEVICE)
    calls = {"sweep": lambda: sw.sweep(fleet, lib, **kw),
             "fleets": lambda: sw.sweep_fleets(odd, num_steps=MESH_STEPS, seed=0, **kw),
             "workflows": lambda: sw.sweep_workflows(fleet, num_steps=MESH_STEPS, **kw),
             "capacity": lambda: sw.sweep_capacity(fleet, num_steps=MESH_STEPS, **kw)}
    out = {}
    with _StreamClock() as clock:
        for name, call in calls.items():
            before = len(clock.walls)
            res, wall = _timed(call)
            out[name] = (res, sum(clock.walls[before:]), wall, len(clock.walls) - before)
    return out


def _bits_equal(a, b) -> bool:
    return all(np.array_equal(getattr(a, f), getattr(b, f)) for f in (
        "metrics", "per_agent_latency", "per_agent_throughput", "per_agent_queue"))


def phase_sweep_mesh() -> None:
    """The sweep mesh of ``core/sharding.py`` on the card.  ``sweep_blocks``:
    the four entry points' grids (tests/test_sharding.py's sizes: 12 steps,
    five fleets of 2–5 agents, three policies) as the 8 per-rank blocks of a
    (2, 2, 2) mesh run one after another in this process and assembled,
    held to the unsharded grids bit for bit; and ``simulate_stream_core`` in
    3 policy blocks held to the unblocked stream bit for bit.
    ``sweep_nccl``: the sharded runner over an explicit (1, 1, 1) mesh of a
    one-rank NCCL group, so that its gather runs on the card, held to
    ``shard=False`` bit for bit; the group is destroyed after."""
    import torch.distributed as dist

    from repro_torch.core import agents, allocator as alloc, sharding, simulator

    sw = _sweep_module()
    _mesh_grids(sw, False)  # first run: lazy loads, not timed
    plain = _mesh_grids(sw, False)
    blocked = _mesh_grids(sw, MESH_BLOCKS)
    for name, (res, loop_s, wall, streams) in blocked.items():
        want, plain_loop_s, plain_wall, _ = plain[name]
        same = _bits_equal(res, want)
        emit({"phase": "sweep_blocks", "mesh": list(MESH_BLOCKS), "grid": name,
              "shape": list(res.metrics.shape), "identical": same, "streams": streams,
              "loop_s": loop_s, "wall_s": wall, "unsharded_loop_s": plain_loop_s,
              "unsharded_wall_s": plain_wall})
        check(same, f"sweep_blocks {name}: the (2, 2, 2) blocks differ from the unsharded grid")

    arr = torch.from_numpy(np.random.default_rng(7).poisson(
        agents.PAPER_ARRIVAL_RATES, (MESH_STEPS * 4, 4)).astype(np.float32)).to(DEVICE)
    fleet = agents.paper_fleet().to(DEVICE)
    names = alloc.policy_names()
    whole, whole_s = _timed(lambda: simulator.simulate_stream_core(
        arr, fleet, simulator.SimConfig(), names))
    parts, parts_s = [], 0.0
    for k in range(3):
        part, s = _timed(lambda k=k: simulator.simulate_stream_core(
            arr, fleet, simulator.SimConfig(), names, num_policy_blocks=3, policy_block=k))
        parts.append(part)
        parts_s += s
    same = all(torch.equal(torch.cat([pt[i] for pt in parts]), whole[i]) for i in range(4))
    emit({"phase": "sweep_blocks", "policy_blocks": 3, "policies": len(names),
          "steps": arr.shape[0], "identical": same, "blocks_s": parts_s, "whole_s": whole_s})
    check(same, "sweep_blocks: the 3 policy blocks differ from the unblocked stream")

    port = sharding.free_port()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    try:
        mesh = sharding.grid_mesh(num_devices=1, device_type="cuda")
        check(sharding.mesh_dims(mesh) == (1, 1, 1), f"sweep_nccl: mesh {mesh}")
        gathered = _mesh_grids(sw, mesh)
        for name, (res, loop_s, wall, _) in gathered.items():
            want = plain[name][0]
            same = _bits_equal(res, want)
            emit({"phase": "sweep_nccl", "mesh": [1, 1, 1], "grid": name,
                  "backend": dist.get_backend(), "identical": same, "loop_s": loop_s,
                  "wall_s": wall, "unsharded_wall_s": plain[name][2]})
            check(same, f"sweep_nccl {name}: the gathered grid differs from shard=False")
    finally:
        dist.destroy_process_group()
    check(not dist.is_initialized(), "sweep_nccl: the process group outlived the phase")


def profile_sweep(host_s: float) -> None:
    """Device kernels per stream step and the device's busy share of the
    Table II grid's stream (72 cells, 100 steps): ``host_s`` is its loop
    time from ``phase_sweep``, taken before the profiler attached; the
    device time comes from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import agents

    sw = _sweep_module()
    fleet = agents.paper_fleet()
    lib = sw.scenario_library(agents.PAPER_ARRIVAL_RATES, 100)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sw.sweep(fleet, lib, device=DEVICE, return_arrays=True)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_s = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    steps, cells = 100, 72
    emit({"phase": "sweep_profile", "grid": "table2", "cells": cells, "steps": steps,
          "host_s": host_s, "host_ms_per_step": host_s / steps * 1e3,
          "us_per_step_per_cell": host_s / steps / cells * 1e6,
          "device_ms_per_step": device_s / steps * 1e3, "busy_share": device_s / host_s,
          "device_kernels_per_step": len(kernels) / steps})
    check(kernels, "the profiler saw no device kernel in a sweep")


def profile_simulator(host_s: float, policy: str = "adaptive") -> None:
    """Device kernels per simulated step and the device's busy share of a
    Table II ``simulate`` on the card: ``host_s`` is its wall time taken by
    ``phase_table2`` before the profiler attached (the profiler slows every
    later launch on the host), the device time comes from
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import agents, simulator, workload

    fleet = agents.paper_fleet()
    arr = workload.constant(agents.PAPER_ARRIVAL_RATES, 100)
    args = simulator.simulate_inputs(policy, arr, fleet, device=DEVICE)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        simulator.simulate_core(**args)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_s = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    steps = arr.shape[0]
    emit({"phase": "simulator_profile", "policy": policy, "steps": steps,
          "host_s": host_s, "host_ms_per_step": host_s / steps * 1e3,
          "device_ms_per_step": device_s / steps * 1e3, "busy_share": device_s / host_s,
          "device_kernels_per_step": len(kernels) / steps})
    check(kernels, "the profiler saw no device kernel in a simulate")


# The serverless engine: a coordinator star whose every finished
# coordinator request spawns one child at each specialist, a reactive pool
# of up to 2 instances with a 2-tick cold start, and failures (a revocation
# chain, a scheduled outage of agent 2 in ticks 3-4, deadlines of 4 ticks
# with one retry).  SERVERLESS_SEED is the failure seed, chosen so that the
# revocation chain turns on within the 8 ticks.
SERVERLESS_SEED = 0


def serverless_engine(reduced: bool, device, budget_tokens: int = 1024, max_len: int = 1024):
    """The dense fleet (``build_engine``'s runtimes) under a ``FleetEngine``
    with all three serverless layers on; ``budget_tokens`` is per instance."""
    from repro_torch.core import capacity, failures, routing
    from repro_torch.launch.serve import DENSE_FLEET, build_engine
    from repro_torch.serving.engine import FleetEngine

    base = build_engine("adaptive", reduced=reduced, fleet=DENSE_FLEET,
                        budget_tokens=budget_tokens, max_len=max_len, batch_slots=4,
                        device=device)
    return FleetEngine(
        base.fleet, {rt.name: rt for rt in base.runtimes}, policy="adaptive",
        budget_tokens=budget_tokens, g_total=1.0, num_gpus=2.0,
        workflow=routing.coordinator_star(base.fleet.num_agents, fan_out=3.0),
        capacity=capacity.capacity_config("reactive", cold_start_s=2,
                                          target_rate_per_instance=4,
                                          backlog_per_instance=8, min_instances=1),
        failures=failures.failure_spec("smoke", revoke_p_enter=0.2, revoke_p_exit=0.5,
                                       revoke_frac=0.5, outage_start=3, outage_len=2,
                                       outage_agent=2, deadline_s=4, retry_budget=1,
                                       seed=SERVERLESS_SEED),
        device=device,
    )


def check_serverless(hist: list, m: dict, label: str) -> None:
    """What the serverless engine must show, on the card and in its CPU twin."""
    check(m["routed_requests"] > 0 and m["sink_completed"] > 0,
          f"{label}: no routed request reached a sink")
    check(any(h["warm"] > 1.0 for h in hist[2:]), f"{label}: the pool never grew past 1")
    check(any(h["revoked_frac"] > 0 for h in hist), f"{label}: nothing was revoked")
    for t in (3, 4):
        check(hist[t]["down"] >= 1 and hist[t]["decode_tokens"][2] == 0,
              f"{label}: agent 2 ran during its outage (tick {t})")
    check(0 < hist[3]["queues"][2] <= hist[4]["queues"][2],
          f"{label}: agent 2 lost its queue during the outage")


def phase_serverless_engine(ticks: int = 8) -> dict:
    """The full-width dense fleet with routing, the reactive warm pool and
    failures on, then the same engine at reduced widths on the CPU over the
    same arrival schedule: the schedule depends on prompt lengths, token
    counts, budgets, slots and ``max_len``, never on the logits, so every
    scheduling field of the history and ``metrics()`` must be equal."""
    t0 = time.perf_counter()
    eng = serverless_engine(reduced=False, device=DEVICE)
    print(f"serverless engine built in {time.perf_counter() - t0:.1f} s", flush=True)
    schedule = poisson_schedule({"coordinator": 3}, ticks=ticks)
    out = drive(eng, {}, "serverless", ticks=ticks, schedule=schedule)
    for name in ("flash_attention", "decode_attention"):
        check(out["launches"][name] > 0, f"{name} was never launched on the serverless fleet")
    check_serverless(eng.history, eng.metrics(), "serverless")

    t0 = time.perf_counter()
    twin = serverless_engine(reduced=True, device="cpu")
    for tick in range(ticks):
        submit_tick(twin, schedule[tick])
        twin.step()
    same = same_schedule(eng, twin)
    emit({"phase": "serverless_schedule", "same_as_cpu": same,
          "cpu_twin_s": time.perf_counter() - t0, "metrics_cpu": _finite(twin.metrics())})
    check(all(same.values()), f"serverless: the card and the CPU schedule differently: {same}")
    return out["launches"]


# ---------------------------------------------------------------------------
# Phase 6c: training through the kernels
# ---------------------------------------------------------------------------

# Kernels vs plain, step by step: float32, published widths, each model cut
# to 4 layers, batch 2 x seq 1024, 3 steps of the launcher's AdamW.
TRAIN_CMP = ("qwen2-vl-2b", "mamba2-370m", "granite-moe-1b-a400m")
TRAIN_CMP_LAYERS, TRAIN_CMP_BATCH, TRAIN_CMP_SEQ, TRAIN_CMP_STEPS = 4, 2, 1024, 3
TRAIN_LR = 1e-3
# Tolerances of the comparison, float32 on both routes: the kernels and the
# plain versions differ in the order of their sums (logits within ~2e-6 of
# their range, phase 4), so the losses within 1e-4 relative and the global
# norm within 1e-3; the step-1 gradients (same parameters on both routes)
# within TRAIN_GRAD_RTOL of each leaf's max|g|.  Adam's normalised step m/√v
# turns a gradient at rounding level into a step of ±lr whatever its size,
# so the parameters after the last step are held only where the plain
# route's gradient is above rounding level at every step: above
# TRAIN_ROUNDING times its leaf's max|g| (the mask is the plain route's
# alone), or exactly zero at every step (no gradient: both routes only
# decay the weight).  At least TRAIN_MIN_CHECKED of the elements with a
# gradient must be held: on an H100 31% (mamba2-370m), 37% (qwen2-vl-2b)
# and 69% (granite-moe-1b-a400m) are.  TRAIN_PARAM_ATOL, 0.1·lr, is twice
# the largest gap read there with this mask: mamba2-370m's 5.1e-5, whose
# float32 SSD kernel is the least exact (step-1 gradients 4.4e-5 of max|g|
# apart; qwen2-vl-2b 3.0e-6, granite-moe-1b-a400m 4.7e-7).
TRAIN_LOSS_RTOL, TRAIN_NORM_RTOL, TRAIN_GRAD_RTOL = 1e-4, 1e-3, 1e-3
TRAIN_ROUNDING, TRAIN_MIN_CHECKED = 1e-3, 0.25
TRAIN_PARAM_ATOL = 0.1 * TRAIN_LR
# Whole models in bf16: the reference's train_4k length (4096 tokens) at a
# batch cut from its 256 to what one card holds beside the optimizer state.
TRAIN_WHOLE = (("qwen2-vl-2b", 2, 4096), ("mamba2-370m", 4, 4096))
TRAIN_4K_BATCH = 256   # repro/models/model.py INPUT_SHAPES["train_4k"]
TRAIN_STEPS = 20
TRAIN_MIN_DROP = 0.3   # tests/test_models.py::TestTrainingConvergence's yardstick
TRAIN_CKPT_AFTER = 10  # mamba2-370m: save after step 10, resume step 11


def _train_kernel(cfg):
    """The kernel module a model's training forward launches, and its launches
    per step (each layer once in the forward and once in remat's recompute)."""
    from repro_torch.kernels.attention import flash_attention as fa
    from repro_torch.kernels.ssd import ssd_scan
    from repro_torch.models import transformer

    kinds = transformer.layer_kinds(cfg)
    if cfg.arch_type == "ssm":
        return "ssd", ssd_scan, 2 * kinds.count("ssm")
    return "flash_attention", fa, 2 * sum(k.startswith("attn") for k in kinds)


def _train_flops(cfg, batch: int, seq: int, matmul_params: int) -> float:
    """Model flops of one step: 6·N·tokens for the N parameters that enter a
    product (all but the input embedding table), plus causal attention's two
    products, forward (4·H·D per query-key pair) and backward (twice that).
    The SSD scan's own products are not counted."""
    _, _, per_step = _train_kernel(cfg)
    attn_layers = 0 if cfg.arch_type == "ssm" else per_step // 2
    pairs = seq * (seq + 1) // 2
    return (6.0 * matmul_params * batch * seq
            + 12.0 * attn_layers * batch * cfg.num_heads * cfg.head_dim * pairs)


def _train_batch(data, step: int, cfg, seed: int = 0) -> dict:
    """``data``'s batch ``step`` as the launcher puts it on the card, except
    that the vision stub's frontend embeddings are seeded N(0, 0.02²) rows
    (as the reference's ``concrete_inputs`` makes them) and not the
    launcher's zeros: zero rows stay zero through every layer, and each rms
    norm multiplies their gradient by 1/√eps, so at qwen2-vl-2b's 28 layers
    the gradient overflows to NaN in both packages (ROADMAP C)."""
    from repro_torch.launch.train import to_batch

    batch = to_batch(data.batch(step), cfg, DEVICE)
    if cfg.frontend == "vision":
        gen = torch.Generator(device=DEVICE).manual_seed(seed * 100_003 + step)
        fe = batch["frontend_embeds"]
        batch["frontend_embeds"] = (torch.randn(fe.shape, generator=gen, device=DEVICE)
                                    * 0.02).to(fe.dtype)
    return batch


def _clone_tree(tree):
    from repro_torch.models.params import tree_map

    return tree_map(lambda t: t.clone(), tree)


def _loss_grads(api, params, batch, impl):
    """The gradient leaves of ``api.train_loss`` at ``params``."""
    from repro_torch.training.train_step import loss_and_grads

    return loss_and_grads(api, params, batch, impl)[2]


def phase_train_compare(arch: str) -> dict:
    """3 train steps through the kernels (``impl=None``) and 3 through the
    plain versions (``impl="ref"``) from the same float32 parameters; loss,
    ce, aux and grad_norm held at each step, the step-1 gradients, and the
    parameters after the last step where the plain route's gradients are
    not at rounding level."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch.train import opt_config
    from repro_torch.models.model import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train_step import build_train_step

    cfg = dataclasses.replace(get_config(arch), num_layers=TRAIN_CMP_LAYERS)
    api = build_model(cfg)
    params0 = api.init(0, dtype=torch.float32, device=DEVICE)
    data = SyntheticTokens(DataConfig(cfg.vocab_size, TRAIN_CMP_SEQ, TRAIN_CMP_BATCH, 0))
    batches = [_train_batch(data, i, cfg) for i in range(TRAIN_CMP_STEPS)]
    name, module, per_step = _train_kernel(cfg)
    grad_gap = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                   for a, b in zip(_loss_grads(api, params0, batches[0], None),
                                   _loss_grads(api, params0, batches[0], "ref")))
    runs, plain_grads = {}, []
    for impl in (None, "ref"):
        params = _clone_tree(params0)
        state = init_opt_state(params)
        step = build_train_step(api, opt_config(TRAIN_LR, TRAIN_CMP_STEPS), impl=impl)
        metrics = []
        module.launches = 0
        for b in batches:
            if impl == "ref":  # the mask's gradients: no kernel runs on this route
                plain_grads.append(_loss_grads(api, params, b, "ref"))
            params, state, m = step(params, state, b)
            metrics.append({k: float(v) for k, v in m.items()})
        runs[impl] = (params, metrics, module.launches)
    (kp, km, kl), (rp, rm, rl) = runs[None], runs["ref"]
    gaps = {k: max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30) for a, b in zip(km, rm))
            for k in ("loss", "ce", "aux", "grad_norm")}
    held_gap, held_n, no_grad, total = 0.0, 0, 0, 0
    for i, (a, b) in enumerate(zip(tree_leaves(kp), tree_leaves(rp))):
        above = torch.ones_like(a, dtype=torch.bool)
        none = torch.ones_like(a, dtype=torch.bool)
        for g in plain_grads:
            above &= g[i].abs() > TRAIN_ROUNDING * g[i].abs().max()
            none &= g[i] == 0
        held = above | none
        no_grad += int(none.sum())
        held_n += int(above.sum())
        total += a.numel()
        if held.any():
            held_gap = max(held_gap, float((a - b)[held].abs().max()))
    checked = held_n / max(total - no_grad, 1)
    row = {"phase": "train_compare", "arch": arch, "layers": cfg.num_layers,
           "batch": TRAIN_CMP_BATCH, "seq": TRAIN_CMP_SEQ, "dtype": "float32",
           "loss": [(a["loss"], b["loss"]) for a, b in zip(km, rm)],
           "aux": [a["aux"] for a in km], "rel_gap": gaps, "step1_grad_gap": grad_gap,
           "param_gap_held": held_gap, "param_atol": TRAIN_PARAM_ATOL,
           "rounding": TRAIN_ROUNDING, "checked_share_of_graded": checked,
           "min_checked": TRAIN_MIN_CHECKED, "no_gradient_share": no_grad / total,
           "kernel": name, "launches": kl, "launches_plain": rl}
    emit(row)
    check(kl == TRAIN_CMP_STEPS * per_step and rl == 0,
          f"train {arch}: {kl} {name} launches through the kernels, {rl} through the plain "
          f"route; expected {TRAIN_CMP_STEPS * per_step} and 0")
    check(all(gaps[k] <= TRAIN_LOSS_RTOL for k in ("loss", "ce", "aux"))
          and gaps["grad_norm"] <= TRAIN_NORM_RTOL, f"train {arch}: kernels vs plain {gaps}")
    check(grad_gap <= TRAIN_GRAD_RTOL, f"train {arch}: step-1 gradients {grad_gap} apart")
    check(held_n > 0 and checked >= TRAIN_MIN_CHECKED,
          f"train {arch}: only {checked} of the graded elements above rounding level")
    check(held_gap <= TRAIN_PARAM_ATOL, f"train {arch}: parameters {held_gap} apart")
    check(cfg.arch_type != "moe" or min(row["aux"]) > 0, f"train {arch}: no aux loss")
    del params0, runs, kp, rp, plain_grads
    gc.collect()
    torch.cuda.empty_cache()
    return row


def _trees_equal(a, b) -> bool:
    from repro_torch.models.params import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and torch.equal(x, y)
                                      for x, y in zip(la, lb))


def phase_train_whole(arch: str, batch: int, seq: int, gpu: str) -> dict:
    """``TRAIN_STEPS`` steps of a whole model in bf16, as ``launch/train.py``
    trains it, on ``SyntheticTokens`` at the model's vocabulary; one line per
    step.  The loss must stay finite and drop by ``TRAIN_MIN_DROP``.  On
    mamba2-370m also the checkpoint: saved after step ``TRAIN_CKPT_AFTER``,
    restored into a freshly built tree, and step 11 taken from both must give
    the same parameters and optimizer state bit for bit."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch import mesh
    from repro_torch.launch.train import opt_config
    from repro_torch.models.model import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train_step import build_train_step

    cfg = get_config(arch)
    api = build_model(cfg)
    print(f"train: {arch} whole ({cfg.num_layers} layers), bf16, batch {batch} x seq {seq} "
          f"(batch cut from train_4k's {TRAIN_4K_BATCH}), {TRAIN_STEPS} steps", flush=True)
    params = api.init(0, dtype=torch.bfloat16, device=DEVICE)
    state = init_opt_state(params)
    n_params = sum(p.numel() for p in tree_leaves(params))
    flops = _train_flops(cfg, batch, seq, n_params - params["embed"]["embedding"].numel())
    rates = mesh.hw(gpu)["peak_flops"]
    step = build_train_step(api, opt_config(TRAIN_LR, TRAIN_STEPS))
    data = SyntheticTokens(DataConfig(cfg.vocab_size, seq, batch, 0))
    name, module, per_step = _train_kernel(cfg)
    do_ckpt = cfg.arch_type == "ssm"
    path = ROOT / "build" / "train_ckpt.npz"
    rows, resumed = [], None
    for i in range(TRAIN_STEPS):
        b = _train_batch(data, i, cfg)  # set-up: the host makes the batch
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        module.launches = 0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        params, state, m = step(params, state, b)
        end.record()
        torch.cuda.synchronize()
        s = time.perf_counter() - t
        row = {"phase": "train_step", "arch": arch, "step": i + 1,
               **{k: float(v) for k, v in m.items()}, "s": s,
               "device_ms": start.elapsed_time(end), "tokens_per_s": batch * seq / s,
               "launches": module.launches, "kernel": name,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "mfu": flops / s / rates[torch.bfloat16]}
        emit(row)
        rows.append(row)
        check(row["launches"] == per_step,
              f"train {arch} step {i + 1}: {row['launches']} {name} launches, expected "
              f"{per_step} (forward and recompute)")
        if do_ckpt and i + 1 == TRAIN_CKPT_AFTER:
            t = time.perf_counter()
            ckpt.save(str(path), {"params": params, "opt": state})
            fresh = api.init(1, dtype=torch.bfloat16, device=DEVICE)
            like = {"params": fresh, "opt": init_opt_state(fresh)}
            resumed = ckpt.restore(str(path), like, device=DEVICE)
            del fresh, like
            path.unlink()
            ckpt_s = time.perf_counter() - t
        if resumed is not None and i + 1 == TRAIN_CKPT_AFTER + 1:
            rp, rs, _ = step(resumed["params"], resumed["opt"], b)
            same = _trees_equal(params, rp) and _trees_equal(state, rs)
            emit({"phase": "train_checkpoint", "arch": arch, "saved_after": TRAIN_CKPT_AFTER,
                  "save_restore_s": ckpt_s, "resumed_step_identical": same})
            check(same, f"train {arch}: the resumed step differs from the uninterrupted one")
            del resumed, rp, rs
            resumed = None
    losses = [r["loss"] for r in rows]
    host = [r["s"] for r in rows[1:]]  # the first step warms the allocator and cuBLAS
    summary = {"phase": "train", "arch": arch, "layers": cfg.num_layers, "batch": batch,
               "seq": seq, "params": n_params, "model_flops_per_step": flops,
               "first_loss": losses[0], "last_loss": losses[-1],
               "median_step_s": statistics.median(host),
               "median_tokens_per_s": batch * seq / statistics.median(host),
               "median_mfu": flops / statistics.median(host) / rates[torch.bfloat16],
               "peak_gib": max(r["peak_gib"] for r in rows),
               "median_peak_gib": statistics.median(r["peak_gib"] for r in rows),
               "median_device_ms": statistics.median(r["device_ms"] for r in rows[1:]),
               "kernel": name,
               "launches": sum(r["launches"] for r in rows)}
    emit(summary)
    check(all(math.isfinite(x) for x in losses), f"train {arch}: a loss is not finite")
    check(losses[-1] <= losses[0] - TRAIN_MIN_DROP,
          f"train {arch}: the loss went {losses[0]} -> {losses[-1]} in {TRAIN_STEPS} steps")
    check(not do_ckpt or TRAIN_CKPT_AFTER < TRAIN_STEPS, "train: no checkpoint step")
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    return summary


def phase_train(gpu: str) -> dict:
    for arch in TRAIN_CMP:
        phase_train_compare(arch)
    return {arch: phase_train_whole(arch, batch, seq, gpu) for arch, batch, seq in TRAIN_WHOLE}


def _logits_ce_ms(api, params, batch: int, seq: int) -> float:
    """Device time (CUDA events) of the unembedding and the CE over a random
    final hidden state of one step's shape, forward and backward."""
    from repro_torch.models import layers

    gen = torch.Generator(device=DEVICE).manual_seed(9)
    x = torch.randn((batch, seq, api.cfg.d_model), generator=gen, device=DEVICE).to(
        torch.bfloat16).requires_grad_()
    w = {k: v.detach().requires_grad_() for k, v in params["embed"].items()}
    labels = torch.randint(0, api.cfg.vocab_size, (batch, seq), generator=gen, device=DEVICE)
    return time_ms(lambda: torch.autograd.grad(
        layers.cross_entropy_loss(layers.unembed(x, w), labels), [x, *w.values()],
        allow_unused=True), iters=3, warmup=1)


def profile_train_step(arch: str, batch: int, seq: int, host_s: float) -> dict:
    """One training step of a whole model in ``torch.profiler`` (after one
    outside it): the device time over the median host-clock step time of
    ``phase_train_whole`` (the busy share), and the device time of the kernel
    (forward and recompute), of the plain backward (the ``plain_grad.*``
    ranges), of the forward and of the optimizer (``train_step.*``), beside
    the logits and CE timed alone at the step's shapes."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch.train import opt_config
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train_step import build_train_step

    cfg = get_config(arch)
    api = build_model(cfg)
    params = api.init(0, dtype=torch.bfloat16, device=DEVICE)
    state = init_opt_state(params)
    step = build_train_step(api, opt_config(TRAIN_LR, TRAIN_STEPS))
    b = _train_batch(SyntheticTokens(DataConfig(cfg.vocab_size, seq, batch, 0)), 0, cfg)
    params, state, _ = step(params, state, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        params, state, _ = step(params, state, b)
        torch.cuda.synchronize()
    events = prof.events()
    spans = ("plain_grad.", "train_step.")  # the ranges' spans on the device timeline
    kernels = [e for e in _device_events(prof) if not e.name.startswith(spans)]
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    kernel_name = "ssd_sm90" if cfg.arch_type == "ssm" else "flash_sm90"

    def range_ms(prefix):
        return sum(e.device_time_total for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU
                   and e.name.startswith(prefix)) / 1e3

    row = {"phase": "profile_train", "arch": arch, "batch": batch, "seq": seq,
           "host_step_ms": host_s * 1e3, "device_ms": device_ms,
           "busy_share": device_ms / (host_s * 1e3), "device_kernels": len(kernels),
           "kernel_device_ms": sum(e.time_range.elapsed_us() for e in kernels
                                   if kernel_name in e.name) / 1e3,
           "plain_backward_device_ms": range_ms("plain_grad."),
           "forward_device_ms": range_ms("train_step.forward"),
           "optimizer_device_ms": range_ms("train_step.optimizer"),
           "logits_ce_fwd_bwd_ms_alone": _logits_ce_ms(api, params, batch, seq)}
    emit(row)
    check(device_ms > 0 and row["kernel_device_ms"] > 0,
          f"the profiler saw no device time in a {arch} training step")
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# Phase 7: where a decode step's time goes
# ---------------------------------------------------------------------------

PROFILED_MODELS = (("granite-8b", None), ("mixtral-8x7b", 16))
# Timed alone first and profiled last: with granite and mixtral's 16 layers
# (63.5 GB) it would not fit the card.
PROFILED_HYBRID = ("recurrentgemma-9b", None)


def _decode_steps(api, params, n, caches, tok, pos):
    """``n`` decode steps from position ``pos``, synced; host seconds each."""
    times = []
    for step in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, caches = api.decode_step(params, caches, tok, pos + step, 1024)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        tok = logits.argmax(-1).reshape(-1)
    return times, caches, tok


def time_decode_steps(models=PROFILED_MODELS, batch: int = 4, prompt_len: int = 300,
                      steps: int = 20) -> list:
    """Each full-width model of ``models`` ((arch, depth cut or None)): the
    host-clock time of ``steps`` decode steps at ``batch`` rows after a
    ``prompt_len`` prefill.  Every model is timed before the first profile:
    once started, the profiler's device tracing stays attached to the
    process and slows every later launch on the host.  Returns each model's
    state for ``profile_decode_step``."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    timed = []
    with torch.no_grad():
        for arch, num_layers in models:
            cfg = get_config(arch)
            if num_layers is not None:
                cfg = dataclasses.replace(cfg, num_layers=num_layers)
            api = build_model(cfg)
            params = api.init(0, dtype=torch.bfloat16, device=DEVICE)
            gen = torch.Generator(device=DEVICE).manual_seed(2)
            tokens = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen,
                                   device=DEVICE)
            logits, caches = api.prefill(params, {"tokens": tokens}, 1024)
            host, caches, tok = _decode_steps(api, params, steps, caches,
                                              logits.argmax(-1).reshape(-1), prompt_len)
            timed.append({"cfg": cfg, "api": api, "params": params, "caches": caches,
                          "tok": tok, "pos": prompt_len + steps, "host": host,
                          "batch": batch, "cache_len": prompt_len})
    return timed


def profile_decode_step(state: dict, profiled: int = 5) -> dict:
    """``profiled`` more decode steps of a ``time_decode_steps`` model in
    ``torch.profiler``: the device time (summed over every kernel) over the
    host-clock step time is the device's busy share of a step; and the
    device kernels per step and layer."""
    from torch.profiler import ProfilerActivity, profile

    cfg = state["cfg"]
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _decode_steps(state["api"], state["params"], profiled, state["caches"], state["tok"],
                      state["pos"])
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / profiled / 1e3
    decode_ms = sum(e.time_range.elapsed_us() for e in kernels
                    if "repro::" in e.name and "decode_" in e.name) / profiled / 1e3
    host = state["host"]
    host_ms = statistics.median(host) * 1e3
    per_step = len(kernels) / profiled
    row = {"phase": "profile", "arch": cfg.name, "layers": cfg.num_layers,
           "batch": state["batch"], "cache_len": state["cache_len"],
           "pos_mid": state["pos"] + profiled // 2,  # the profiled steps' middle position
           "host_step_ms": host_ms, "host_step_ms_min": min(host) * 1e3,
           "device_ms_per_step": device_ms, "busy_share": device_ms / host_ms,
           "decode_attention_device_ms_per_step": decode_ms,
           "device_kernels_per_step": per_step,
           "device_kernels_per_layer": per_step / cfg.num_layers}
    emit(row)
    check(device_ms > 0, f"the profiler saw no device time in a {cfg.name} decode step")
    return row


def _device_events(prof) -> list:
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def _profiled(fn, calls: int) -> tuple[float, float]:
    """(device kernels, device ms) per call of ``fn`` in ``torch.profiler``,
    after one call outside it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = _device_events(prof)
    return len(kernels) / calls, sum(e.time_range.elapsed_us() for e in kernels) / calls / 1e3


def profile_layer_kinds(state: dict, calls: int = 3) -> None:
    """The device kernels and device time of one decode step through one
    layer of each kind of a ``time_decode_steps`` model (the first layer of
    the kind, its own cache, a random hidden row per batch row)."""
    from repro_torch.models import transformer

    cfg = state["cfg"]
    kinds = transformer.layer_kinds(cfg)
    spec = transformer.cache_spec(cfg, 1024)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    x = torch.randn((state["batch"], 1, cfg.d_model), generator=gen, device=DEVICE).to(
        torch.bfloat16)
    per_kind = {}
    with torch.no_grad():
        for kind in dict.fromkeys(kinds):
            i = kinds.index(kind)
            p, cache = state["params"]["blocks"][i], state["caches"]["blocks"][i]
            n, ms = _profiled(lambda: transformer._block_decode(kind, x, cache, p, cfg,
                                                                state["pos"], spec, None), calls)
            per_kind[kind] = {"layers": kinds.count(kind), "device_kernels": n, "device_ms": ms}
    emit({"phase": "profile_layer_kinds", "arch": cfg.name, "batch": state["batch"],
          "per_kind": per_kind})


def profile_rglru_scan(state: dict, prompt_len: int = 2048, calls: int = 3) -> None:
    """The RG-LRU's share of the device time of a recurrentgemma-9b prefill
    of ``prompt_len`` tokens (one row): the prefill in ``torch.profiler``,
    then the first rglru layer's scan replayed on its own inputs once per
    rglru layer (every rglru layer has the same shapes), both the whole
    ``rglru_scan`` (the float32 gates and the scan) and the log-depth
    ``linear_scan`` alone."""
    from repro_torch.models import griffin, transformer

    cfg, api, params = state["cfg"], state["api"], state["params"]
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, (1, prompt_len), generator=gen, device=DEVICE)
    captured, scan = [], griffin.rglru_scan

    def recording(xb, p, h0=None):
        if not captured:
            captured.append((xb, p))
        return scan(xb, p, h0)

    griffin.rglru_scan = recording
    try:
        with torch.no_grad():
            n_prefill, prefill_ms = _profiled(
                lambda: api.prefill(params, {"tokens": tokens}, 1024), 1)
    finally:
        griffin.rglru_scan = scan
    n_rec = transformer.layer_kinds(cfg).count("rglru_mlp")
    xb, p = captured[0]
    with torch.no_grad():
        a, b = griffin._rglru_gates(xb, p)
        n_scan, scan_ms = _profiled(lambda: griffin.rglru_scan(xb, p), calls)
        n_linear, linear_ms = _profiled(lambda: griffin.linear_scan(a, b), calls)
    emit({"phase": "rglru_scan", "arch": cfg.name, "prefill_tokens": prompt_len,
          "prefill_device_ms": prefill_ms, "prefill_device_kernels": n_prefill,
          "rglru_layers": n_rec, "rglru_scan_device_ms_per_layer": scan_ms,
          "rglru_scan_kernels_per_layer": n_scan, "rglru_scan_share": n_rec * scan_ms / prefill_ms,
          "linear_scan_device_ms_per_layer": linear_ms,
          "linear_scan_kernels_per_layer": n_linear,
          "linear_scan_share": n_rec * linear_ms / prefill_ms})
    check(prefill_ms > 0 and linear_ms > 0, "the profiler saw no device time in the rglru scan")


# ---------------------------------------------------------------------------
# Phase 8: the dry-run, the roofline and the derived agent profiles
# ---------------------------------------------------------------------------

ROOFLINE_WORKERS = 8      # processes for the meta runs (host-bound), one per core
ROOFLINE_SLACK = 1.05     # no step beats its roofline: bound <= 1.05 x device time
PEAK_RTOL = 0.20          # the dry-run's training peak against max_memory_allocated
# examples/profile_driven_fleet.py's architectures and priorities
FLEET_ARCHS = {"qwen2-vl-2b": 1, "granite-8b": 2, "mixtral-8x7b": 2, "llama3-405b": 1}
FLEET_POLICIES = ("static_equal", "round_robin", "adaptive", "water_filling")
FLEET_STEPS = 100


def _write_artifact(root: Path, res: dict) -> None:
    from repro_torch.launch import mesh

    root.mkdir(parents=True, exist_ok=True)
    with open(root / f"{res['arch']}_{res['shape']}_{mesh.TAG}.json", "w") as f:
        json.dump(res, f, indent=1)


def phase_roofline(decode_rows: list, prefill_row: dict, train_rows: list,
                   trained: dict) -> None:
    """(a) The card as ``launch/mesh.py`` reads it.  (b) The dry-run and
    the roofline of every (arch, shape) pair at published widths on meta,
    in ``ROOFLINE_WORKERS`` processes, written to ``experiments/*_torch``;
    one ``roofline_pair`` line each; every applicable pair must finish.
    (c) The roofline of each step timed on the device, at its own shape,
    against that device time (no step beats its bound): phase 7's profiled
    decode steps and mamba prefill, phase 6c's training steps (CUDA events);
    and the dry-run's peak of each whole-model training step against the
    card's ``max_memory_allocated``.  (d) The Table I architectures' (T, R, M) at
    ``decode_32k`` and at the engine's decode shape beside the paper's
    Table I, and the fleet derived at the engine's shape through
    ``simulate`` on the card under four policies."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.core import paper_fleet, profiles, workload
    from repro_torch.core.simulator import run_policy
    from repro_torch.launch import dryrun, mesh, roofline
    from repro_torch.models.model import INPUT_SHAPES, InputShape

    t0 = time.perf_counter()
    card = mesh.hw()
    emit({"phase": "roofline_hw", "name": card["name"], "sku": card["sku"],
          "hbm_gib": card["hbm_bytes"] / 2**30, "sms": card["sms"],
          "hbm_bw": card["hbm_bw"],
          "peak_flops": {dryrun.dtype_name(dt): f for dt, f in card["peak_flops"].items()}})
    check(card["from_device"] and card["sms"] > 0, f"mesh.hw() did not read the card: {card}")

    pairs = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES]
    pairs += [(a, profiles.ENGINE_DECODE) for a in FLEET_ARCHS]
    timed = []  # (label, roofline call, the device ms it is held against)
    for row in decode_rows:
        shape = InputShape(f"decode_{row['batch']}x1024", 1024, row["batch"], "decode")
        timed.append((f"{row['arch']} decode, {row['layers']} layers, pos {row['pos_mid']}",
                      (roofline.run_one, (row["arch"], shape),
                       {"card": card, "num_layers": row["layers"], "pos": row["pos_mid"]}),
                      row["device_ms_per_step"]))
    prefill = InputShape(f"prefill_{prefill_row['prefill_tokens']}",
                         prefill_row["prefill_tokens"], 1, "prefill")
    timed.append((f"mamba2-370m prefill of {prefill.seq_len} tokens",
                  (roofline.run_one, ("mamba2-370m", prefill), {"card": card}),
                  prefill_row["prefill_device_ms"]))
    # A training step keeps the card busy (94-99.7%), so its device time is
    # read from CUDA events around each step of phase 6c (the median of steps
    # 2-20): one profiled step once reported half its kernels' time.
    train_shapes = {}
    for row in train_rows:
        shape = InputShape(f"train_{row['batch']}x{row['seq']}", row["seq"], row["batch"], "train")
        train_shapes[row["arch"]] = shape
        timed.append((f"{row['arch']} training step {row['batch']} x {row['seq']}",
                      (roofline.run_one, (row["arch"], shape), {"card": card}),
                      trained[row["arch"]]["median_device_ms"]))
    also = [(roofline.run_one, pair, {"card": card}) for pair in pairs]
    also += [call for _, call, _ in timed]
    also += [(dryrun.measure_arch, (arch, shape), {}) for arch, shape in train_shapes.items()]
    dry, done = dryrun.run_all(pairs, card, ROOFLINE_WORKERS, also)
    roofs, done = done[:len(pairs)], done[len(pairs):]
    bounds, peaks = done[:len(timed)], done[len(timed):]
    pool_s = time.perf_counter() - t0

    # (b)
    for d, r in zip(dry, roofs):
        if "skipped" in d:
            emit({"phase": "roofline_pair", "arch": d["arch"], "shape": d["shape"],
                  "skipped": d["skipped"]})
            continue
        check("error" not in d and "error" not in r,
              f"roofline {d['arch']} {d['shape']}: {d.get('error') or r.get('error')}")
        _write_artifact(ROOT / "experiments" / "dryrun_torch", d)
        _write_artifact(ROOT / "experiments" / "roofline_torch", r)
        emit({"phase": "roofline_pair", "arch": d["arch"], "shape": d["shape"],
              "terms_s": r["roofline_s"], "bottleneck": r["bottleneck"],
              "dryrun_terms_s": d["roofline_s"],
              "peak_gib": d["per_device"]["peak_bytes"] / 2**30, "fits": d["fits"],
              "max_batch": d["max_batch"], "useful_flops_ratio": r["useful_flops_ratio"],
              "kernel_calls": d["per_device"]["kernel_calls"]})
    applicable = sum("roofline_s" in d for d in dry)

    # (c)
    for (label, _, device_ms), r in zip(timed, bounds):
        check("error" not in r, f"roofline {label}: {r.get('error')}")
        bound_ms = max(r["roofline_s"].values()) * 1e3
        emit({"phase": "roofline_bound", "step": label, "bound_ms": bound_ms,
              "bound_by": r["bottleneck"], "terms_ms": {k: v * 1e3 for k, v in
                                                        r["roofline_s"].items()},
              "device_ms": device_ms, "share": bound_ms / device_ms})
        check(bound_ms <= ROOFLINE_SLACK * device_ms,
              f"{label}: the roofline's {bound_ms} ms exceeds the device's {device_ms} ms")
    for (arch, shape), m in zip(train_shapes.items(), peaks):
        check("error" not in m, f"dry-run {arch} {shape.name}: {m.get('error')}")
        dry_gib, card_gib = m["peak_bytes"] / 2**30, trained[arch]["median_peak_gib"]
        emit({"phase": "roofline_peak", "arch": arch, "shape": shape.name,
              "dryrun_peak_gib": dry_gib, "max_memory_allocated_gib": card_gib,
              "rel_gap": dry_gib / card_gib - 1})
        check(abs(dry_gib / card_gib - 1) <= PEAK_RTOL,
              f"{arch}: dry-run peak {dry_gib} GiB, the card's {card_gib} GiB")

    # (d)
    roots = {"root": str(ROOT / "experiments" / "roofline_torch"),
             "dryrun_root": str(ROOT / "experiments" / "dryrun_torch")}
    paper = paper_fleet()
    table_i = [{"name": n, "model_mb": float(m), "throughput": float(t), "min_gpu": float(g),
                "priority": float(p)} for n, m, t, g, p in zip(
                    paper.names, paper.model_size_mb, paper.base_throughput, paper.min_gpu,
                    paper.priority)]
    for shape in ("decode_32k", profiles.ENGINE_DECODE):
        derived = [profiles.profile_arch(a, shape=shape, **roots) for a in FLEET_ARCHS]
        check(all(p is not None for p in derived), f"no profile at {shape}")
        emit({"phase": "roofline_profiles",
              "shape": shape if isinstance(shape, str) else shape.name,
              "derived": derived, "table_i": table_i})
    fleet = profiles.fleet_from_archs(FLEET_ARCHS, shape=profiles.ENGINE_DECODE, **roots)
    fleet.validate()
    arrivals = workload.constant([t * 0.75 for t in fleet.base_throughput.tolist()], FLEET_STEPS)
    for policy in FLEET_POLICIES:
        summary = run_policy(policy, arrivals, fleet, device=DEVICE)
        emit({"phase": "roofline_fleet", "shape": profiles.ENGINE_DECODE.name,
              "policy": policy, "steps": FLEET_STEPS, "avg_latency": summary.avg_latency,
              "total_throughput": summary.total_throughput})
        check(math.isfinite(summary.avg_latency) and summary.total_throughput > 0,
              f"derived fleet under {policy}: {summary}")
    emit({"phase": "roofline_summary", "pairs": len(dry), "applicable": applicable,
          "skipped": len(dry) - applicable, "timed_steps": len(timed), "pool_s": pool_s,
          "s": time.perf_counter() - t0})


# ---------------------------------------------------------------------------
# Phase 9: the examples
# ---------------------------------------------------------------------------

EXAMPLES = ("quickstart", "profile_driven_fleet", "robustness_study", "serve_fleet",
            "train_small")
_NUMBER = re.compile(
    r"(?<![\w.])[-+]?(?:\d+\.?\d*(?:[eE][-+]?\d+)?|nan|NaN|inf|Infinity)(?![\w])")


def phase_examples() -> None:
    """Each ``examples/*_torch.py`` once on the card at its defaults, through
    its ``main``: one ``example`` line each with its wall time, its printed
    lines and every number it printed (all must be finite); quickstart's
    rows must give the Table II anchors (static_equal 110.3, adaptive
    111.9 / 58.12, every cost 0.020)."""
    import contextlib as ctx
    import importlib.util
    import io

    for name in EXAMPLES:
        path = ROOT / "examples" / f"{name}_torch.py"
        spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out = io.StringIO()
        t = time.perf_counter()
        with ctx.redirect_stdout(out):
            result = mod.main(["--device", DEVICE])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        text = out.getvalue()
        numbers = [float(x) for x in _NUMBER.findall(text)]
        finite = bool(numbers) and all(math.isfinite(x) for x in numbers)
        line = {"phase": "example", "name": name, "s": wall, "lines": len(text.splitlines()),
                "numbers": len(numbers), "finite": finite}
        if name == "quickstart":
            line["rows"] = {p: [r.avg_latency, r.total_throughput, r.cost]
                            for p, r in result.items()}
        emit(line)
        check(finite, f"example {name}: printed a non-finite number or none:\n{text}")
        if name == "quickstart":
            check(round(result["static_equal"].avg_latency, 1) == 110.3,
                  "example quickstart: static_equal latency")
            check(round(result["adaptive"].avg_latency, 1) == 111.9,
                  "example quickstart: adaptive latency")
            check(round(result["adaptive"].total_throughput, 2) == 58.12,
                  "example quickstart: adaptive throughput")
            check(all(round(r.cost, 3) == 0.020 for r in result.values()),
                  "example quickstart: cost")
        gc.collect()
        torch.cuda.empty_cache()


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repository)

    t0 = time.perf_counter()

    def lap(after: str) -> None:  # the script's time so far, per phase
        emit({"phase": "time", "after": after, "s": time.perf_counter() - t0})

    smi = phase_device()
    gpu = smi.split(",")[0]
    phase_build()
    summary = phase_kernels(gpu)
    lap("kernels")
    phase_gradients()
    lap("gradients")
    phase_model("granite-8b")
    phase_model("mamba2-370m", torch.float32)
    phase_model("mamba2-370m", torch.bfloat16, held=False)
    # mixtral-8x7b: an 8192-token prompt (banded on the plain route), then
    # decode steps into the rolled cache; float32 held at 4 layers, bf16 at
    # the fleet's 16 printed beside its yardstick.  granite-moe whole.
    phase_long_model("mixtral-8x7b", torch.float32, num_layers=4, prompt_len=8192, rtol=1e-3)
    phase_long_model("granite-moe-1b-a400m", torch.float32, prompt_len=512, steps=4, rtol=1e-3)
    phase_long_model("mixtral-8x7b", torch.bfloat16, num_layers=16, prompt_len=8192,
                     held=False, yardstick=True)
    # recurrentgemma-9b: two windows of prompt (banded on the plain route),
    # then decode steps into the rolled cache; float32 held at 6 layers (two
    # superblocks), bf16 whole (38 layers) held as granite-8b is, beside the
    # masked-vs-banded yardstick.
    # seamless-m4t-large-v2 whole in float32: 4096 encoder frames.
    phase_long_model("recurrentgemma-9b", torch.float32, num_layers=6, prompt_len=4096,
                     rtol=1e-3)
    phase_long_model("recurrentgemma-9b", torch.bfloat16, prompt_len=4096, yardstick=True)
    phase_long_model("seamless-m4t-large-v2", torch.float32, prompt_len=512, frames=4096,
                     rtol=1e-3)
    lap("models")
    dense = phase_engine()
    gc.collect()
    torch.cuda.empty_cache()
    two_agent = phase_two_agent_engine()
    gc.collect()
    torch.cuda.empty_cache()
    table_i = phase_table_i_engine()
    gc.collect()
    torch.cuda.empty_cache()
    hybrid = phase_hybrid_engine()
    gc.collect()
    torch.cuda.empty_cache()
    lap("fleets")
    sim_walls = phase_table2()
    lap("table2")
    sweep_walls = phase_sweep()
    lap("sweep")
    phase_sweep_mesh()
    lap("sweep_mesh")
    serverless = phase_serverless_engine()
    gc.collect()
    torch.cuda.empty_cache()
    lap("serverless_engine")
    trained = phase_train(gpu)
    lap("train")
    # Last: the profiler's device tracing, once started, stays attached to
    # the process and would slow every later launch on the host; so every
    # profiled decode step's host clock is read first.
    hybrid_host = time_decode_steps([PROFILED_HYBRID])[0]["host"]
    gc.collect()
    torch.cuda.empty_cache()
    granite, mixtral = time_decode_steps()
    decode_rows = [profile_decode_step(granite)]
    check_decode_launches()
    ssd_row = check_ssd_launches()
    decode_rows.append(profile_decode_step(mixtral))
    del granite, mixtral
    gc.collect()
    torch.cuda.empty_cache()
    rgemma = time_decode_steps([PROFILED_HYBRID], steps=2)[0]
    rgemma["host"] = hybrid_host  # the host clock read before any profile
    decode_rows.append(profile_decode_step(rgemma))
    profile_layer_kinds(rgemma)
    profile_rglru_scan(rgemma)
    del rgemma
    gc.collect()
    torch.cuda.empty_cache()
    profile_simulator(sim_walls["adaptive"])
    profile_sweep(sweep_walls["table2"])
    lap("profiles")
    train_rows = [profile_train_step(arch, batch, seq, trained[arch]["median_step_s"])
                  for arch, batch, seq in TRAIN_WHOLE]
    lap("train_profiles")
    phase_roofline(decode_rows, ssd_row, train_rows, trained)
    lap("roofline")
    phase_examples()
    lap("examples")
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
            # the newest fleet that runs the kernel: the hybrid fleet for
            # attention, the two-agent fleet for the SSD scan
            "launches": two_agent[name] if name == "ssd" else hybrid[name],
            "launches_by_fleet": {"dense": dense[name], "two_agent": two_agent[name],
                                  "serverless": serverless[name], "table_i": table_i[name],
                                  "hybrid": hybrid[name]},
            # 20 training steps of the model whose forward launches the kernel
            "launches_by_training": {arch: t["launches"] for arch, t in trained.items()
                                     if t["kernel"] == name},
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": row["case"], "dtype": row["dtype"],
        })
    check_tf32_off()
    print(f"total {time.perf_counter() - t0:.1f} s | {smi}", flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
