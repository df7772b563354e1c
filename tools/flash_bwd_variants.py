#!/usr/bin/env python3
"""Time variant builds of flash attention's backward kernel side by side.

    python3 tools/flash_bwd_variants.py \
        '{"base": [], "two_stages": [["STAGES = D == 256 ? 2 : 3", "STAGES = 2"]]}'

Each variant is ``csrc/flash_attention_bwd.cu`` with the given text
replacements, or a dict as ``kernel_variants.build`` takes it, which
builds it into a library of its own.  Every variant's backward runs at qwen2-vl-2b's 2 x 4096 (12 heads on 2,
D 128, causal), recurrentgemma-9b's 1 x 4096 (16 on 1, D 256, window
2048), minitron-4b's 1 x 4096 (24 on 8) and 2 x 2048 at 16 heads of 64, in
bf16, in the order given and then reversed; each line is the median of 10
calls (CUDA events, L2 flushed before each) and whether the variant's
gradients equal the first variant's bit for bit.  ptxas' registers and
spills, and SASS counts, are printed per variant.  Needs the card and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import kernel_variants  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.attention import flash_attention as fa  # noqa: E402

SOURCE = ROOT / "src/repro_torch/kernels/attention/csrc/flash_attention_bwd.cu"
CASES = [(2, 4096, 4096, 12, 2, 128, True, 0), (1, 4096, 4096, 16, 1, 256, True, 2048),
         (1, 4096, 4096, 24, 8, 128, True, 0), (2, 2048, 2048, 16, 16, 64, True, 0)]


def build(variants: dict) -> dict[str, Path]:
    return kernel_variants.build(SOURCE, variants, r"(\w+_kernel)I?L?i?(\d*)")


def time_ms(fn, flush, iters: int = 10) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    marks = []
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in marks)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("flash_bwd_variants: no CUDA device")
    variants = json.loads(sys.argv[1])
    libs = build(variants)
    gen = torch.Generator(device="cuda").manual_seed(5)
    flush = torch.empty(32 * 2**20, device="cuda")
    inputs = []
    for b, s_q, s_kv, h, kv, d, causal, window in CASES:
        qkv = [torch.randn((b, s, n, d), generator=gen, device="cuda").bfloat16()
               for s, n in ((s_q, h), (s_kv, kv), (s_kv, kv))]
        cot = torch.randn((b, s_q, h, d), generator=gen, device="cuda").bfloat16()
        inputs.append((qkv, cot, dict(causal=causal, window=window, q_offset=0)))
    first = {}
    for name in list(variants) + list(variants)[::-1]:
        fa._fns.clear()
        _build._lib = ctypes.CDLL(str(libs[name]))
        for i, (qkv, cot, kw) in enumerate(inputs):
            out, lse = fa._launch(*qkv, lse=True, **kw)
            grads = fa.flash_attention_bwd(*qkv, out, lse, cot, **kw)
            first.setdefault(i, grads)
            same = all(torch.equal(x, y) for x, y in zip(grads, first[i]))
            ms = time_ms(lambda: fa.flash_attention_bwd(*qkv, out, lse, cot, **kw), flush)
            print(json.dumps({"variant": name, "case": CASES[i], "ms": ms,
                              "bits_equal_first": same}), flush=True)


if __name__ == "__main__":
    main()
