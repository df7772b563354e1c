#!/usr/bin/env python3
"""Time variant builds of the SSD scan's bf16 backward side by side.

    python3 tools/ssd_bwd_variants.py \
        '{"base": [], "g32": {"group": 32}, "x": [["old text", "new text"]]}'

Each variant is ``csrc/ssd_scan_bwd_sm90.cu`` with the given text
replacements, or a dict as ``kernel_variants.build`` takes it, whose
``"group"`` sets the heads a block takes (``ssd_scan.bwd_group`` is
replaced in this process while the variant runs).  Every variant's backward
runs at mamba2-370m's 4 x 4096 (32 heads, P 64, N 128) and 1 x 4096, in
bf16, in the order given and then reversed: each line is each device
kernel's mean ms over 5 calls (``torch.profiler``, L2 flushed
before each), their total, and whether the variant's gradients equal the
first variant's bit for bit.  ``kernel_variants.build`` prints each
variant's ptxas and SASS counts.  Needs the card and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import kernel_variants  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ssd import ssd_scan  # noqa: E402

SOURCE = ROOT / "src/repro_torch/kernels/ssd/csrc/ssd_scan_bwd_sm90.cu"
CASES = [(4, 4096, 32, 64, 128), (1, 4096, 32, 64, 128)]


def inputs(case):
    b, s, h, p, n = case
    gen = torch.Generator(device="cuda").manual_seed(6)
    x = (torch.randn((b, s, h, p), generator=gen, device="cuda") * 0.5).bfloat16()
    dt = F.softplus(torch.randn((b, s, h), generator=gen, device="cuda"))
    A = -torch.exp(torch.randn((h,), generator=gen, device="cuda") * 0.3)
    Bm, Cm = (torch.randn((b, s, n), generator=gen, device="cuda").bfloat16() for _ in range(2))
    D = torch.ones((h,), device="cuda")
    dy = torch.randn((b, s, h, p), generator=gen, device="cuda").bfloat16()
    return x, dt, A, Bm, Cm, D, None, dy, None


def run(lib: Path, group, args, flush) -> tuple[dict, list]:
    ssd_scan._fns.clear()
    _build._lib = ctypes.CDLL(str(lib))
    planned = ssd_scan.bwd_group
    if group is not None:
        ssd_scan.bwd_group = lambda b, s, h: group
    try:
        return _timed(lambda: ssd_scan.ssd_scan_bwd(*args, chunk=128), flush)
    finally:
        ssd_scan.bwd_group = planned


def _timed(call, flush) -> tuple[dict, list]:
    grads = call()
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            flush.zero_()
            call()
        torch.cuda.synchronize()
    ms: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and "ssd_bwd_" in e.name:
            k = re.search(r"(ssd_bwd_\w+_kernel)", e.name).group(1)
            ms[k] = ms.get(k, 0.0) + e.time_range.elapsed_us() / 1e3 / 5
    return ms, grads


def main() -> None:
    variants = json.loads(sys.argv[1]) if len(sys.argv) > 1 else {"base": []}
    libs = kernel_variants.build(SOURCE, variants, r"(ssd_bwd_\w+_kernel)")
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device="cuda")
    order = list(variants) + list(reversed(variants))
    for case in CASES:
        args = inputs(case)
        first = None
        for name in order:
            spec = variants[name]
            group = spec.get("group") if isinstance(spec, dict) else None
            ms, grads = run(libs[name], group, args, flush)
            if first is None:
                first = grads
            same = all(g is None or torch.equal(g, f) for g, f in zip(grads, first))
            print(json.dumps({"variant": name, "case": case, "group": group,
                              "total_ms": round(sum(ms.values()), 4),
                              "ms": {k: round(v, 4) for k, v in ms.items()},
                              "bits_equal_first": same}), flush=True)
        del args, first


if __name__ == "__main__":
    main()
