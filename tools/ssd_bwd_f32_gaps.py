#!/usr/bin/env python3
"""Each gradient's gap to the plain backward computed in float64, over its
max|g|, for the float32 SSD backward kernel and for the float32 plain
version (``ref.ssd_bwd_plain``), at the card tests' float32 cases and at
mamba2-370m's 4 x 4096 with the final state's cotangent, and the kernel's
device ms at that last case (median of 20 calls, CUDA events, L2 flushed
before each).

    python3 tools/ssd_bwd_f32_gaps.py [OTHER_SRC]

With OTHER_SRC, another checkout's ``src`` (an earlier commit unpacked by
``git archive``, say), that checkout's kernel runs on the same inputs in a
child process, before and after this one is timed twice, and its gaps and
times are printed beside.  One JSON line per case, then the times.  Needs
the card and nvcc.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("x", "dt", "A", "Bm", "Cm", "D", "h0")
# (b, s, h, p, n, h0, dh_final)
CASES = [
    (2, 130, 3, 64, 128, False, True), (1, 200, 5, 32, 72, True, False),
    (1, 2800, 5, 32, 72, True, False), (2, 64, 4, 16, 16, False, True),
    (2, 4224, 4, 16, 16, False, True), (1, 77, 6, 64, 16, True, True),
    (1, 300, 8, 16, 128, True, True), (1, 2900, 8, 16, 128, True, True),
    (4, 4096, 32, 64, 128, False, True),
]


def inputs(case):
    """x, dt, A, Bm, Cm, D, h0, dy, dh_final, drawn as the card tests draw them."""
    b, s, h, p, n, with_h0, with_dh = case
    gen = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
    x = randn(b, s, h, p) * 0.5
    dt = torch.nn.functional.softplus(randn(b, s, h))
    A = -torch.exp(randn(h) * 0.3)
    Bm, Cm = randn(b, s, n), randn(b, s, n)
    D = torch.ones((h,), device="cuda")
    h0 = randn(b, h, p, n) if with_h0 else None
    dy = randn(b, s, h, p)
    dh = randn(b, h, p, n) if with_dh else None
    return [x, dt, A, Bm, Cm, D, h0, dy, dh]


def device_ms(call, calls: int = 20) -> float:
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    call()
    times = []
    for _ in range(calls):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[calls // 2]


def kernel_grads(src: str, path: Path) -> None:
    """The kernel of the checkout at ``src`` on each case's saved inputs,
    its gradients saved in their place and its ms at the last case."""
    sys.path.insert(0, src)
    from repro_torch.kernels.ssd import ssd_scan

    runs = torch.load(path)
    for run in runs:
        args = [None if t is None else t.cuda() for t in run["inputs"]]
        run["grads"] = [None if g is None else g.cpu()
                        for g in ssd_scan.ssd_scan_bwd(*args, chunk=64)]
    runs[-1]["ms"] = device_ms(lambda: ssd_scan.ssd_scan_bwd(*args, chunk=64))
    torch.save(runs, path)


def main() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd import ref, ssd_scan

    other = sys.argv[1] if len(sys.argv) > 1 else None
    path = _build.build_root().parent / "ssd_bwd_f32_gaps.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    runs = [{"case": case, "inputs": [None if t is None else t.cpu() for t in inputs(case)]}
            for case in CASES]

    def run_other():
        torch.save(runs, path)
        subprocess.run([sys.executable, __file__, "--child", str(Path(other).resolve()),
                        str(path)], check=True)
        done = torch.load(path)
        path.unlink()
        return done

    times = {"other": [], "this": []}
    if other:
        others = run_other()
        times["other"].append(others[-1]["ms"])

    def gaps(got, want):
        return {k: float((g.double() - w.double()).abs().max() / w.double().abs().max())
                for k, g, w in zip(NAMES, got, want) if g is not None}

    for i, run in enumerate(runs):
        args = [None if t is None else t.cuda() for t in run["inputs"]]
        want = ref.ssd_bwd_plain(*args, chunk=64, work=torch.float64)
        row = {"case": run["case"],
               "kernel": gaps(ssd_scan.ssd_scan_bwd(*args, chunk=64), want),
               "plain_float32": gaps(ref.ssd_bwd_plain(*args, chunk=64), want)}
        if other:
            row["other"] = gaps([None if g is None else g.cuda() for g in others[i]["grads"]],
                                want)
        print(json.dumps(row), flush=True)
    for _ in range(2):
        times["this"].append(device_ms(lambda: ssd_scan.ssd_scan_bwd(*args, chunk=64)))
    if other:
        times["other"].append(run_other()[-1]["ms"])
    print(json.dumps({"case": runs[-1]["case"], "device_ms": times,
                      "card": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        kernel_grads(sys.argv[2], Path(sys.argv[3]))
    else:
        main()
