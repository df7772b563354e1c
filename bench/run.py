"""Run one benchmark cell once and print its result as one JSON line.

  python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic and
its metrics are found by name from ``BENCHMARK.json``; the traffic's
``kind`` picks the driver (``bench/drivers/<kind>.py``).  With ``--trace 0``
the result holds the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics read from a profiled window.  The numbers compared with
the reference are printed on standard error as the last lines, and last in
the result line under ``checks``, each beside its limit.

Exits non-zero without a result when there is no CUDA device or fewer than
the cell asks for, and when the process holds JAX or the JAX package
(``repro``) once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell's files, the run's arguments, and the
    hooks a test or ``bench/tools/control.py`` replaces (``wrap_step``,
    ``wrap_params``) to plant a fault or run a witness."""
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    control: bool = False
    wrap_step: object = staticmethod(lambda f: f)
    wrap_params: object = staticmethod(lambda tree: tree)
    clocks: dict = dataclasses.field(default_factory=dict)
    stages: dict = dataclasses.field(default_factory=dict)

    def mark(self, label: str):
        """Seconds from process start to the end of a stage of set-up, the
        device's queue drained first."""
        self.sync()
        self.stages[label] = time.perf_counter() - self.t_start

    def clock(self, label: str):
        """The card's clocks and power, read beside the window."""
        from bench import harness

        if self.device.type == "cuda":
            self.clocks[label] = harness.smi_sample()

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def memory_peak(self) -> int:
        import torch

        return int(torch.cuda.max_memory_allocated(self.device)) if self.device.type == "cuda" else 0

    def free(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def profile(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=acts)


def make_context(workload: str, seed: int, seconds: float, trace: bool, device,
                 root: Path = ROOT, **hooks) -> Context:
    """The context of cell ``workload`` of ``BENCHMARK.json``."""
    from bench import harness

    bench = harness.load_benchmark(root)
    cell = harness.find_cell(bench, workload)
    limits = json.loads((root / "bench" / "limits" / f"{workload}.json").read_text())
    return Context(cell=cell, config=harness.config_of(bench, cell, root),
                   traffic=harness.traffic_of(cell, root), limits=limits["limits"], seed=seed,
                   seconds=seconds, trace=trace, device=device, t_start=T_START, **hooks)


def execute(ctx: Context, root: Path = ROOT) -> dict:
    """Run the cell's driver and assemble the result line's object."""
    from bench import harness

    bench = harness.load_benchmark(root)
    name = ctx.cell["name"]
    out = harness.load_driver(ctx.traffic["kind"]).run(ctx)
    if ctx.trace:
        metrics = harness.read_per_layer(harness.per_layer_for(bench, name), out["record"], root)
    else:
        metrics = {m["name"]: {"value": float(out["e2e"][m["name"]]), "unit": m["unit"]}
                   for m in harness.end_to_end_for(bench, name) if m["name"] in out["e2e"]}
    device = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
              "kind": _device_name(ctx.device), "count": ctx.cell["chips"],
              "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": bool(out["correct"]), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": device}
    if ctx.trace:
        rec = out["record"]
        device["busy_s"] = rec.busy_s
        device["window_s"] = rec.window_s
        result["breakdown"] = {"device_ops": rec.device_ops, "idle_gaps": rec.idle_gaps}
    result["checks"] = out["checks"]
    result["_side"] = out
    return result


def _device_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from bench import harness

    bench = harness.load_benchmark()
    cell = harness.find_cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"bench: {args.workload} needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    ctx = make_context(args.workload, args.seed, args.seconds, bool(args.trace), device)
    ctx.stages["imports"] = time.perf_counter() - T_START
    torch.empty(1, device=device)
    ctx.mark("cuda")
    result = execute(ctx)
    side = result.pop("_side")
    found = harness.forbidden_modules()
    if found:
        print(f"bench: the process holds {found}; the benchmark may load none of "
              f"{list(harness.FORBIDDEN)}", file=sys.stderr)
        return 3
    harness.write_side(args.workload, args.seed, args.trace,
                       {"result": result, "clocks": ctx.clocks,
                        "side": {k: v for k, v in side.items() if k != "record"}})
    print("stages " + " ".join(f"{k}={v:.3f}" for k, v in ctx.stages.items()), file=sys.stderr)
    for k, (v, lim) in result["checks"].items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
