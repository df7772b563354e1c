"""What every cell shares: finding the cell, its configuration, its traffic
and its metrics by name; reading a profiler trace; the result line.

Everything specific to one configuration, one traffic mix or one per-layer
metric sits in a file of its own: ``bench/configs/<config>.json``,
``bench/traffic/<traffic>.json`` (whose ``kind`` names the driver,
``bench/drivers/<kind>.py``) and ``bench/metrics/<metric>.py``.  So a cell
or a metric is added by adding files and entries, not by editing these.
"""
from __future__ import annotations

import bisect
import dataclasses
import importlib
import importlib.util
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# Modules the benchmark's process may never hold: the JAX package's name is
# compared whole, since the port's (``repro_torch``) begins with it.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# Written beside the result, never into it: clocks, per-run details.
RUNS_DIR = ROOT / "bench_runs"


# -- the cell and its files ------------------------------------------------------

def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                   f"known: {[w['name'] for w in bench['workloads']]}")


def config_of(bench: dict, cell: dict, root: Path = ROOT) -> dict:
    """The cell's configuration: the file its ``BENCHMARK.json`` entry names."""
    path = next(c["file"] for c in bench["configs"] if c["name"] == cell["config"])
    return json.loads((root / path).read_text())


def traffic_of(cell: dict, root: Path = ROOT) -> dict:
    return json.loads((root / "bench" / "traffic" / f"{cell['traffic']}.json").read_text())


def _listed(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end_for(bench: dict, cell: str) -> list[dict]:
    return [m for m in bench["end_to_end"] if _listed(m, cell)]


def per_layer_for(bench: dict, cell: str) -> list[dict]:
    e2e = {m["name"] for m in end_to_end_for(bench, cell)}
    return [m for m in bench["per_layer"] if _listed(m, cell) and m["moves"] in e2e]


def load_reader(metric: str, root: Path = ROOT):
    """The reader of per-layer metric ``metric``: ``bench/metrics/<metric>.py``
    (loaded by path: a metric's name may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}",
                                                  root / "bench" / "metrics" / f"{metric}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(kind: str):
    return importlib.import_module(f"bench.drivers.{kind}")


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that the benchmark may not load."""
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


# -- the device trace ------------------------------------------------------------

def short_name(name: str) -> str:
    """A kernel's identifier without return type, namespace, template
    arguments or parameters: ``void at::native::foo<4, ...>(...)`` -> ``foo``."""
    s = re.sub(r"^void ", "", name.strip()).replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in s:  # drop <...> (nested) and everything from the first '('
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            out.append(ch)
    s = "".join(out).strip()
    return s.split("::")[-1].split(" ")[-1] or name[:64]


@dataclasses.dataclass
class Record:
    """What a traced window left for the per-layer readers.

    ``kernels``: short kernel name -> [device seconds, launches];
    ``ranges``: profiler range name -> device seconds of the kernels
    launched inside it; ``busy_s``: seconds in which an operation ran on
    the device; ``window_s``: the traced window; ``data``: what the driver
    counted on the host (spans, calls and their shapes, the configuration).
    """
    kernels: dict
    ranges: dict
    busy_s: float
    window_s: float
    data: dict
    device_ops: list
    idle_gaps: list

    def kernel_seconds(self, names) -> float:
        return sum(self.kernels.get(n, [0.0, 0])[0] for n in names)

    def kernel_calls(self, names) -> int:
        return sum(self.kernels.get(n, [0.0, 0])[1] for n in names)


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce_trace(prof, window_range: str, data: dict) -> Record:
    """Reduce a ``torch.profiler`` session to a ``Record``.  The window is
    the host range named ``window_range``; device time is clipped to it."""
    from torch.autograd import DeviceType

    events = prof.events()
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    dev = [e for e in events if e.device_type != DeviceType.CPU]
    win = [e for e in cpu if e.name == window_range]
    if not win:
        raise RuntimeError(f"the trace holds no range {window_range!r}")
    w0 = min(e.time_range.start for e in win)
    w1 = max(e.time_range.end for e in win)

    annotations = {e.name for e in cpu if getattr(e, "is_user_annotation", False)}
    kernels: dict[str, list] = {}
    spans = []
    for e in dev:
        a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if b <= a:
            continue
        # Device-side copies of host annotations are not operations.
        if getattr(e, "is_user_annotation", False) or e.name in annotations:
            continue
        k = kernels.setdefault(short_name(e.name), [0.0, 0])
        k[0] += (b - a) * 1e-6
        k[1] += 1
        spans.append((a, b))
    busy = _union(spans)
    busy_s = sum(b - a for a, b in busy) * 1e-6

    ranges: dict[str, float] = {}
    for e in cpu:
        if getattr(e, "is_user_annotation", False) and e.name != window_range:
            t = getattr(e, "device_time_total", None)
            if t is None:
                t = getattr(e, "cuda_time_total", 0.0)
            ranges[e.name] = ranges.get(e.name, 0.0) + t * 1e-6

    # Each idle gap on the device, named by the innermost host range around it.
    annotated = sorted(((e.time_range.start, e.time_range.end, e.name) for e in cpu
                        if getattr(e, "is_user_annotation", False) and e.name != window_range),
                       key=lambda r: r[0])
    starts = [r[0] for r in annotated]
    gaps: dict[str, float] = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        name = "host"
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if annotated[i][1] >= mid:  # the latest-starting range around it
                name = annotated[i][2]
                break
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
    ops = sorted(([k, v[0]] for k, v in kernels.items()), key=lambda kv: -kv[1])[:10]
    idle = sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])[:10]
    return Record(kernels=kernels, ranges=ranges, busy_s=busy_s, window_s=(w1 - w0) * 1e-6,
                  data=data, device_ops=ops, idle_gaps=idle)


def read_per_layer(metrics: list[dict], rec: Record, root: Path = ROOT) -> dict:
    """Each per-layer metric's reader over the record; a reader that finds
    nothing to read returns None and its metric is left out."""
    out = {}
    for m in metrics:
        v = load_reader(m["name"], root).read(rec)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


# -- the card --------------------------------------------------------------------

def smi_sample() -> dict:
    """The card's clocks, power and temperature, read by ``nvidia-smi``."""
    fields = "name,clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20).stdout
    except (OSError, subprocess.SubprocessError) as err:
        return {"error": str(err)}
    rows = [dict(zip(fields.split(","), (x.strip() for x in line.split(","))))
            for line in out.strip().splitlines()]
    return {"t": time.time(), "cards": rows}


def write_side(cell: str, seed: int, trace: int, obj: dict) -> None:
    """Per-run details beside the result: ``bench_runs/<cell>.<seed>.<trace>.json``."""
    RUNS_DIR.mkdir(exist_ok=True)
    (RUNS_DIR / f"{cell}.{seed}.{trace}.json").write_text(json.dumps(obj, indent=1, default=str))
