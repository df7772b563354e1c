"""The harness on the CPU: cells and metrics found by name, the window
arithmetic, the stages of set-up, the metric readers, the import rule."""
from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest
import torch

from bench import harness
from support import CELL, reduced_context

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = ([c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    assert 1 <= BENCH["run_seconds"] <= 51
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    w = harness.find_cell(BENCH, cell)
    conf = harness.config_of(BENCH, w)
    traffic = harness.traffic_of(w)
    assert harness.load_driver(traffic["kind"]).run
    assert (harness.ROOT / "bench" / "limits" / f"{cell}.json").is_file()
    assert conf["models"]
    e2e = {m["name"] for m in harness.end_to_end_for(BENCH, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.per_layer_for(BENCH, cell)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_each_reader_states_its_entry(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    r = harness.load_reader(metric)
    assert (r.LAYER, r.UNIT, r.SOURCE, r.MOVES) == (
        entry["layer"], entry["unit"], entry["source"], entry["moves"])


def test_every_reader_file_is_a_metric_of_the_benchmark():
    names = {m["name"] for m in BENCH["per_layer"]}
    for path in (harness.ROOT / "bench" / "metrics").glob("*.py"):
        assert path.stem in names, path
        r = harness.load_reader(path.stem)
        assert r.LAYER and r.UNIT and r.SOURCE in (
            "device_trace", "program_span", "program_counter", "host_clock") and r.MOVES


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.find_cell(BENCH, "no-such-cell")


def test_train_rate_is_over_the_enqueued_steps(monkeypatch):
    from bench.run import execute

    ctx = reduced_context(monkeypatch)
    res = execute(ctx)
    side = res["_side"]["side"]
    t = ctx.traffic
    assert res["metrics"]["train_tokens_per_s"]["value"] == pytest.approx(
        side["steps"] * t["batch"] * t["seq_len"] / side["window_s"])
    assert res["attempted"] == side["steps"] >= 1 and res["failed"] == 0
    assert side["window_s"] >= ctx.seconds
    assert set(res["metrics"]) == {m["name"] for m in harness.end_to_end_for(BENCH, CELL)}
    assert [k for k in res if k != "_side"][-1] == "checks"


def test_setup_stages_are_recorded_in_order(monkeypatch):
    """Set-up is timed stage by stage, from the program's build to the
    card's clocks read at the window's opening, within ``setup_s``."""
    from bench.run import execute

    ctx = reduced_context(monkeypatch)
    res = execute(ctx)
    stages = res["_side"]["side"]["stages"]
    warm = ctx.traffic["warmup_steps"]
    assert list(stages) == (["program", "weights", "tokens"]
                            + [f"step{i + 1}" for i in range(warm)] + ["clock"])
    times = list(stages.values())
    assert times == sorted(times) and times[-1] <= res["_side"]["e2e"]["setup_s"]


def test_a_traced_run_reads_every_per_layer_metric_it_can(monkeypatch):
    """On the CPU the trace holds no kernels: the readers of device time
    find nothing and are left out, the host-clock ones read."""
    from bench.run import execute

    res = execute(reduced_context(monkeypatch, trace=True))
    assert set(res["metrics"]) <= {m["name"] for m in harness.per_layer_for(BENCH, CELL)}
    assert "mfu.train" in res["metrics"] and "ssd_fwd.roofline" not in res["metrics"]
    assert res["attempted"] == 2 * 2 and res["device"]["busy_s"] == 0.0


def _record(**data):
    return harness.Record(kernels={}, ranges={}, busy_s=0.0, window_s=0.0, data=data,
                          device_ops=[], idle_gaps=[])


def test_train_readers_on_a_recorded_table():
    m = {"family": "ssm", "num_layers": 1, "d_model": 64, "padded_vocab": 16, "ssm_expand": 2,
         "ssm_head_dim": 32, "ssm_state_dim": 16, "ssm_conv_width": 4, "ssm_chunk_size": 16}
    rec = _record(steps=2, step_s=0.5, model=m, batch=2, seq=32, n_params=1000)
    rec.ranges = {"train_step.forward": 0.3, "train_step.optimizer": 0.02}
    rec.kernels = {"ssd_sm90_kernel": [1e-3, 4], "ssd_bwd_states_sm90_kernel": [1e-3, 2],
                   "ssd_bwd_reduce_sm90_kernel": [1e-3, 2]}
    rec.busy_s, rec.window_s = 0.9, 1.0
    read = lambda name: harness.load_reader(name).read(rec)  # noqa: E731
    assert read("forward_ms") == pytest.approx(150.0)
    assert read("optimizer_ms") == pytest.approx(10.0)
    assert read("device_idle.train") == pytest.approx(10.0)
    assert read("mfu.train") == pytest.approx(100 * 6 * 1000 * 64 / 0.5 / 989e12)
    from bench import counts
    f, b = counts.ssd_fwd(2, 32, 4, 32, 16, chunk=16)
    assert read("ssd_fwd.roofline") == pytest.approx(100 * 4 * counts.bound_s(f, b) / 1e-3)
    f, b = counts.ssd_bwd(2, 32, 4, 32, 16, chunk=16)
    assert read("ssd_bwd.roofline") == pytest.approx(100 * 2 * counts.bound_s(f, b) / 2e-3)
    # a reader that finds nothing to read returns nothing
    empty = _record()
    for name in ("forward_ms", "optimizer_ms", "ssd_fwd.roofline", "ssd_bwd.roofline",
                 "device_idle.train", "mfu.train"):
        assert harness.load_reader(name).read(empty) is None, name


def test_reduce_trace_names_ranges_and_gaps():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("bench.window"):
            with torch.profiler.record_function("bench.step"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    rec = harness.reduce_trace(prof, "bench.window", {"x": 1})
    assert rec.window_s > 0 and rec.busy_s == 0.0 and rec.data == {"x": 1}
    assert "bench.step" in rec.ranges
    assert rec.idle_gaps and rec.idle_gaps[0][0] in ("bench.step", "host")
    with pytest.raises(RuntimeError):
        harness.reduce_trace(prof, "no.such.range", {})


def test_short_kernel_names():
    assert harness.short_name(
        "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>, "
        "std::array<char*, 1ul> >(int, at::native::FillFunctor<float>, std::array<char*, 1ul>)"
    ) == "vectorized_elementwise_kernel"
    assert harness.short_name("flash_sm90_kernel") == "flash_sm90_kernel"
    assert harness.short_name("nvjet_tst_192x192_64x3_1x2_h_bz_coopB_NNN") == \
        "nvjet_tst_192x192_64x3_1x2_h_bz_coopB_NNN"


def test_nothing_the_benchmark_loads_is_jax_or_the_jax_package():
    """Import every module of the benchmark (run, drivers, references,
    readers, tools) in a fresh process and look at sys.modules' top-level
    names, compared whole: the port's ``repro_torch`` is allowed, ``repro``
    is not."""
    code = (
        "import sys, pathlib; root = pathlib.Path('.').resolve();"
        "sys.path[:0] = [str(root / 'src'), str(root)];"
        "import bench.run, bench.harness, bench.drivers.train, bench.weights, bench.counts;"
        "import bench.reference.mamba2, bench.tools.control;"
        "from bench import harness;"
        "[harness.load_reader(m['name']) for m in harness.load_benchmark()['per_layer']];"
        "import repro_torch.training.train_step, repro_torch.kernels.ssd.ops;"
        "print(sorted({n.split('.')[0] for n in sys.modules}))"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, check=True).stdout
    tops = set(json.loads(out.strip().replace("'", '"')))
    assert "repro_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_x", sys)
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert harness.forbidden_modules() == ["repro"]


def test_run_refuses_without_a_card():
    """Without a CUDA device (this host) a run prints no result and exits
    non-zero."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, "bench/run.py", "--workload", CELL,
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=harness.ROOT, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_refuses_without_the_program(tmp_path):
    """In a directory with only BENCHMARK.json and bench/, a run fails."""
    import shutil

    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "bench/run.py", "--workload", CELL,
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout.strip() == ""
