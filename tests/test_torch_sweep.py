"""The port's sweep grids (``repro_torch/core/sweep.py``) against the JAX
package's, fed the same materialized JAX arrivals through numpy: ``sweep``,
its failure axis, ``sweep_fleets``, ``sweep_workflows`` and
``sweep_capacity``, every policy, within ``tests/test_streaming.py``'s
RTOL = ATOL = 1e-3 (metric grid and per-agent grids); the stream against
the port's trace oracle; synthesized scenarios; ``best``'s tie rule and
``table``; and the ``stack_*`` helpers and their batched steps."""
import dataclasses
import functools
import importlib

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro.core import agents as ref_agents
from repro.core import capacity as ref_capacity
from repro.core import failures as ref_failures
from repro.core import routing as ref_routing
from repro.core import workload as ref_wl
from repro_torch.core import agents, capacity, failures, prng, routing, workload
from repro_torch.core.simulator import METRIC_NAMES, SimConfig

ref_sweep = importlib.import_module("repro.core.sweep")
sw = importlib.import_module("repro_torch.core.sweep")

RTOL = ATOL = 1e-3
STEPS = 16
RATES4 = np.asarray(agents.PAPER_ARRIVAL_RATES, np.float32)
GRIDS = ("metrics", "per_agent_latency", "per_agent_throughput", "per_agent_queue")


@functools.lru_cache(maxsize=None)
def _jax_library(n=4, seed=0):
    rates = (ref_agents.PAPER_ARRIVAL_RATES if n == 4
             else ref_wl.synthetic_rates(n, seed=seed))
    return ref_sweep.scenario_library(rates, STEPS, seed)


def _port_library(lib):
    return [sw.Scenario(s.name, torch.from_numpy(np.array(s.arrivals))) for s in lib]


def _assert_grids(got, want, what):
    for field in GRIDS:
        g, w = getattr(got, field), np.asarray(getattr(want, field))
        assert g.shape == w.shape, (what, field)
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=f"{what}/{field}")
    assert got.policy_names == tuple(want.policy_names)
    assert got.scenario_names == tuple(want.scenario_names)


@pytest.mark.parametrize("grid", ["sweep", "chaos"])
def test_sweep_matches_jax(grid):
    kw = {}, {}
    if grid == "chaos":
        kw = ({"failures": ref_failures.failure_scenario_library()},
              {"failures": failures.failure_scenario_library()})
    want = ref_sweep.sweep(ref_agents.paper_fleet(), _jax_library(), **kw[0])
    got = sw.sweep(agents.paper_fleet(), _port_library(_jax_library()), device="cpu", **kw[1])
    _assert_grids(got, want, grid)
    assert got.failure_names == want.failure_names
    if grid == "chaos":
        assert got.metrics.shape == (6, 9, 8, len(METRIC_NAMES))
        assert got.metric("dropped")[4:].max() > 0 and got.metric("dropped")[:4].max() == 0


def test_sweep_fleets_matches_jax(monkeypatch):
    """Fleets of 3, 6 and 8 agents, padded and stacked; the port's fleet
    library replaced by the reference's arrays."""
    sizes = (3, 6, 8)
    vecs = [ref_wl.synthetic_rates(n, seed=i) for i, n in enumerate(sizes)]
    names, arr = ref_sweep.fleet_scenario_library(vecs, 8, STEPS, 0)
    monkeypatch.setattr(sw, "fleet_scenario_library",
                        lambda *a: (names, torch.from_numpy(np.array(arr))))
    want = ref_sweep.sweep_fleets([ref_agents.synthetic_fleet(n, seed=n) for n in sizes],
                                  num_steps=STEPS, shard=False)
    fleets = [agents.synthetic_fleet(n, seed=n) for n in sizes]
    got = sw.sweep_fleets(fleets, num_steps=STEPS, device="cpu")
    _assert_grids(got, want, "fleets")
    assert got.fleet_names == tuple(want.fleet_names)
    oracle = sw.sweep_fleets(fleets, num_steps=STEPS, device="cpu", stream=False)
    _assert_grids(oracle, want, "fleets oracle")


def test_sweep_workflows_matches_jax():
    want = ref_sweep.sweep_workflows(ref_agents.paper_fleet(), scenarios=_jax_library())
    got = sw.sweep_workflows(agents.paper_fleet(), scenarios=_port_library(_jax_library()),
                             device="cpu")
    _assert_grids(got, want, "workflows")
    assert got.workflow_names == tuple(want.workflow_names)
    oracle = sw.sweep_workflows(agents.paper_fleet(), scenarios=_port_library(_jax_library()),
                                device="cpu", stream=False)
    _assert_grids(oracle, want, "workflows oracle")


def test_sweep_capacity_matches_jax():
    cfg = dict(num_gpus=8.0)
    want = ref_sweep.sweep_capacity(ref_agents.paper_fleet(), scenarios=_jax_library(),
                                    config=ref_sweep.SimConfig(**cfg))
    got = sw.sweep_capacity(agents.paper_fleet(), scenarios=_port_library(_jax_library()),
                            config=SimConfig(**cfg), device="cpu")
    _assert_grids(got, want, "capacity")
    assert got.capacity_names == tuple(want.capacity_names)
    assert len(np.unique(np.round(got.metric("cost"), 6))) > 1  # cost is per cell


def test_stream_matches_the_trace_oracle_with_traces_kept():
    """``stream=False``/``keep_traces=True`` run ``simulate_core`` per cell;
    the stream agrees, and the kept traces are the per-cell traces."""
    lib = _port_library(_jax_library())[:3]
    cap = capacity.capacity_config("reactive", cold_start_s=2.0, min_instances=1.0)
    kw = dict(config=SimConfig(num_gpus=8.0), capacity=cap, device="cpu",
              failures=failures.failure_scenario_library()[-1])
    stream = sw.sweep(agents.paper_fleet(), lib, **kw)
    traced = sw.sweep(agents.paper_fleet(), lib, keep_traces=True, **kw)
    for field in GRIDS:
        np.testing.assert_allclose(getattr(stream, field), getattr(traced, field),
                                   rtol=RTOL, atol=ATOL)
    assert traced.traces.queue.shape == (9, 3, STEPS, 4)
    arrays = sw.sweep(agents.paper_fleet(), lib, return_arrays=True, **kw)
    assert isinstance(arrays[0], torch.Tensor) and arrays[0].shape == (9, 3, len(METRIC_NAMES))
    with pytest.raises(ValueError, match="never materializes traces"):
        sw.sweep(agents.paper_fleet(), lib, keep_traces=True, stream=True, device="cpu")


def test_synthesized_scenarios(monkeypatch):
    """Specs synthesized in the loop equal the same specs materialized, at
    every block size, for ``sweep`` and ``sweep_fleets``; the hatch forces
    materialization; specs and tensors do not mix."""
    fleet = agents.paper_fleet()
    specs = workload.scenario_specs(workload.synthetic_rates(4, seed=0), STEPS + 3, 0)
    base = sw.sweep(fleet, specs, device="cpu", block_size=1)
    for b in (4, 8):
        assert np.array_equal(sw.sweep(fleet, specs, device="cpu", block_size=b).metrics,
                              base.metrics)
    assert np.array_equal(sw.sweep(fleet, specs, device="cpu", synthesize=False).metrics,
                          base.metrics)
    monkeypatch.setenv(workload.SYNTH_ENV, "0")
    assert np.array_equal(sw.sweep(fleet, specs, device="cpu").metrics, base.metrics)
    monkeypatch.delenv(workload.SYNTH_ENV)
    fleets = [agents.synthetic_fleet(n, seed=n) for n in (3, 5)]
    synth = sw.sweep_fleets(fleets, num_steps=STEPS, synthesize=True, block_size=8, device="cpu")
    mat = sw.sweep_fleets(fleets, num_steps=STEPS, synthesize=False, device="cpu")
    assert np.array_equal(synth.metrics, mat.metrics)
    with pytest.raises(ValueError, match="not a mix"):
        sw.sweep(fleet, [specs[0], _port_library(_jax_library())[0]], device="cpu")
    with pytest.raises(ValueError, match="WorkloadSpec"):
        sw.sweep(fleet, _port_library(_jax_library()), synthesize=True, device="cpu")


def test_best_tie_rule_table_and_summary():
    """Ties keep the first policy in registry order, minimizing or
    maximizing; ``table`` has one row per cell; ``summary`` picks a cell."""
    res = sw.sweep(agents.paper_fleet(), _port_library(_jax_library())[:1], device="cpu")
    table = res.table()
    assert len(table.rows) == 9 and table.columns[:2] == ("policy", "scenario")
    # static_equal (first) and objective_descent tie on the constant column.
    assert res.summary("objective_descent", "constant").avg_latency == pytest.approx(
        res.summary("static_equal", "constant").avg_latency)
    assert table.best("cost") == {"constant": "static_equal"}
    assert table.best("cost", minimize=False) == {"constant": "static_equal"}
    rows = (("a", "s", 1.0), ("b", "s", 1.0), ("c", "s", 0.5), ("d", "t", 2.0))
    summary = sw.SweepSummary(columns=("policy", "scenario", "m"), rows=rows)
    assert summary.best("m") == {"s": "c", "t": "d"}
    assert summary.best("m", minimize=False) == {"s": "a", "t": "d"}
    lead = sw.SweepSummary(columns=("fleet", "policy", "scenario", "m"),
                           rows=(("f0", "a", "s", 1.0), ("f0", "b", "s", 1.0),
                                 ("f1", "a", "s", 2.0), ("f1", "b", "s", 1.0)))
    assert lead.best("m") == {"f0/s": "a", "f1/s": "b"}
    assert len(summary.to_csv_lines()) == 5
    chaos = sw.sweep(agents.paper_fleet(), _port_library(_jax_library())[:2], device="cpu",
                     failures=failures.failure_scenario_library()[:2])
    assert chaos.table().columns[0] == "failure" and len(chaos.table().rows) == 2 * 9 * 2
    s = chaos.summary("adaptive", "poisson", failure="revoke_mild")
    assert s.avg_latency == chaos.metric("avg_latency")[1, 2, 1]
    with pytest.raises(ValueError, match="failure axis present"):
        chaos.summary("adaptive", "poisson")
    with pytest.raises(ValueError, match="no fleet axis"):
        res.summary("adaptive", "constant", fleet="x")


def test_entry_point_errors():
    fleet = agents.paper_fleet()
    lib = _port_library(_jax_library())[:1]
    with pytest.raises(ValueError, match="only the plain sweep"):
        sw.sweep_fleets([fleet], failures=failures.failure_scenario_library(), device="cpu")
    with pytest.raises(ValueError, match="unique"):
        sw.sweep_capacity(fleet, [capacity.capacity_config("fixed")] * 2, lib, device="cpu")
    with pytest.raises(ValueError, match="rate vector"):
        sw.sweep_fleets([fleet], rate_vectors=[np.ones(3)], device="cpu")
    with pytest.raises(ValueError, match="unknown policy"):
        sw.sweep(fleet, lib, policies=["nope"], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            sw.sweep(fleet, lib)
    assert [w.name for w in sw.workflow_scenario_library(4)] == [
        w.name for w in ref_sweep.workflow_scenario_library(4)]


def test_synth_groups_are_synth_gen_groups():
    """The stream's synthesizer groups a stacked spec's rows exactly as
    ``synth_gen_groups`` partitions its scenario axis; a fleet-batched
    stack whose generator changes along a column has no partition."""
    specs = workload.scenario_specs(RATES4, STEPS, 1)
    stacked = workload.stack_specs(list(specs) + [specs[0], specs[6]])
    groups = sw.synth_gen_groups(stacked)
    assert groups == tuple((name, tuple(idx.tolist()))
                           for name, _, idx, *_ in workload.Synth(stacked, "cpu").groups)
    # overload_3x and dominated are the constant generator on other rates
    assert groups[0] == ("constant", (0, 3, 4, 8)) and ("bursty", (6, 9)) in groups
    assert sw.synth_gen_groups(None) is None
    both = workload.stack_specs([workload.stack_specs(specs[:2]),
                                 workload.stack_specs(specs[1::-1])])
    assert sw.synth_gen_groups(both) is None


def test_stack_helpers_match_jax():
    caps_t, caps_j = sw.capacity_scenario_library(), ref_sweep.capacity_scenario_library()
    st, sj = capacity.stack_capacities(caps_t), ref_capacity.stack_capacities(caps_j)
    for f in ("policy_id", "cold_start_s", "keep_alive_s", "target_rate_per_instance",
              "backlog_per_instance", "min_instances"):
        np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(sj, f)))
    fs = failures.failure_scenario_library(seed=3)
    st, sj = failures.stack_failures(fs), ref_failures.stack_failures(
        ref_failures.failure_scenario_library(seed=3))
    assert st.name == sj.name
    np.testing.assert_array_equal(st.key_data, np.asarray(sj.key_data))
    for f in ("revoke_p_enter", "revoke_frac", "deadline_s", "retry_budget"):
        np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(sj, f)))
    wfs = sw.workflow_scenario_library(5)
    st = routing.stack_workflows(wfs)
    sj = ref_routing.stack_workflows(ref_sweep.workflow_scenario_library(5))
    for f in ("route", "source", "sink", "fan_out"):
        np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(sj, f)))


def test_batched_capacity_and_failure_steps_equal_their_rows():
    """A stacked capacity config over (C, W) pools, and a stacked chaos
    axis over (B, W) chains, step for step equal each row run alone; the
    device uniforms are the numpy draws."""
    caps = list(sw.capacity_scenario_library(cold_start_s=3.0))
    st = capacity.stack_capacities(caps).map(lambda x: x[:, None])
    rng = np.random.default_rng(0)
    shape = (len(caps), 3)
    state = capacity.init_capacity_state(1.0, "cpu", batch_shape=shape)
    rows = [[capacity.init_capacity_state(1.0, "cpu") for _ in range(3)] for _ in caps]
    for t in range(12):
        lam, ema, q = (torch.from_numpy(rng.uniform(0, hi, shape).astype(np.float32))
                       for hi in (300.0, 300.0, 120.0))
        if t in (4, 5, 6):
            lam, q = lam * 0, q * 0
        state, warm, pending = capacity.capacity_step(state, st, t, lam, ema, q, 1.0, 8.0)
        for c, cap in enumerate(caps):
            for w in range(3):
                rows[c][w], wr, pr = capacity.capacity_step(
                    rows[c][w], cap, t, lam[c, w], ema[c, w], q[c, w], 1.0, 8.0)
                assert torch.equal(warm[c, w], wr) and torch.equal(pending[c, w], pr)
    specs = failures.failure_scenario_library(seed=1)
    key = prng.key_t(np.stack([s.key_data for s in specs]), "cpu")
    u_rev, u_down = failures.failure_uniforms_t(key, 5, 7, 4)
    for b, s in enumerate(specs):
        nr, nd = failures.failure_uniforms(s, np.arange(5, 12), 4)
        assert torch.equal(u_rev[b], nr) and torch.equal(u_down[b], nd)
    st = failures.stack_failures(specs).map(lambda x: x[:, None])
    st = dataclasses.replace(st, deadline_s=st.deadline_s[..., None])  # per agent (B, 1, 1)
    rev, down = torch.zeros(len(specs), 1), torch.zeros(len(specs), 1, 4)
    alone = [(torch.zeros(()), torch.zeros(4)) for _ in specs]
    retry = torch.zeros(len(specs), 1, failures.RETRY_CLASSES - 1, 4)
    retry_alone = [torch.zeros(failures.RETRY_CLASSES - 1, 4) for _ in specs]
    for j in range(7):
        phi, up, rev, down = failures.advance_failures(st, 5 + j, rev, down, u_rev[:, j:j + 1],
                                                       u_down[:, j:j + 1])
        q, lam, served = (torch.from_numpy(rng.uniform(0, hi, (len(specs), 1, 4)).astype(
            np.float32)) for hi in (200.0, 100.0, 50.0))
        cap_eff = served * 0.9
        new_q, retry, *rest = failures.deadline_step(st, q, lam, served, q + lam - served,
                                                     cap_eff, retry)
        for b, s in enumerate(specs):
            p1, a1, r1, d1 = failures.advance_failures(s, 5 + j, *alone[b], u_rev[b, j],
                                                       u_down[b, j])
            alone[b] = (r1, d1)
            assert torch.equal(phi[b, 0], p1) and torch.equal(up[b, 0], a1), (s.name, j)
            q1, retry_alone[b], *rest1 = failures.deadline_step(
                s, q[b, 0], lam[b, 0], served[b, 0], (q + lam - served)[b, 0], cap_eff[b, 0],
                retry_alone[b])
            assert torch.equal(new_q[b, 0], q1) and torch.equal(retry[b, 0], retry_alone[b])
            for x, y in zip(rest, rest1):
                assert torch.equal(x[b, 0], y)
