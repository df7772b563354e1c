"""The port's streaming simulator (``simulate_stream_core``) against the
JAX package's and against the port's own trace oracle
(``trace_metrics(simulate_core(...))``), for every registered policy with
no serverless layer, a workflow, reactive capacity, failures and all three;
every block size bit for bit; loop synthesis bit for bit the materialized
spec.  Tolerance: ``tests/test_streaming.py``'s RTOL = ATOL = 1e-3."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.core import agents as ref_agents
from repro.core import capacity as ref_capacity
from repro.core import failures as ref_failures
from repro.core import routing as ref_routing
from repro.core import simulator as ref_sim
from repro_torch.core import agents, allocator as alloc, capacity, failures, routing
from repro_torch.core import simulator, workload

RTOL = ATOL = 1e-3
STEPS = 24
RATES = np.asarray(agents.PAPER_ARRIVAL_RATES, np.float32)
ARRIVALS = np.random.default_rng(7).poisson(RATES, (STEPS, 4)).astype(np.float32)

# feature -> (layers from one package's modules, config knobs)
FEATURES = {
    "none": (lambda r, c, f: {}, {}),
    "workflow": (lambda r, c, f: {"workflow": r.coordinator_star(4, fan_out=2.0)}, {}),
    "reactive": (lambda r, c, f: {"capacity": c.capacity_config(
        "reactive", cold_start_s=3.0, min_instances=1.0)}, {"num_gpus": 8.0}),
    "failures": (lambda r, c, f: {"failures": f.failure_scenario_library(seed=2)[-1]}, {}),
    "all": (lambda r, c, f: {
        "workflow": r.hierarchical(4),
        "capacity": c.capacity_config("reactive", cold_start_s=3.0, min_instances=1.0),
        "failures": f.failure_scenario_library(seed=2)[-1]}, {"num_gpus": 8.0}),
}


@functools.lru_cache(maxsize=None)
def _jax_stream(feature):
    layers, cfg = FEATURES[feature]
    out = ref_sim.simulate_stream_core(
        jnp.asarray(ARRIVALS), ref_agents.paper_fleet(), ref_sim.SimConfig(**cfg),
        **layers(ref_routing, ref_capacity, ref_failures))
    return tuple(np.asarray(x) for x in out)


def _port_stream(feature, arrivals=ARRIVALS, **kw):
    layers, cfg = FEATURES[feature]
    return simulator.simulate_stream_core(
        torch.from_numpy(np.ascontiguousarray(arrivals)), agents.paper_fleet(),
        simulator.SimConfig(**cfg), **layers(routing, capacity, failures), **kw)


@pytest.mark.parametrize("feature", list(FEATURES))
def test_stream_matches_jax_stream_and_the_trace_oracle(feature):
    got = [x.numpy() for x in _port_stream(feature)]
    want = _jax_stream(feature)
    for g, w, what in zip(got, want, ("metrics", "latency", "throughput", "queue")):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=f"{feature}/{what} vs jax")
    layers, cfg = FEATURES[feature]
    kw = layers(routing, capacity, failures)
    config = simulator.SimConfig(**cfg)
    for i, policy in enumerate(alloc.policy_names()):
        tr = simulator.simulate(policy, ARRIVALS, agents.paper_fleet(), config, device="cpu", **kw)
        oracle = simulator.trace_metrics(tr, tr.arrivals.new_ones(4), kw.get("workflow"),
                                         config=config)
        for g, w in zip(got, oracle):
            np.testing.assert_allclose(g[i], w.numpy(), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{feature}/{policy} vs the trace oracle")


def test_stream_with_cell_axes_equals_each_cell():
    """Scenario cells (W, S, N) in one stream give each cell's own run."""
    arr = np.stack([ARRIVALS, ARRIVALS * 2.0, ARRIVALS[::-1].copy()])
    together = _port_stream("all", arr)
    for w in range(3):
        alone = _port_stream("all", arr[w])
        for a, b in zip(together, alone):
            np.testing.assert_allclose(a[w].numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _specs():
    return workload.stack_specs(workload.scenario_specs(workload.synthetic_rates(4, seed=1),
                                                        STEPS + 5, seed=4))


@pytest.mark.parametrize("feature", ["none", "all"])
def test_every_block_size_gives_the_same_metrics(feature):
    """Loop synthesis of the whole library, bit for bit at B = 1, 3, 8, 16
    (29 steps: no B > 1 divides it), and bit for bit the materialized
    spec's run."""
    layers, cfg = FEATURES[feature]
    run = lambda **kw: simulator.simulate_stream_core(
        config=simulator.SimConfig(**cfg), fleet=agents.paper_fleet(),
        **layers(routing, capacity, failures), **kw)
    base = run(arrivals=None, workload_spec=_specs(), block_size=1)
    assert base[0].shape == (8, len(alloc.policy_names()), len(simulator.METRIC_NAMES))
    for b in (3, 8, 16):
        for x, y in zip(run(arrivals=None, workload_spec=_specs(), block_size=b), base):
            assert torch.equal(x, y), b
    materialized = run(arrivals=workload.materialize(_specs()))
    for x, y in zip(materialized, base):
        assert torch.equal(x, y)


def test_block_size_env_and_errors(monkeypatch):
    monkeypatch.setenv(simulator.BLOCK_ENV, "5")
    assert simulator.resolve_block_size() == 5
    assert simulator.resolve_block_size(2) == 2
    monkeypatch.delenv(simulator.BLOCK_ENV)
    assert simulator.resolve_block_size() == 1
    with pytest.raises(ValueError, match="block_size"):
        simulator.resolve_block_size(0)
    fleet, cfg = agents.paper_fleet(), simulator.SimConfig()
    with pytest.raises(ValueError, match="exactly one"):
        simulator.simulate_stream_core(None, fleet, cfg)


def test_policy_blocks_are_rows_of_the_whole():
    """A stream over a block of the registry gives that block's rows of
    the whole registry's stream: the policy rows do not interact."""
    names = alloc.policy_names()
    assert len(names) == 9
    whole = _port_stream("all")
    for k in range(3):
        part = _port_stream("all", policy_names=names[3 * k:3 * k + 3])
        for a, b in zip(part, whole):
            assert torch.equal(a, b[3 * k:3 * k + 3])


def test_metric_sums_match_the_trace_reduction():
    """``accumulate_metrics`` over a trace's steps, finalized, is
    ``trace_metrics`` of the trace (one metric definition)."""
    config = simulator.SimConfig(num_gpus=8.0)
    kw = FEATURES["all"][0](routing, capacity, failures)
    tr = simulator.simulate("adaptive", ARRIVALS, agents.paper_fleet(), config, device="cpu",
                            **kw)
    active = torch.ones(4)
    acc = simulator.init_metric_accum(4, device="cpu")
    for t in range(STEPS):
        acc = simulator.accumulate_metrics(
            acc, active, tr.allocation[t], tr.served[t], tr.queue[t], tr.latency[t],
            tr.completed[t], tr.warm[t], tr.pending[t], misrouted=tr.misrouted[t],
            dropped=tr.dropped[t], retried=tr.retried[t], viol=tr.expired[t],
            recovery=tr.recovery[t])
    got = simulator.finalize_metrics(acc, STEPS, active, kw["workflow"], config=config)
    want = simulator.trace_metrics(tr, active, kw["workflow"], config=config)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-5)
