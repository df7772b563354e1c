"""The port's trace simulator (``repro_torch/core/simulator.py``) against
the JAX package's ``simulate`` and the port's float64 numpy oracle
(``core/reference_sim.py::simulate_numpy``, held to the reference's own
in ``tests/test_torch_reference_sim.py``), for every registered policy: with no serverless
layer, with workflows, with elastic capacity, with failures (two injectors
and more) and with all three on, at the reference's own tolerances.  Also:
the feature-off contracts in the port, conservation, misrouted mass, and
the Table II anchors."""
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
from repro_torch.core import agents, capacity, failures, routing, simulator, workload
from repro_torch.core.reference_sim import simulate_numpy
from repro_torch.core import allocator as alloc

POLICIES = alloc.policy_names()
RATES = np.asarray(agents.PAPER_ARRIVAL_RATES, np.float32)
STEPS = 40


def _poisson(seed, scale=1.0, steps=STEPS):
    return np.random.default_rng(seed).poisson(RATES * scale, (steps, 4)).astype(np.float32)


def _onoff(steps=STEPS, on_until=10, scale=0.2):
    arr = np.zeros((steps, 4), np.float32)
    arr[:on_until] = RATES * scale
    return arr


# feature -> (layers from one package's modules, config, arrivals, kind of tolerance)
FEATURES = {
    "none": (lambda r, c, f: {}, {}, _poisson(0), "plain"),
    "coordinator_star": (lambda r, c, f: {"workflow": r.coordinator_star(4, fan_out=2.0)},
                         {}, _poisson(1), "plain"),
    "hierarchical": (lambda r, c, f: {"workflow": r.hierarchical(4)}, {}, _poisson(2), "plain"),
    "synthetic": (lambda r, c, f: {"workflow": r.synthetic_workflow(4, seed=3)},
                  {}, _poisson(3), "plain"),
    "reactive": (lambda r, c, f: {"capacity": c.capacity_config(
        "reactive", cold_start_s=3.0, min_instances=1.0)}, {"num_gpus": 8.0},
        _poisson(4, 3.0), "plain"),
    "scale_to_zero": (lambda r, c, f: {"capacity": c.capacity_config(
        "scale_to_zero", keep_alive_s=4.0, cold_start_s=2.0)}, {"num_gpus": 8.0},
        _onoff(), "plain"),
    # tests/test_failures.py's CHAOS: revocation, flaky agents and deadlines
    "failures": (lambda r, c, f: {"failures": f.failure_spec(
        "chaos", revoke_p_enter=0.15, revoke_p_exit=0.4, revoke_frac=0.7,
        fail_p_enter=0.05, fail_p_exit=0.5, deadline_s=3.0, retry_budget=1, seed=3)},
        {}, _poisson(5), "failures"),
    "all": (lambda r, c, f: {
        "workflow": r.coordinator_star(4),
        "capacity": c.capacity_config("reactive", cold_start_s=3.0, min_instances=1.0),
        "failures": f.failure_scenario_library(seed=2)[-1]}, {"num_gpus": 8.0},
        _poisson(6, 2.0), "failures"),
}
# Where the JAX package's own trace leaves its numpy oracle's tolerance
# (ROADMAP C): with all three layers on, objective_descent's projected
# gradient lands on another allocation at one step in float32 than in
# float64.  There the port is held to JAX as everywhere, and to the oracle
# within JAX's own distance from it.
REFERENCE_ORACLE_GAPS = {("all", "objective_descent")}
FIELDS = ("allocation", "served", "queue", "latency", "completed", "warm", "pending")
FAILURE_FIELDS = ("dropped", "retried", "expired", "recovery")


def _port(feature, policy):
    layers, cfg, arr, _ = FEATURES[feature]
    return simulator.simulate(policy, arr, agents.paper_fleet(), simulator.SimConfig(**cfg),
                              device="cpu", **layers(routing, capacity, failures))


@functools.lru_cache(maxsize=None)
def _reference(feature, policy):
    """(JAX trace fields, the port's numpy-oracle fields) as float64 arrays."""
    layers, cfg, arr, _ = FEATURES[feature]
    kw = layers(ref_routing, ref_capacity, ref_failures)
    tr = ref_sim.simulate(policy, jnp.asarray(arr), ref_agents.paper_fleet(),
                          ref_sim.SimConfig(**cfg), **kw)
    want = {f: np.asarray(getattr(tr, f), np.float64) for f in FIELDS + FAILURE_FIELDS}
    oracle = simulate_numpy(policy, arr, agents.paper_fleet(), num_gpus=cfg.get("num_gpus", 1.0),
                            **layers(routing, capacity, failures))
    return want, oracle


def _assert_close(got, want, kind, what, slack=None):
    """The reference's tolerances; ``slack`` (per field, elementwise) widens
    the failures tolerance by a known reference-side distance."""
    for field in want:
        g, w = got[field], want[field]
        if slack is not None:
            scale = max(np.abs(w).max(), 1.0)
            bad = np.abs(g - w) > 5e-3 * scale + 5e-3 * np.abs(w) + slack[field]
            assert not bad.any(), f"{what}/{field}: {np.argwhere(bad)[:5]}"
        elif kind == "failures":
            scale = max(np.abs(w).max(), 1.0)
            np.testing.assert_allclose(g, w, rtol=5e-3, atol=5e-3 * scale,
                                       err_msg=f"{what}/{field}")
        else:
            atol = 0.5 if field == "queue" else 2e-3
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=atol, err_msg=f"{what}/{field}")


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("feature", list(FEATURES))
def test_simulate_matches_jax_and_the_oracle(feature, policy):
    kind = FEATURES[feature][3]
    tr = _port(feature, policy)
    got = {f: getattr(tr, f).numpy().astype(np.float64) for f in FIELDS + FAILURE_FIELDS}
    want, oracle = _reference(feature, policy)
    fields = FIELDS + (FAILURE_FIELDS if kind == "failures" else ())
    _assert_close(got, {f: want[f] for f in fields}, kind, f"{feature}/{policy} vs jax")
    fields = [f for f in fields if f in oracle]
    slack = None
    if (feature, policy) in REFERENCE_ORACLE_GAPS:
        with pytest.raises(AssertionError):  # the gap is the reference's own
            _assert_close(want, {f: oracle[f] for f in fields}, kind, "jax vs oracle")
        slack = {f: np.abs(want[f] - oracle[f]) for f in fields}
    _assert_close(got, {f: oracle[f] for f in fields}, kind,
                  f"{feature}/{policy} vs oracle", slack)


@pytest.mark.parametrize("feature", ["coordinator_star", "reactive", "failures", "all"])
def test_feature_actually_moves_the_trace(feature):
    tr = _port(feature, "adaptive")
    if feature in ("coordinator_star", "all"):
        assert (tr.served[:, 1:].sum() > 0) and (tr.arrivals[:, 1:].sum() == 0)
        assert (tr.completed[:, 0] == 0).all()
    if feature in ("reactive", "all"):
        assert tr.warm.max() > 1.0 and tr.pending.max() > 0
    if feature in ("failures", "all"):
        assert tr.expired.sum() > 0 and tr.dropped.sum() > 0 and tr.recovery.sum() > 0


@pytest.mark.parametrize("policy", POLICIES)
def test_summary_metrics_match_jax(policy):
    """``run_policy``'s whole METRIC_NAMES vector with all three layers on."""
    layers, cfg, arr, _ = FEATURES["all"]
    got = simulator.run_policy(policy, arr, agents.paper_fleet(), simulator.SimConfig(**cfg),
                               device="cpu", **layers(routing, capacity, failures))
    want = ref_sim.run_policy(policy, jnp.asarray(arr), ref_agents.paper_fleet(),
                              ref_sim.SimConfig(**cfg),
                              **layers(ref_routing, ref_capacity, ref_failures))
    assert simulator.METRIC_NAMES == ref_sim.METRIC_NAMES
    for name in simulator.METRIC_NAMES + ("per_agent_latency", "per_agent_throughput",
                                          "per_agent_queue"):
        g, w = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        scale = max(np.abs(w).max(), 1.0)
        np.testing.assert_allclose(g, w, rtol=5e-3, atol=5e-3 * scale, err_msg=name)


def _bits(tr):
    return {k: v.numpy().view(np.int32) for k, v in tr.fields().items()}


@pytest.mark.parametrize("policy", POLICIES)
def test_feature_off_contracts_hold_bit_for_bit(policy):
    """``independent(n)``, ``fixed`` capacity with no cold start and a
    disabled failure spec each give the feature-off trajectories exactly."""
    arr, fleet = _poisson(7), agents.paper_fleet()
    run = lambda **kw: _bits(simulator.simulate(policy, arr, fleet, device="cpu", **kw))
    base = run()
    for kw in ({"workflow": routing.independent(4)},
               {"capacity": capacity.capacity_config("fixed")},
               {"failures": failures.failure_spec("none")}):
        got = run(**kw)
        for field, want in base.items():
            np.testing.assert_array_equal(got[field], want, err_msg=f"{kw}/{field}")


def test_kill_switch_gives_the_feature_off_run(monkeypatch):
    arr, fleet = _poisson(8), agents.paper_fleet()
    base = simulator.simulate("adaptive", arr, fleet, device="cpu")
    monkeypatch.setenv(failures.FAILURE_ENV, "0")
    killed = simulator.simulate("adaptive", arr, fleet, device="cpu",
                                failures=failures.failure_scenario_library()[-1])
    assert torch.equal(base.served, killed.served) and killed.dropped.sum() == 0


@pytest.mark.parametrize("seed", [0, 11, 7])
def test_queue_mass_is_conserved_under_failures(seed):
    """tests/test_failures.py's balance: arrived = served + dropped + final
    queue, within the dead band's slack per agent-step."""
    steps = 40
    spec = failures.failure_spec("mix", revoke_p_enter=0.1, revoke_p_exit=0.4,
                                 revoke_frac=0.6, deadline_s=2.5, retry_budget=2, seed=seed)
    tr = simulator.simulate("adaptive", _poisson(seed, 1.5, steps), agents.paper_fleet(),
                            failures=spec, device="cpu")
    arrived, served = float(tr.arrivals.sum()), float(tr.served.sum())
    dropped, final_q = float(tr.dropped.sum()), float(tr.queue[-1].sum())
    assert dropped > 0
    np.testing.assert_allclose(arrived, served + dropped + final_q, rtol=1e-3,
                               atol=steps * 4 * 1e-4 + 0.05)


def test_routing_into_padding_is_misrouted_and_accounted():
    """tests/test_routing.py's balance on a padded fleet: stage 3 of an
    8-stage chain forwards into a padded slot."""
    fleet, wf = agents.pad_fleet(agents.paper_fleet(), 8), routing.pipeline_chain(8)
    arr = np.pad(workload.constant(RATES, 50).numpy(), ((0, 0), (0, 4)))
    tr = simulator.simulate("adaptive", arr, fleet, workflow=wf, device="cpu")
    mis = tr.misrouted.numpy()
    assert mis.sum() > 0 and (mis[:, :4] == 0).all()
    pending = (tr.served[-1] * wf.fan_out) @ wf.route
    in_flight = float(tr.queue[-1].sum() + (pending * fleet.active).sum())
    np.testing.assert_allclose(float(tr.arrivals.sum()),
                               float(tr.completed.sum()) + mis.sum() + in_flight, rtol=1e-4)
    ref_tr = ref_sim.simulate("adaptive", jnp.asarray(arr),
                              ref_agents.pad_fleet(ref_agents.paper_fleet(), 8),
                              workflow=ref_routing.pipeline_chain(8))
    np.testing.assert_allclose(mis, np.asarray(ref_tr.misrouted), rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("warm", [1.0, 3.0])
@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0), (2.0, 0.5, 10.0)])
def test_step_objective_matches_the_reference(weights, warm):
    from repro.core import objective as ref_objective
    from repro_torch.core import objective

    rng = np.random.default_rng(int(warm))
    for _ in range(10):
        g, queue, lam = (rng.uniform(0, s, 4).astype(np.float32) for s in (1, 300, 200))
        want = ref_objective.step_objective(
            *map(jnp.asarray, (g, queue, lam, RATES)), ref_objective.ObjectiveWeights(*weights),
            warm_instances=warm)
        got = objective.step_objective(
            *map(torch.from_numpy, (g, queue, lam, RATES)), objective.ObjectiveWeights(*weights),
            warm_instances=warm)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# Table II anchors (.claude/skills/verify/SKILL.md), rounded as
# benchmarks/table2_metrics.py rounds them.
def test_table2_anchors():
    arr, fleet = workload.constant(agents.PAPER_ARRIVAL_RATES, 100), agents.paper_fleet()
    assert float(arr.sum(dim=1)[0]) == workload.PAPER_TOTAL_RATE
    rows = {p: simulator.run_policy(p, arr, fleet, device="cpu") for p in POLICIES}
    assert round(rows["static_equal"].avg_latency, 1) == 110.3
    assert round(rows["adaptive"].avg_latency, 1) == 111.9
    assert round(rows["adaptive"].total_throughput, 2) == 58.12
    assert abs(round(rows["round_robin"].avg_latency, 1) - 756.1) <= 1.0
    assert {round(r.cost, 3) for r in rows.values()} == {0.020}


def test_simulate_refuses_what_the_reference_refuses():
    arr, fleet = _poisson(0), agents.paper_fleet()
    with pytest.raises(ValueError, match="unknown policy"):
        simulator.simulate("nope", arr, fleet, device="cpu")
    with pytest.raises(ValueError, match="pad_workflow"):
        simulator.simulate("adaptive", arr, fleet, workflow=routing.coordinator_star(3),
                           device="cpu")
    with pytest.raises(ValueError, match="cold_start_s"):
        simulator.simulate("adaptive", arr, fleet, device="cpu",
                           capacity=capacity.capacity_config("reactive", cold_start_s=40.0))
    with pytest.raises(ValueError, match="instance ceiling"):
        simulator.SimConfig(g_total=2.0)


def test_simulate_runs_on_the_card_by_default():
    """No fallback: the default device is ``cuda``, and without one the
    entry points raise instead of moving to the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; tests/test_torch_cuda.py runs the card path")
    with pytest.raises(RuntimeError, match="CUDA"):
        simulator.simulate("adaptive", _poisson(0), agents.paper_fleet())
    with pytest.raises(RuntimeError, match="CUDA"):
        simulator.run_policy("adaptive", _poisson(0), agents.paper_fleet())
