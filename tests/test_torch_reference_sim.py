"""The port's float64 numpy oracle (``repro_torch/core/reference_sim.py``)
against the reference's (``repro/core/reference_sim.py``), and the port's
simulator against it.

* ``simulate_numpy`` equals the reference oracle bit for bit for every
  policy under each layer setting of ``tests/test_torch_simulator.py``'s
  ``FEATURES``, and at the tiny and subnormal rates where the oracles
  leave the float32 simulators.
* ``synthesize_loop`` equals the port's ``materialize`` bit for bit for all
  six generators at B = 1, 3, 7, and the reference's loop for every
  generator but ``poisson`` (the port's own sampler).
* The counterpart of ``tests/test_reference_sim.py::test_scan_matches_numpy_oracle``:
  the same strategy, every draw held to the oracle, to JAX's ``simulate``
  or to the invariants, by the rule in ``_draw_class``.
"""
import functools

import hypothesis
import hypothesis.strategies as st
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.core import agents as ref_agents
from repro.core import reference_sim as ref_oracle
from repro.core import simulator as ref_sim
from repro.core import workload as ref_workload
from repro_torch.core import agents, allocator as alloc, capacity, failures, routing
from repro_torch.core import reference_sim, simulator, workload

import test_torch_simulator as sim_tests

FIELDS = ("allocation", "served", "queue", "latency", "completed")
R = np.asarray(agents.paper_fleet().min_gpu, np.float32)
T = np.asarray(agents.paper_fleet().base_throughput, np.float32)
P = np.asarray(agents.paper_fleet().priority, np.float32)
F32_TINY = np.finfo(np.float32).tiny  # the smallest normal float32
GUARD = 1e-9                          # allocator._EPS: the simulators' guard


def test_oracle_covers_the_whole_registry_as_the_reference():
    assert set(alloc.policy_names()) <= set(reference_sim.SUPPORTED_POLICIES)
    assert reference_sim.SUPPORTED_POLICIES == ref_oracle.SUPPORTED_POLICIES


def test_oracle_rejects_unknown_policy():
    with pytest.raises(ValueError, match="nope"):
        reference_sim.simulate_numpy("nope", np.zeros((3, 4)), agents.paper_fleet())


def _both_oracles(policy, feature=None, arrivals=None):
    """(port oracle, reference oracle) on the same inputs."""
    from repro.core import capacity as ref_capacity
    from repro.core import failures as ref_failures
    from repro.core import routing as ref_routing

    kw_port, kw_ref, cfg = {}, {}, {}
    if feature is not None:
        layers, cfg, arrivals, _ = sim_tests.FEATURES[feature]
        kw_port = layers(routing, capacity, failures)
        kw_ref = layers(ref_routing, ref_capacity, ref_failures)
    num_gpus = cfg.get("num_gpus", 1.0)
    got = reference_sim.simulate_numpy(policy, arrivals, agents.paper_fleet(),
                                       num_gpus=num_gpus, **kw_port)
    want = ref_oracle.simulate_numpy(policy, arrivals, ref_agents.paper_fleet(),
                                     num_gpus=num_gpus, **kw_ref)
    return got, want


def _assert_bits(got, want, what):
    assert set(got) == set(want)
    for field in want:
        assert got[field].dtype == want[field].dtype, f"{what}/{field}"
        np.testing.assert_array_equal(got[field], want[field], err_msg=f"{what}/{field}")


@pytest.mark.parametrize("feature", list(sim_tests.FEATURES))
def test_oracle_equals_the_reference_oracle(feature):
    for policy in reference_sim.SUPPORTED_POLICIES:
        got, want = _both_oracles(policy, feature)
        _assert_bits(got, want, f"{feature}/{policy}")


# Motivation's inputs: a total under the guard with normal floats, a rate
# whose float32 demand underflows, and a subnormal rate.
TINY_RATES = [(0.0, 0.0, 0.0, 1e-30), (0.0, 0.0, 1e-8, 0.0), (0.0, 0.0, 0.0, 1.4e-45),
              (1e-40, 0.0, 1e-8, 0.0), (3e-39, 50.0, 0.0, 1e-12), (0.0, 0.0, 0.0, 0.0)]


@pytest.mark.parametrize("rates", TINY_RATES, ids=str)
def test_oracle_equals_the_reference_oracle_at_tiny_and_subnormal_rates(rates):
    arr = np.tile(np.asarray(rates, np.float32), (8, 1))
    for policy in reference_sim.SUPPORTED_POLICIES:
        got, want = _both_oracles(policy, arrivals=arr)
        _assert_bits(got, want, f"{rates}/{policy}")


STEPS_SYNTH = 17


@functools.lru_cache(maxsize=None)
def _reference_loops():
    """The reference loop's rows of its scenario specs, at B = 1 (its own
    tests hold every B to them)."""
    specs = ref_workload.scenario_specs(ref_workload.synthetic_rates(4, seed=1), STEPS_SYNTH,
                                        seed=2)
    return tuple(ref_oracle.synthesize_loop(s) for s in specs)


@pytest.mark.parametrize("block_size", [1, 3, 7])
def test_synthesize_loop_equals_materialize_and_the_reference_loop(block_size):
    specs = workload.scenario_specs(workload.synthetic_rates(4, seed=1), STEPS_SYNTH, seed=2)
    gens = set()
    for spec, want in zip(specs, _reference_loops()):
        gen = workload.workload_names()[int(spec.gen_id)]
        gens.add(gen)
        got = reference_sim.synthesize_loop(spec, block_size=block_size)
        assert got.dtype == np.float64 and got.shape == (STEPS_SYNTH, 4)
        np.testing.assert_array_equal(got, workload.materialize(spec).numpy().astype(np.float64),
                                      err_msg=f"{spec.name} B={block_size}")
        if gen != "poisson":  # the port's inverse-CDF sampler (ROADMAP C)
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{spec.name} vs the reference B={block_size}")
    assert gens == set(workload.workload_names()) and len(gens) == 6
    with pytest.raises(ValueError, match="block_size"):
        reference_sim.synthesize_loop(specs[0], block_size=0)


# -- the simulator against the oracle, the reference's strategy ---------------


def _guarded_total(policy, rates32):
    """The float32 total a policy's allocation divides by at step 0 (no
    queue yet; the EMA starts at the rates), summed in float64 as the
    allocator sums it; None for policies with no guarded total."""
    if policy in ("adaptive", "predictive", "objective_descent"):
        x = rates32 * R / P
    elif policy in ("water_filling", "ema_water_filling"):
        x = rates32 / T
    elif policy == "sqrt_demand":
        x = np.sqrt(rates32 / T)
    else:
        return None, None
    return x, float(x.sum(dtype=np.float64))


def _draw_class(policy, rates32) -> str:
    """Which of three things a draw is held to:

    * ``"subnormal"``: a positive rate, or its float32 demand, is below the
      smallest normal float32 — JAX's CPU flushes it, the port keeps it:
      the invariants, and the port's floor for each busy agent;
    * ``"guard"``: the policy's positive total is under the simulators'
      1e-9 guard, all floats normal — the oracle divides unguarded
      (``reference_sim`` docstring): JAX's ``simulate``, bit for bit;
    * ``"oracle"``: otherwise — the oracle at rtol 2e-4, atol 2e-3.
    """
    demand, total = _guarded_total(policy, rates32)
    pos = rates32[rates32 > 0]
    if (pos < F32_TINY).any() or (demand is not None and
                                  ((demand > 0) & (demand < F32_TINY)).any()):
        return "subnormal"
    if total is not None and 0 < total < GUARD:
        return "guard"
    return "oracle"


def _check_draw(policy, rates, steps):
    arr = np.tile(np.asarray(rates, np.float32), (steps, 1))
    rates32 = arr[0]
    kind = _draw_class(policy, rates32)
    tr = simulator.simulate(policy, arr, agents.paper_fleet(), device="cpu")
    got = {f: getattr(tr, f).numpy() for f in FIELDS}
    if kind == "oracle":
        ref = reference_sim.simulate_numpy(policy, arr, agents.paper_fleet())
        for f in FIELDS:
            np.testing.assert_allclose(got[f].astype(np.float64), ref[f], rtol=2e-4, atol=2e-3,
                                       err_msg=f"{policy}/{f} {rates}")
    elif kind == "guard":
        jt = ref_sim.simulate(policy, jnp.asarray(arr), ref_agents.paper_fleet())
        for f in FIELDS:
            np.testing.assert_array_equal(got[f], np.asarray(getattr(jt, f)),
                                          err_msg=f"{policy}/{f} {rates}")
    else:
        g = got["allocation"].astype(np.float64)
        assert (g >= 0).all() and (g.sum(-1) <= 1.0 + 1e-6).all(), (policy, rates)
        arrived = np.cumsum(arr.astype(np.float64), axis=0)
        served = np.cumsum(got["served"].astype(np.float64), axis=0)
        np.testing.assert_allclose(arrived, served + got["queue"], rtol=1e-5, atol=1e-3,
                                   err_msg=f"{policy} conservation {rates}")
        demand, _ = _guarded_total(policy, rates32)
        busy = (demand if demand is not None else rates32) > 0
        if policy not in ("static_equal", "round_robin"):
            # The port keeps a subnormal demand: every busy agent has a share.
            assert (g[0][busy] > 0).all(), (policy, rates, g[0])
    return kind


@hypothesis.given(
    rates=st.lists(st.floats(0, 300), min_size=4, max_size=4),
    policy=st.sampled_from(reference_sim.SUPPORTED_POLICIES),
    steps=st.integers(5, 40),
)
@hypothesis.settings(max_examples=60, deadline=None)
def test_scan_matches_numpy_oracle(rates, policy, steps):
    _check_draw(policy, rates, steps)


def test_the_tiny_rates_reach_every_class():
    kinds = {_draw_class(p, np.asarray(r, np.float32))
             for p in reference_sim.SUPPORTED_POLICIES for r in TINY_RATES}
    assert kinds == {"oracle", "guard", "subnormal"}


@pytest.mark.parametrize("policy", reference_sim.SUPPORTED_POLICIES)
@pytest.mark.parametrize("rates", TINY_RATES, ids=str)
def test_each_class_holds_at_the_tiny_rates(rates, policy):
    """Every policy at Motivation's inputs goes through the same rule."""
    _check_draw(policy, rates, 8)


@pytest.mark.parametrize("policy,rates,sim_row,oracle_row", [
    ("adaptive", (0.0, 0.0, 0.0, 1e-30), (0.1, 0.3, 0.25, 0.35),
     (0.0606, 0.1818, 0.1515, 0.6061)),
    ("water_filling", (0.0, 0.0, 1e-8, 0.0), (0.0, 0.0, 0.25, 0.0), (0.0, 0.0, 1.0, 0.0)),
])
def test_the_guard_divergence_is_pinned(policy, rates, sim_row, oracle_row):
    """A total under the guard with normal floats: the port equals JAX bit
    for bit, the two oracles agree with each other, and they differ from
    the simulators by the amounts the oracle's docstring gives."""
    arr = np.tile(np.asarray(rates, np.float32), (6, 1))
    assert _draw_class(policy, arr[0]) == "guard"
    tr = simulator.simulate(policy, arr, agents.paper_fleet(), device="cpu")
    jt = ref_sim.simulate(policy, jnp.asarray(arr), ref_agents.paper_fleet())
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tr, f).numpy(), np.asarray(getattr(jt, f)),
                                      err_msg=f)
    got, want = _both_oracles(policy, arrivals=arr)
    _assert_bits(got, want, policy)
    for t in range(arr.shape[0]):
        np.testing.assert_allclose(tr.allocation[t].numpy(), sim_row, atol=1e-6)
        np.testing.assert_allclose(got["allocation"][t], oracle_row, atol=1e-4)
    assert np.abs(tr.allocation.numpy() - got["allocation"]).max() > 0.05
