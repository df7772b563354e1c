"""The port's arrival generators (``repro_torch/core/workload.py``) and
fleet helpers against the JAX package: every materialized generator and
every spec's ``materialize`` bit for bit (poisson, whose sampler the port
does not reproduce, in distribution), ``step_block`` against B calls of
``workload_step``, the stacked-spec synthesizer against each spec alone,
and ``synthetic_fleet``/``scale_fleet``/``stack_fleets``."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import agents as ref_agents
from repro.core import workload as ref_wl
from repro_torch.core import agents, prng, simulator, workload

RATES = np.asarray(agents.PAPER_ARRIVAL_RATES, np.float32)
STEPS = 37  # no block size below divides it


def _bits(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.asarray(x, np.float32).view(np.uint32)


def _eq(got, want):
    got, want = _bits(got), _bits(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


KEY = jax.random.key(11)
KD = np.asarray(jax.random.key_data(KEY))
# name -> (port call, reference call), exact to the bit
GENERATORS = {
    "constant": (lambda r: workload.constant(r, STEPS), lambda r: ref_wl.constant(r, STEPS)),
    "spike": (lambda r: workload.spike(r, STEPS, 2, 10, 6),
              lambda r: ref_wl.spike(r, STEPS, 2, 10, 6)),
    "scaled": (lambda r: workload.scaled(r, STEPS, 3.0), lambda r: ref_wl.scaled(r, STEPS, 3.0)),
    "dominated": (lambda r: workload.dominated(r, STEPS, 1, 0.9),
                  lambda r: ref_wl.dominated(r, STEPS, 1, 0.9)),
    "diurnal": (lambda r: workload.diurnal(r, 400, period=37, depth=0.4),
                lambda r: ref_wl.diurnal(r, 400, period=37, depth=0.4)),
    "bursty": (lambda r: workload.bursty(r, STEPS, KD), lambda r: ref_wl.bursty(r, STEPS, KEY)),
    "correlated": (lambda r: workload.correlated(r, 200, KD),
                   lambda r: ref_wl.correlated(r, 200, KEY)),
}


@pytest.mark.parametrize("rates", ["paper", "synthetic40"])
@pytest.mark.parametrize("name", list(GENERATORS))
def test_materialized_generator_matches_jax(name, rates):
    r = RATES if rates == "paper" else np.asarray(ref_wl.synthetic_rates(40, seed=3))
    port, ref = GENERATORS[name]
    _eq(port(r), ref(jnp.asarray(r)))


@pytest.mark.parametrize("n", [1, 4, 33, 64, 100, 256, 1024])
def test_synthetic_rates_match_jax(n):
    """The normalizing sum runs in XLA's CPU order, so every width is exact."""
    _eq(workload.synthetic_rates(n, seed=n), ref_wl.synthetic_rates(n, seed=n))
    if n >= 2:
        r = np.asarray(ref_wl.synthetic_rates(n, seed=n))
        _eq(workload.dominated_rates(r, 0), ref_wl.dominated_rates(jnp.asarray(r), 0))


@pytest.mark.parametrize("seed", [0, 5])
def test_scenario_specs_materialize_like_jax(seed):
    """Each spec of the library, run through ``materialize``, equals the
    reference's ``materialize``; poisson in distribution only."""
    r = np.asarray(ref_wl.synthetic_rates(6, seed=seed))
    port = workload.scenario_specs(r, STEPS, seed)
    ref = ref_wl.scenario_specs(jnp.asarray(r), STEPS, seed)
    assert [s.name for s in port] == [s.name for s in ref]
    for p, q in zip(port, ref):
        np.testing.assert_array_equal(p.key_data, np.asarray(q.key_data))
        assert int(p.gen_id) == int(q.gen_id)
        if p.name != "poisson":
            _eq(workload.materialize(p), ref_wl.materialize(q))


def test_fleet_scenario_specs_match_jax():
    vecs = [np.asarray(ref_wl.synthetic_rates(n, seed=n)) for n in (3, 5)]
    names, rows = workload.fleet_scenario_specs(vecs, 6, 12, seed=1)
    ref_names, ref_rows = ref_wl.fleet_scenario_specs(vecs, 6, 12, seed=1)
    assert names == ref_names
    for row, ref_row in zip(rows, ref_rows):
        for p, q in zip(row, ref_row):
            if p.name != "poisson":
                _eq(workload.materialize(p), ref_wl.materialize(q))


def test_poisson_is_poisson_in_distribution():
    """The inverse-CDF sampler over the threefry uniforms: 40000 draws per
    rate, the sample mean within 5 standard errors of λ, the variance
    within 5% of λ, and the histogram's total variation distance from the
    Poisson pmf within 3× what an exact sampler's histogram shows by
    sampling noise alone (its expected value, ½·Σ_k √(2·p_k(1-p_k)/(π·n)));
    a zero rate draws only zeros."""
    from math import lgamma, log

    lam = np.asarray([0.0, 0.7, 9.5, 10.5, 80.0, 285.0], np.float32)
    draws = workload.poisson(lam, 40000, prng.key(4)).numpy()
    assert (draws[:, 0] == 0).all() and (draws == np.round(draws)).all()
    for i, l in enumerate(lam[1:].astype(np.float64), start=1):
        x = draws[:, i]
        assert abs(x.mean() - l) < 5 * np.sqrt(l / len(x)), (l, x.mean())
        assert abs(x.var() / l - 1.0) < 0.05, (l, x.var())
        k = np.arange(int(l + 12 * np.sqrt(l) + 24))
        pmf = np.exp([-l + kk * log(l) - lgamma(kk + 1) for kk in k])
        hist = np.bincount(x.astype(int), minlength=len(k))[:len(k)] / len(x)
        noise = 0.5 * np.sqrt(2.0 / (np.pi * len(x))) * np.sqrt(pmf * (1.0 - pmf)).sum()
        assert 0.5 * np.abs(hist - pmf).sum() < 3.0 * noise, l
    # The spec's draws follow the same law, one uniform per agent and step.
    spec = workload.poisson_spec(lam, 4000, prng.key(2))
    x = workload.materialize(spec).numpy()
    assert (x[:, 0] == 0).all()
    assert abs(x[:, 4].mean() - 80.0) < 5 * np.sqrt(80.0 / 4000)


def _stacked_library():
    r = np.asarray(ref_wl.synthetic_rates(5, seed=2))
    return workload.stack_specs(workload.scenario_specs(r, STEPS, seed=3))


@pytest.mark.parametrize("block", [1, 3, 8, 16])
def test_step_block_equals_b_workload_steps(block):
    """For every generator of the library at once (a stacked spec): B steps
    in one ``step_block`` call equal B ``workload_step`` calls, state
    included, over a horizon B does not divide."""
    spec = _stacked_library()
    state_a = state_b = workload.workload_init(spec, device="cpu")
    for t0 in range(0, STEPS, block):
        b = min(block, STEPS - t0)
        rows, state_a = workload.step_block(spec, state_a, t0, b)
        assert rows.shape == (8, b, 5)
        for j in range(b):
            lam, state_b = workload.workload_step(spec, state_b, t0 + j)
            _eq(rows[:, j], lam)
        _eq(state_a, state_b)


def test_stacked_spec_equals_each_spec_and_gen_fast_path():
    """The stacked synthesizer (rows grouped by generator) gives each row
    what its spec gives alone; ``gen=`` dispatches one generator directly
    and refuses a spec that holds others."""
    specs = workload.scenario_specs(np.asarray(ref_wl.synthetic_rates(5, seed=2)), STEPS, 3)
    stacked = workload.materialize(workload.stack_specs(specs))
    for i, s in enumerate(specs):
        _eq(stacked[i], workload.materialize(s))
    bursty = workload.stack_specs([specs[6], specs[6]])
    synth = workload.Synth(bursty, "cpu", gen="bursty")
    state = synth.init()
    rows, _ = synth.block(state, 0, STEPS)
    _eq(rows[1], workload.materialize(specs[6]))
    with pytest.raises(ValueError, match="other generators"):
        workload.Synth(workload.stack_specs(specs), "cpu", gen="bursty")


LOOP_HELPERS = {
    "workload_init": lambda spec, **kw: workload.workload_init(spec, **kw),
    "Synth": lambda spec, **kw: workload.Synth(spec, **kw).init(),
    "key_t": lambda spec, **kw: prng.key_t(spec.key_data, **kw),
    "init_metric_accum": lambda spec, **kw: simulator.init_metric_accum(4, **kw).lat_sum,
}


@pytest.mark.parametrize("helper", list(LOOP_HELPERS))
def test_loop_helpers_default_to_the_card(helper):
    """The synthesis and accumulation helpers run on ``cuda`` unless the
    caller asks for the host, and refuse without a card, as the entry
    points do."""
    fn = LOOP_HELPERS[helper]
    spec = workload.bursty_spec(RATES, STEPS, KD)
    assert fn(spec, device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert fn(spec).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA device"):
            fn(spec)


def test_spec_errors_and_hatch(monkeypatch):
    with pytest.raises(ValueError, match="unknown workload"):
        workload.make_spec("nope", RATES, 10)
    with pytest.raises(ValueError, match="num_steps"):
        workload.make_spec("constant", RATES, 0)
    with pytest.raises(ValueError, match="one horizon"):
        workload.stack_specs([workload.constant_spec(RATES, 5), workload.constant_spec(RATES, 6)])
    with pytest.raises(ValueError, match=">= 2 agents"):
        workload.dominated_rates(RATES[:1], 0)
    assert workload.workload_names() == ref_wl.workload_names()
    monkeypatch.setenv(workload.SYNTH_ENV, "0")
    assert not workload.synth_env_enabled()
    monkeypatch.setenv(workload.SYNTH_ENV, "1")
    assert workload.synth_env_enabled()


@pytest.mark.parametrize("n", [4, 16, 256, 1024])
def test_synthetic_and_scaled_fleets_match_jax(n):
    got, want = agents.synthetic_fleet(n, seed=n), ref_agents.synthetic_fleet(n, seed=n)
    for f in ("model_size_mb", "base_throughput", "min_gpu", "priority", "active"):
        _eq(getattr(got, f), getattr(want, f))
    got = agents.scale_fleet(agents.paper_fleet(), n + 1)
    want = ref_agents.scale_fleet(ref_agents.paper_fleet(), n + 1)
    assert got.names == want.names
    for f in ("model_size_mb", "base_throughput", "min_gpu", "priority"):
        _eq(getattr(got, f), getattr(want, f))


def test_stack_fleets_matches_jax():
    sizes = (3, 8, 5)
    got = agents.stack_fleets([agents.synthetic_fleet(n, seed=n) for n in sizes])
    want = ref_agents.stack_fleets([ref_agents.synthetic_fleet(n, seed=n) for n in sizes])
    assert got.names == want.names and got.active.shape == (3, 8)
    for f in ("model_size_mb", "base_throughput", "min_gpu", "priority", "active"):
        _eq(getattr(got, f), getattr(want, f))
    with pytest.raises(ValueError, match="unpadded"):
        agents.scale_fleet(agents.pad_fleet(agents.paper_fleet(), 6), 8)
