"""The port's failure injection (``repro_torch/core/failures.py``) against
``repro/core/failures.py``: the uniforms bit for bit, the chains and the
deadline accounting on the same inputs drawn with numpy, the checks, the
scenario library and the kill switch."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import failures as ref
from repro_torch.core import failures

N = 4
KNOBS = dict(revoke_p_enter=0.3, revoke_p_exit=0.4, revoke_frac=0.6, fail_p_enter=0.2,
             fail_p_exit=0.5, outage_start=3, outage_len=4, outage_agent=2,
             deadline_s=2.5, retry_budget=2)


def _specs(seed=3, **kw):
    kw = {**KNOBS, **kw}
    return ref.failure_spec("x", seed=seed, **kw), failures.failure_spec("x", seed=seed, **kw)


@pytest.mark.parametrize("n", [1, 4, 7])
@pytest.mark.parametrize("seed", [0, 3, 99])
def test_failure_uniforms_are_bit_identical(seed, n):
    ref_spec, spec = _specs(seed)
    np.testing.assert_array_equal(spec.key_data, np.asarray(ref_spec.key_data))
    ts = np.arange(60)
    u_rev, u_down = failures.failure_uniforms(spec, ts, n)
    want = jax.vmap(lambda t: ref.failure_uniforms(ref_spec, t, n))(jnp.asarray(ts))
    np.testing.assert_array_equal(u_rev.numpy().view(np.uint32),
                                  np.asarray(want[0]).view(np.uint32))
    np.testing.assert_array_equal(u_down.numpy().view(np.uint32),
                                  np.asarray(want[1]).view(np.uint32))
    one_rev, one_down = failures.failure_uniforms(spec, 17, n)  # one step: pure in t
    assert one_rev.shape == () and one_down.shape == (n,)
    assert float(one_rev) == float(u_rev[17])
    np.testing.assert_array_equal(one_down.numpy(), u_down[17].numpy())


@pytest.mark.parametrize("seed", [0, 5])
def test_advance_failures_matches_the_reference(seed):
    """The chains carried for 60 steps on both sides: phi, up and the chain
    states agree at every step (the scheduled outage included)."""
    ref_spec, spec = _specs(seed)
    rev, down = torch.zeros(()), torch.zeros(N)
    ref_rev, ref_down = jnp.zeros(()), jnp.zeros(N)
    states = set()
    for t in range(60):
        u = failures.failure_uniforms(spec, t, N)
        ref_u = ref.failure_uniforms(ref_spec, t, N)
        phi, up, rev, down = failures.advance_failures(spec, t, rev, down, *u)
        rphi, rup, ref_rev, ref_down = ref.advance_failures(ref_spec, t, ref_rev, ref_down, *ref_u)
        for got, want in ((phi, rphi), (up, rup), (rev, ref_rev), (down, ref_down)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
        states.add((float(phi), tuple(up.tolist())))
    assert len(states) > 3


@pytest.mark.parametrize("deadline", [2.5, [0.0, 1.0, 3.0, 0.5], 0.0])
@pytest.mark.parametrize("budget", [0, 1, 3])
def test_deadline_step_matches_the_reference(budget, deadline):
    ref_spec, spec = _specs(deadline_s=deadline, retry_budget=budget)
    rng = np.random.default_rng(budget)
    for _ in range(20):
        queue = rng.uniform(0, 200, N).astype(np.float32)
        lam = rng.uniform(0, 100, N).astype(np.float32)
        served = (rng.uniform(0, 1, N) * (queue + lam)).astype(np.float32)
        q_post = queue + lam - served
        cap_eff = rng.uniform(1, 60, N).astype(np.float32)
        retry_q = (rng.uniform(0, 0.3, (failures.RETRY_CLASSES - 1, N)) * queue).astype(np.float32)
        args = (queue, lam, served, q_post, cap_eff, retry_q)
        got = failures.deadline_step(spec, *map(torch.from_numpy, args))
        want = ref.deadline_step(ref_spec, *map(jnp.asarray, args))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
        # exact mass balance: new_q = q_post - dropped
        np.testing.assert_allclose((got[0] + got[2]).numpy(), q_post, rtol=1e-6)


@pytest.mark.parametrize("kwargs", [
    {"revoke_p_enter": 1.5}, {"fail_p_exit": -0.1}, {"revoke_frac": 2.0},
    {"retry_budget": 4}, {"outage_len": -1},
], ids=lambda kw: next(iter(kw)))
def test_checks_raise_as_the_reference(kwargs):
    with pytest.raises(ValueError) as want:
        ref.failure_spec("bad", **kwargs)
    with pytest.raises(ValueError) as got:
        failures.failure_spec("bad", **kwargs)
    assert str(got.value).split(",")[0] == str(want.value).split(",")[0]


def test_scenario_library_matches_the_reference():
    got, want = failures.failure_scenario_library(4), ref.failure_scenario_library(4)
    assert [s.name for s in got] == [s.name for s in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.key_data, np.asarray(w.key_data))
        for f in ref.FailureSpec._LEAVES[:-1]:
            np.testing.assert_array_equal(getattr(g, f).numpy(), np.asarray(getattr(w, f)))
    assert failures.RETRY_CLASSES == ref.RETRY_CLASSES and failures.FAILURE_ENV == ref.FAILURE_ENV


def test_kill_switch(monkeypatch):
    spec = failures.failure_spec("x", revoke_frac=0.5)
    assert failures.resolve_failures(spec) is spec
    monkeypatch.setenv(failures.FAILURE_ENV, "0")
    assert failures.resolve_failures(spec) is None


def test_init_failure_state_defaults_to_the_card():
    """Made on ``cuda`` unless the caller asks for the host; raises without a
    CUDA device."""
    state = failures.init_failure_state(4, device="cpu", batch_shape=(2,))
    assert state.down.shape == (4,) and state.retry_q.shape == (2, failures.RETRY_CLASSES - 1, 4)
    assert all(t.device.type == "cpu" and not t.any() for t in state)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            failures.init_failure_state(4)
