"""The port's warm-pool autoscaler (``repro_torch/core/capacity.py``)
against ``repro/core/capacity.py``: the registry, the checks, and
``capacity_step`` step for step under every capacity policy and several
cold starts, on the same inputs drawn with numpy."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import capacity as ref
from repro_torch.core import capacity

STEPS = 40


def test_registry_matches_the_reference():
    assert capacity.capacity_policy_names() == ref.capacity_policy_names() == (
        "fixed", "reactive", "scale_to_zero")
    assert capacity.COLD_START_HORIZON == ref.COLD_START_HORIZON
    for name in capacity.capacity_policy_names():
        assert capacity.capacity_config(name).policy == name
        assert capacity.capacity_policy_id(name) == ref.capacity_policy_id(name)
    with pytest.raises(ValueError, match="unknown capacity policy"):
        capacity.capacity_config("nope")


def test_billing_matches_the_reference():
    assert capacity.billing_cost(100.0, 0.72) == float(ref.billing_cost(100.0, 0.72))


@pytest.mark.parametrize("kwargs", [
    {"cold_start_s": -1.0}, {"cold_start_s": 32.0}, {"keep_alive_s": -1.0},
    {"target_rate_per_instance": 0.0}, {"backlog_per_instance": -2.0},
    {"min_instances": 9.0},
], ids=lambda kw: next(iter(kw)))
def test_checks_raise_as_the_reference(kwargs):
    with pytest.raises(ValueError) as want:
        ref.check_capacity(ref.capacity_config("reactive", **kwargs), 1.0, 8.0)
    with pytest.raises(ValueError) as got:
        capacity.check_capacity(capacity.capacity_config("reactive", **kwargs), 1.0, 8.0)
    assert str(got.value).split(":")[0] == str(want.value).split(":")[0]
    with pytest.raises(ValueError, match="exceeds the instance ceiling"):
        capacity.check_capacity(capacity.capacity_config(), 2.0, 1.0)


@pytest.mark.parametrize("cold_start_s", [0.0, 0.5, 1.5, 2.5, 3.0, 31.0])
def test_delay_rounds_half_to_even(cold_start_s):
    cfg = capacity.capacity_config("reactive", cold_start_s=cold_start_s)
    assert cfg.delay == int(jnp.round(jnp.float32(cold_start_s)))


_ref_step = jax.jit(ref.capacity_step, static_argnames=("g_total", "num_gpus"))


@pytest.mark.parametrize("cold_start_s", [0.0, 1.0, 2.5, 3.0, 7.0])
@pytest.mark.parametrize("policy", ["fixed", "reactive", "scale_to_zero"])
def test_capacity_step_matches_the_reference(policy, cold_start_s):
    """Bursts and idle spells (so scale_to_zero's keep-alive expires), with
    the pool's state carried on both sides: every step's warm, pending and
    state are equal."""
    rng = np.random.default_rng(7)
    on = rng.random(STEPS) < 0.5
    lam = np.where(on, rng.uniform(0, 400, STEPS), 0).astype(np.float32)
    ema = np.where(on, rng.uniform(0, 400, STEPS), 0).astype(np.float32)
    queue = np.where(rng.random(STEPS) < 0.6, rng.uniform(0, 300, STEPS), 0).astype(np.float32)
    kw = dict(cold_start_s=cold_start_s, keep_alive_s=3.0, target_rate_per_instance=60.0,
              backlog_per_instance=50.0, min_instances=1.0)
    g_total, num_gpus = 1.0, 6.0
    ref_cfg, cfg = ref.capacity_config(policy, **kw), capacity.capacity_config(policy, **kw)
    ref_state, state = ref.init_capacity_state(g_total), capacity.init_capacity_state(g_total, "cpu")
    warm_seen = set()
    for t in range(STEPS):
        ref_state, ref_warm, ref_pending = _ref_step(
            ref_state, ref_cfg, jnp.asarray(t), jnp.float32(lam[t]), jnp.float32(ema[t]),
            jnp.float32(queue[t]), g_total=g_total, num_gpus=num_gpus)
        state, warm, pending = capacity.capacity_step(
            state, cfg, t, torch.tensor(lam[t]), torch.tensor(ema[t]), torch.tensor(queue[t]),
            g_total, num_gpus)
        assert float(warm) == float(ref_warm) and float(pending) == float(ref_pending), t
        np.testing.assert_array_equal(state.pipeline.numpy(), np.asarray(ref_state.pipeline))
        assert float(state.idle_s) == float(ref_state.idle_s)
        warm_seen.add(float(warm))
    if policy != "fixed":
        assert len(warm_seen) > 2  # the pool really scaled


def test_init_capacity_state_defaults_to_the_card():
    """Like the port's other entry points, the state is made on ``cuda``
    unless the caller asks for the host, and raises without a CUDA device."""
    state = capacity.init_capacity_state(2.0, device="cpu", batch_shape=(3,))
    assert state.warm.device.type == "cpu" and state.warm.tolist() == [2.0] * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            capacity.init_capacity_state(1.0)
