"""The port's FleetEngine against the JAX package's: the same fleet, float32
parameters and submissions must give the same greedy token streams,
allocations and metrics.  Two fleets: dense agents (granite-8b, qwen2-vl-2b),
and the reference's own two-agent engine fleet (tests/test_serving.py:
minitron-4b and mamba2-370m)."""
import math

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.core.agents import AgentSpec as JaxAgentSpec, Fleet as JaxFleet
from repro.models.model import build_model as jax_build_model
from repro.serving.engine import AgentRuntime as JaxRuntime, FleetEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.core import allocator as alloc
from repro_torch.core.agents import AgentSpec, Fleet
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import build_model
from repro_torch.serving.engine import AgentRuntime, FleetEngine

# (name, arch, AgentSpec fields after the name)
AGENTS = (("nlp", "granite-8b", 100.0, 100.0, 0.2, 1),
          ("vision", "qwen2-vl-2b", 100.0, 20.0, 0.3, 2))
# tests/test_serving.py::_fleet_2 and ::_engine
AGENTS_2 = (("fast", "minitron-4b", 100.0, 100.0, 0.2, 1),
            ("slow", "mamba2-370m", 500.0, 20.0, 0.3, 2))
MAX_LEN, SLOTS, BUDGET = 48, 2, 32


@pytest.fixture(scope="module")
def jax_params():
    out = {}
    for _, arch, *_ in AGENTS + AGENTS_2:
        api = jax_build_model(jax_get_config(arch, reduced=True))
        out[arch] = (api, api.init(jax.random.key(0), dtype=jnp.float32))
    return out


def _engines(policy, jax_params, agents=AGENTS):
    jax_rts, rts = {}, {}
    for name, arch, *_ in agents:
        jax_api, params = jax_params[arch]
        jax_rts[name] = JaxRuntime(name, jax_api, params, max_len=MAX_LEN, batch_slots=SLOTS)
        cfg = get_config(arch, reduced=True)
        rts[name] = AgentRuntime(
            name, build_model(cfg),
            params_from_numpy(jax.tree_util.tree_map(np.asarray, params), cfg),
            max_len=MAX_LEN, batch_slots=SLOTS)
    jax_fleet = JaxFleet.from_specs([JaxAgentSpec(a[0], *a[2:]) for a in agents])
    fleet = Fleet.from_specs([AgentSpec(a[0], *a[2:]) for a in agents])
    return (JaxEngine(jax_fleet, jax_rts, policy=policy, budget_tokens=BUDGET),
            FleetEngine(fleet, rts, policy=policy, budget_tokens=BUDGET, device="cpu"))


def _drive(engines, ticks=8, seed=0, agents=AGENTS):
    rng = np.random.default_rng(seed)
    reqs = [[] for _ in engines]
    for t in range(ticks):
        for name, *_ in agents:
            for _ in range(rng.poisson(1.5)):
                prompt = rng.integers(0, 512, rng.integers(3, 11))
                new = int(rng.integers(2, 6))
                for out, eng in zip(reqs, engines):
                    out.append(eng.submit(name, prompt, new))
        for eng in engines:
            eng.step()
    return reqs


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b


def _assert_engines_agree(jax_eng, eng, jax_reqs, reqs):
    for want, got in zip(jax_reqs, reqs):
        assert got.tokens_out == want.tokens_out, (got.id, got.agent)
        assert got.finish_tick == want.finish_tick
    for want, got in zip(jax_eng.history, eng.history):
        np.testing.assert_allclose(got["allocation"], want["allocation"], atol=1e-6, rtol=0)
        assert {k: v for k, v in got.items() if k != "allocation"} == \
            {k: v for k, v in want.items() if k != "allocation"}
    want_m, got_m = jax_eng.metrics(), eng.metrics()
    np.testing.assert_allclose(got_m.pop("mean_allocation"), want_m.pop("mean_allocation"),
                               atol=1e-6, rtol=0)
    assert _same(got_m, want_m), (got_m, want_m)


@pytest.mark.parametrize("policy", ["adaptive", "round_robin"])
def test_engine_matches_jax_engine(policy, jax_params):
    jax_eng, eng = _engines(policy, jax_params)
    jax_reqs, reqs = _drive((jax_eng, eng))
    assert eng.metrics()["completed"] > 0
    _assert_engines_agree(jax_eng, eng, jax_reqs, reqs)


@pytest.mark.parametrize("policy", ["adaptive", "round_robin"])
def test_two_agent_fleet_matches_jax_engine(policy, jax_params):
    """The reference's minitron-4b + mamba2-370m engine: attention and ssm
    caches side by side, the same streams on both agents."""
    jax_eng, eng = _engines(policy, jax_params, AGENTS_2)
    jax_reqs, reqs = _drive((jax_eng, eng), agents=AGENTS_2)
    done = {r.agent for r in eng.completed}
    assert done == {"fast", "slow"}, done
    _assert_engines_agree(jax_eng, eng, jax_reqs, reqs)


def _dispatch_every_policy(eng, agent):
    rng = np.random.default_rng(3)
    for policy in alloc.policy_names():
        eng.policy = policy
        eng.submit(agent, rng.integers(0, 50, 4), 2)
        eng.step()
    assert eng.tick == len(alloc.policy_names())
    for h in eng.history:
        assert sum(h["allocation"]) <= 1.0 + 1e-6


def test_every_registered_policy_dispatches_in_engine(jax_params):
    _, eng = _engines("adaptive", jax_params)
    _dispatch_every_policy(eng, "nlp")


def test_every_registered_policy_dispatches_in_two_agent_engine(jax_params):
    _, eng = _engines("adaptive", jax_params, AGENTS_2)
    _dispatch_every_policy(eng, "slow")
    assert any(r.agent == "slow" for r in eng.completed)


def test_short_prompt_to_mamba_raises_in_both_engines(jax_params):
    """A prompt shorter than ssm_conv_width - 1 leaves a short conv tail that
    the batched cache cannot take, in the reference and in the port."""
    for eng in _engines("adaptive", jax_params, AGENTS_2):
        eng.submit("slow", np.arange(2), 3)
        with pytest.raises(ValueError):
            eng.step()


@pytest.mark.parametrize("arg", ["workflow", "capacity", "failures"])
def test_unported_engine_features_raise(arg, jax_params):
    _, eng = _engines("adaptive", jax_params)
    rts = {rt.name: rt for rt in eng.runtimes}
    with pytest.raises(NotImplementedError, match="ROADMAP A2"):
        FleetEngine(eng.fleet, rts, device="cpu", **{arg: object()})


def test_build_engine_contract():
    assert serve.DEFAULT_FLEET[3][1] == "mixtral-8x7b"
    assert [r[:1] + r[2:] for r in serve.DENSE_FLEET] == [r[:1] + r[2:] for r in serve.DEFAULT_FLEET]
    assert {r[1] for r in serve.DENSE_FLEET} == {"granite-8b", "qwen2-vl-2b"}
    eng = serve.build_engine("adaptive", fleet=serve.DENSE_FLEET, device="cpu")
    nlp, reasoning = eng.runtimes[1], eng.runtimes[3]
    assert nlp.params is reasoning.params  # one parameter set per architecture
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        serve.build_engine("adaptive", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.build_engine("adaptive", fleet=serve.DENSE_FLEET)
