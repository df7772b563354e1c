"""The port's FleetEngine against the JAX package's: the same fleet, float32
parameters and submissions must give the same greedy token streams,
allocations and metrics.  Three fleets: dense agents (granite-8b,
qwen2-vl-2b), the reference's own two-agent engine fleet
(tests/test_serving.py: minitron-4b and mamba2-370m), the same fleet with
the hybrid recurrentgemma-9b in mamba's place, and the paper's Table I fleet
(``launch/serve.py::DEFAULT_FLEET``, mixtral-8x7b included).  An enc-dec
agent fails in both engines alike.  The serverless layers (workflow routing, the
warm pool, failures) are held the same way, each on its own and all three
together."""
import math

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.core import capacity as jax_capacity
from repro.core import failures as jax_failures
from repro.core import routing as jax_routing
from repro.core.agents import AgentSpec as JaxAgentSpec, Fleet as JaxFleet
from repro.models.model import build_model as jax_build_model
from repro.serving.engine import AgentRuntime as JaxRuntime, FleetEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.core import allocator as alloc
from repro_torch.core import capacity, failures, routing
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
# The two-agent fleet with the hybrid family in mamba's place: reduced
# recurrentgemma-9b's local attention has a window of 16, so its cache of 16
# entries rolls.
AGENTS_HYBRID = (AGENTS_2[0], ("slow", "recurrentgemma-9b", 500.0, 20.0, 0.3, 2))
# An enc-dec agent beside a dense one.
AGENTS_ENCDEC = (AGENTS_2[0], ("speech", "seamless-m4t-large-v2", 500.0, 20.0, 0.3, 2))
# launch/serve.py::DEFAULT_FLEET, as (name, arch, AgentSpec fields after the
# name); reduced mixtral's window is 16, so its cache of 16 entries rolls.
AGENTS_TABLE_I = tuple((name, arch, 1000.0, tput, min_gpu, pri)
                       for name, arch, tput, min_gpu, pri, _ in serve.DEFAULT_FLEET)
MAX_LEN, SLOTS, BUDGET = 48, 2, 32


@pytest.fixture(scope="module")
def jax_params():
    out = {}
    for arch in {a[1] for a in AGENTS + AGENTS_2 + AGENTS_TABLE_I + AGENTS_HYBRID + AGENTS_ENCDEC}:
        api = jax_build_model(jax_get_config(arch, reduced=True))
        out[arch] = (api, api.init(jax.random.key(0), dtype=jnp.float32))
    return out


def _engines(policy, jax_params, agents=AGENTS, features=None, budget=BUDGET):
    """The JAX engine and the port's over ``agents``; ``features`` maps each
    package's layer modules to the ``FleetEngine`` keyword arguments."""
    jax_rts, rts = {}, {}
    for name, arch, *_ in agents:
        jax_api, params = jax_params[arch]
        jax_rts[name] = JaxRuntime(name, jax_api, params, max_len=MAX_LEN, batch_slots=SLOTS)
        cfg = get_config(arch, reduced=True)
        rts[name] = AgentRuntime(
            name, build_model(cfg),
            params_from_numpy(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu"),
            max_len=MAX_LEN, batch_slots=SLOTS)
    jax_fleet = JaxFleet.from_specs([JaxAgentSpec(a[0], *a[2:]) for a in agents])
    fleet = Fleet.from_specs([AgentSpec(a[0], *a[2:]) for a in agents])
    jax_kw, kw = ({}, {}) if features is None else (
        features(jax_routing, jax_capacity, jax_failures),
        features(routing, capacity, failures))
    return (JaxEngine(jax_fleet, jax_rts, policy=policy, budget_tokens=budget, **jax_kw),
            FleetEngine(fleet, rts, policy=policy, budget_tokens=budget, device="cpu", **kw))


def _drive(engines, ticks=8, seed=0, agents=AGENTS, sources=None, rate=1.5, prompt=(3, 11)):
    rng = np.random.default_rng(seed)
    reqs = [[] for _ in engines]
    for t in range(ticks):
        for name, *_ in agents:
            if sources is not None and name not in sources:
                continue
            for _ in range(rng.poisson(rate)):
                ids = rng.integers(0, 512, rng.integers(*prompt))
                new = int(rng.integers(2, 6))
                for out, eng in zip(reqs, engines):
                    out.append(eng.submit(name, ids, new))
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


@pytest.mark.parametrize("policy", ["adaptive", "round_robin"])
def test_hybrid_fleet_matches_jax_engine(policy, jax_params):
    """minitron-4b beside recurrentgemma-9b: attention caches and rglru
    (conv window, state) caches side by side; prompts of up to 29 tokens
    fill and roll the hybrid's cache of 16, and decodes pass it."""
    jax_eng, eng = _engines(policy, jax_params, AGENTS_HYBRID, budget=96)
    jax_reqs, reqs = _drive((jax_eng, eng), agents=AGENTS_HYBRID, rate=1.0, prompt=(3, 30))
    slow = [r for r in eng.completed if r.agent == "slow"]
    assert {r.agent for r in eng.completed} == {"fast", "slow"}
    assert eng.runtimes[1].caches["blocks"][2]["k"].shape[1] == 16
    assert any(len(r.prompt) > 16 for r in slow)
    _assert_engines_agree(jax_eng, eng, jax_reqs, reqs)


def test_short_prompt_to_hybrid_raises_in_both_engines(jax_params):
    """As for mamba: a two-token prompt leaves an rglru conv tail of two rows
    that the cache's three cannot take, in the reference and in the port."""
    for eng in _engines("adaptive", jax_params, AGENTS_HYBRID):
        eng.submit("slow", np.arange(2), 3)
        with pytest.raises(ValueError):
            eng.step()


@pytest.mark.parametrize("agents", [AGENTS_2, AGENTS_HYBRID], ids=["mamba", "hybrid"])
def test_one_token_prompt_is_broadcast_in_both_engines(agents, jax_params):
    """A one-token prompt's conv tail is one row; the reference's
    ``.at[slot].set`` broadcasts it over the cache's conv window (which
    should hold zeros before it) and serves, and the port copies that: the
    same token streams."""
    jax_eng, eng = _engines("adaptive", jax_params, agents)
    reqs = [e.submit("slow", np.arange(1), 3) for e in (jax_eng, eng)]
    for e in (jax_eng, eng):
        for _ in range(3):
            e.step()
    assert reqs[1].tokens_out == reqs[0].tokens_out and len(reqs[1].tokens_out) == 3
    _assert_engines_agree(jax_eng, eng, [reqs[0]], [reqs[1]])


def test_encdec_agent_raises_in_both_engines(jax_params):
    """The engine feeds an enc-dec agent 64 zero frames, but its batched
    cache holds the cross K/V of 4096 (the reference's encoder length for
    decode): the first prefill's cache does not fit, in the reference and
    in the port."""
    for eng in _engines("adaptive", jax_params, AGENTS_ENCDEC):
        eng.submit("speech", np.arange(5), 3)
        with pytest.raises(ValueError):
            eng.step()


# The serverless layers, built from either package's modules: a star that
# fans each finished coordinator request out to the specialist, a reactive
# pool of up to 2 instances with a 2-tick cold start, and failures with a
# revocation chain, a scheduled outage of the specialist and deadlines.
def _workflow(r, c, f):
    return {"workflow": r.coordinator_star(2, fan_out=2.0)}


def _capacity(r, c, f):
    return {"capacity": c.capacity_config("reactive", cold_start_s=2.0,
                                          target_rate_per_instance=1.0,
                                          backlog_per_instance=3.0, min_instances=1.0),
            "num_gpus": 2.0}


def _failures(r, c, f):
    return {"failures": f.failure_spec("mix", revoke_p_enter=0.3, revoke_p_exit=0.5,
                                       revoke_frac=0.5, outage_start=2, outage_len=2,
                                       outage_agent=1, deadline_s=2.0, retry_budget=1,
                                       seed=1)}


def _all(r, c, f):
    return _workflow(r, c, f) | _capacity(r, c, f) | _failures(r, c, f)


FEATURES = {"workflow": _workflow, "capacity": _capacity, "failures": _failures,
            "all": _all}


@pytest.mark.parametrize("feature", list(FEATURES))
def test_serverless_engine_matches_jax_engine(feature, jax_params):
    """Each layer on its own and all three together: the same streams,
    history (routed, warm, pending, revoked_frac, down included) and
    metrics (failure counters and the workflow block included)."""
    jax_eng, eng = _engines("adaptive", jax_params, features=FEATURES[feature])
    routed = feature in ("workflow", "all")
    jax_reqs, reqs = _drive((jax_eng, eng),
                            sources={"nlp"} if routed else None, rate=2.0)
    _assert_engines_agree(jax_eng, eng, jax_reqs, reqs)
    m, hist = eng.metrics(), eng.history
    assert m["completed"] > 0
    if routed:
        assert m["routed_requests"] > 0 and m["sink_completed"] > 0
        assert any(r.parent_id >= 0 for r in eng.completed)
    if feature in ("capacity", "all"):
        assert max(h["warm"] for h in hist) > 1.0 and max(h["pending"] for h in hist) > 0
    if feature in ("failures", "all"):
        assert any(h["revoked_frac"] > 0 for h in hist)
        assert [h["down"] for h in hist[2:4]] == [1, 1]
        assert m["slo_violations"] > 0
    for h in hist:
        assert sum(h["allocation"]) <= h["warm"] * (1.0 - h["revoked_frac"]) + 1e-6


def test_routed_prompt_is_wrapped_into_the_child_vocabulary(jax_params):
    """A child's prompt is its parent's generated ids; where the parent's
    vocabulary is larger than the child's embedding table (the dense fleet's
    qwen2-vl-2b coordinator over granite-8b specialists), the ids are taken
    modulo the child's table, where the reference would embed NaN rows
    (ROADMAP C)."""
    _wrapped_into_child(jax_params, "qwen2-vl-2b")


def test_routed_prompt_to_mixtral_is_wrapped(jax_params):
    """The Table I coordinator (qwen2-vl-2b, 151,936 ids) routing to
    mixtral-8x7b (32,000): the child's rolling-cache MoE model takes the
    wrapped ids the same way."""
    _wrapped_into_child(jax_params, "mixtral-8x7b")


def _wrapped_into_child(jax_params, child_arch):
    import dataclasses

    _, eng = _engines("adaptive", jax_params, features=_workflow)
    vision = eng.runtimes[1]
    api = build_model(dataclasses.replace(get_config(child_arch, reduced=True), vocab_size=100))
    vision.api, vision.params = api, api.init(0, device="cpu")
    rows = api.cfg.padded_vocab
    assert vision.params["embed"]["embedding"].shape[0] == rows < 512
    eng.submit("nlp", np.arange(5), 3)
    eng.step()
    parent = eng.completed[0]
    assert max(parent.tokens_out) >= rows  # out of the child's table
    child = vision.queue[0]
    assert child.parent_id == parent.id
    np.testing.assert_array_equal(child.prompt, np.asarray(parent.tokens_out) % rows)
    eng.step()
    assert any(r.agent == "vision" for r in eng.completed)


def test_exogenous_request_at_a_non_source_raises(jax_params):
    for eng in _engines("adaptive", jax_params, features=_workflow):
        with pytest.raises(ValueError, match="not a source"):
            eng.submit("vision", np.arange(4), 2)


@pytest.mark.parametrize("policy", ["adaptive", "round_robin"])
def test_table_i_fleet_matches_jax_engine(policy, jax_params):
    """The paper's Table I fleet, reduced: two qwen2-vl-2b agents, granite-8b
    and mixtral-8x7b, whose prompts of up to 32 tokens are padded, rolled or
    banded into its window of 16, and whose decodes pass it."""
    jax_eng, eng = _engines(policy, jax_params, AGENTS_TABLE_I, budget=96)
    jax_reqs, reqs = _drive((jax_eng, eng), ticks=6, agents=AGENTS_TABLE_I, rate=1.0,
                            prompt=(6, 33))
    reasoning = [r for r in eng.completed if r.agent == "specialist_reasoning"]
    assert reasoning and eng.runtimes[3].caches["blocks"][0]["k"].shape[1] == 16
    assert any(len(r.prompt) > 16 for r in reasoning)  # a rolled prefill
    assert any(len(r.prompt) + len(r.tokens_out) > 16 for r in reasoning)
    _assert_engines_agree(jax_eng, eng, jax_reqs, reqs)


def test_build_engine_contract():
    assert serve.DEFAULT_FLEET[3][1] == "mixtral-8x7b"
    assert [r[:1] + r[2:] for r in serve.DENSE_FLEET] == [r[:1] + r[2:] for r in serve.DEFAULT_FLEET]
    assert {r[1] for r in serve.DENSE_FLEET} == {"granite-8b", "qwen2-vl-2b"}
    eng = serve.build_engine("adaptive", fleet=serve.DENSE_FLEET, device="cpu")
    nlp, reasoning = eng.runtimes[1], eng.runtimes[3]
    assert nlp.params is reasoning.params  # one parameter set per architecture
    eng = serve.build_engine("adaptive", device="cpu", num_layers={"mixtral-8x7b": 1})
    coordinator, vision, reasoning = eng.runtimes[0], eng.runtimes[2], eng.runtimes[3]
    assert coordinator.params is vision.params
    assert reasoning.api.cfg.num_layers == len(reasoning.params["blocks"]) == 1
    assert reasoning.api.cfg.num_experts == get_config("mixtral-8x7b", reduced=True).num_experts
    assert serve.FULL_WIDTH_CUT == {"mixtral-8x7b": 16}
    with pytest.raises(ValueError, match="cut"):
        serve.build_engine("adaptive", device="cpu", num_layers={"mixtral-8x7b": 3})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.build_engine("adaptive", fleet=serve.DENSE_FLEET)
