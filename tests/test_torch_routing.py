"""The port's workflow topologies (``repro_torch/core/routing.py``) against
``repro/core/routing.py``: the generators' arrays equal bit for bit
(``synthetic_workflow`` draws from the same numpy generator), padding, and
the same errors from validation."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro.core import routing as ref
from repro_torch.core import routing

FIELDS = ("route", "source", "sink", "fan_out")


def _assert_same(wf, want):
    assert wf.name == want.name and wf.num_agents == want.num_agents
    for f in FIELDS:
        got, exp = getattr(wf, f), np.asarray(getattr(want, f))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), exp, err_msg=f"{wf.name}/{f}")
    np.testing.assert_array_equal(wf.exit_fraction.numpy(), np.asarray(want.exit_fraction))


GENERATORS = [
    ("independent", (1,), {}), ("independent", (4,), {}),
    ("coordinator_star", (4,), {}), ("coordinator_star", (4,), {"fan_out": 3.0}),
    ("coordinator_star", (7,), {"fan_out": 2.0}),
    ("pipeline_chain", (1,), {}), ("pipeline_chain", (5,), {}),
    ("hierarchical", (3,), {}), ("hierarchical", (6,), {"fan_out": 1.5}),
] + [("synthetic_workflow", (n,), {"seed": s}) for n in (1, 4, 9) for s in (0, 3, 11)] + [
    ("synthetic_workflow", (6,), {"seed": 2, "edge_prob": 0.1, "forward_frac": (0.2, 0.5)}),
]


@pytest.mark.parametrize("name,args,kwargs", GENERATORS,
                         ids=lambda x: x if isinstance(x, str) else str(x))
def test_generators_match_the_reference(name, args, kwargs):
    wf = getattr(routing, name)(*args, **kwargs)
    _assert_same(wf, getattr(ref, name)(*args, **kwargs))
    wf.validate()
    routing.check_workflow(wf, wf.num_agents)


@pytest.mark.parametrize("n_max", [4, 6])
def test_pad_workflow_matches_the_reference(n_max):
    for make in ("coordinator_star", "hierarchical"):
        _assert_same(routing.pad_workflow(getattr(routing, make)(4, 2.0), n_max),
                     ref.pad_workflow(getattr(ref, make)(4, 2.0), n_max))
    with pytest.raises(ValueError, match="cannot pad"):
        routing.pad_workflow(routing.independent(4), 3)


def _custom(pkg, route, source, sink, fan_out=None):
    n = len(source)
    fo = np.ones(n, np.float32) if fan_out is None else np.asarray(fan_out, np.float32)
    if pkg is ref:
        import jax.numpy as jnp
        return ref.Workflow("custom", jnp.asarray(route, jnp.float32),
                            jnp.asarray(source, jnp.float32), jnp.asarray(sink, jnp.float32),
                            jnp.asarray(fo))
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    return routing.Workflow("custom", t(route), t(source), t(sink), t(fo))


BAD = {
    "superstochastic": ([[0, 0.7, 0.6], [0, 0, 0], [0, 0, 0]], [1, 0, 0], [0, 1, 1]),
    "sourceless": ([[0, 1, 0], [0, 0, 1], [0, 0, 0]], [0, 0, 0], [0, 0, 1]),
    "forwarding_sink": ([[0, 1, 0], [0, 0, 1], [0, 0, 0]], [1, 0, 0], [1, 0, 1]),
    "cycle": ([[0, 1, 0], [0, 0, 1], [0, 0.5, 0]], [1, 0, 0], [0, 0, 0]),
    "negative": ([[0, -0.5, 0], [0, 0, 0], [0, 0, 0]], [1, 0, 0], [0, 1, 1]),
    "flags": ([[0, 0, 0], [0, 0, 0], [0, 0, 0]], [1, 0.5, 0], [1, 1, 1]),
    "fan_out": ([[0, 1, 0], [0, 0, 0], [0, 0, 0]], [1, 0, 0], [0, 1, 1], [-1, 1, 1]),
}


@pytest.mark.parametrize("case", list(BAD))
def test_validation_raises_as_the_reference(case):
    with pytest.raises(ValueError) as want:
        _custom(ref, *BAD[case]).validate()
    with pytest.raises(ValueError) as got:
        _custom(routing, *BAD[case]).validate()
    assert str(got.value).split(":")[0] == str(want.value).split(":")[0]


@pytest.mark.parametrize("make,n", [("independent", 0), ("coordinator_star", 1),
                                    ("hierarchical", 2), ("pipeline_chain", 0),
                                    ("synthetic_workflow", 0)])
def test_size_guards_raise_as_the_reference(make, n):
    with pytest.raises(ValueError) as want:
        getattr(ref, make)(n)
    with pytest.raises(ValueError) as got:
        getattr(routing, make)(n)
    assert str(got.value) == str(want.value)


def test_check_workflow_refuses_a_width_mismatch():
    with pytest.raises(ValueError, match="pad_workflow"):
        routing.check_workflow(routing.coordinator_star(3), 4)
