"""Every registered allocation policy of the port against the JAX package's
``dispatch`` on the same random states, on the Table I fleet and on a
padded fleet."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.core import agents as jax_agents
from repro.core import allocator as jax_alloc
from repro_torch.core import agents, allocator as alloc
from repro_torch.core.capacity import billing_cost, check_budget_ceiling

N_PAD = 7
# float32 on both sides; the projected-gradient loop of objective_descent
# compounds rounding over its 12 steps, hence its looser bound.
ATOL = {"objective_descent": 1e-5}


def _states(n_real, n, seed):
    """Random (t, lam, ema, queue), zero on padding slots, with idle agents
    and an all-idle state among them."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(6):
        lam = rng.uniform(0.0, 300.0, n).astype(np.float32)
        ema = rng.uniform(0.0, 300.0, n).astype(np.float32)
        queue = rng.uniform(0.0, 50.0, n).astype(np.float32)
        if i == 1:
            lam[rng.integers(0, n_real)] = 0.0
            queue[:] = 0.0
        if i == 2:
            lam[:], ema[:], queue[:] = 0.0, 0.0, 0.0
        lam[n_real:], ema[n_real:], queue[n_real:] = 0.0, 0.0, 0.0
        out.append((int(rng.integers(0, 1000)), lam, ema, queue))
    return out


def _fleets(padded):
    jf, tf = jax_agents.paper_fleet(), agents.paper_fleet()
    if padded:
        jf, tf = jax_agents.pad_fleet(jf, N_PAD), agents.pad_fleet(tf, N_PAD)
    return jf, tf


def test_registry_order_matches_reference():
    assert alloc.policy_names() == jax_alloc.policy_names()


@pytest.mark.parametrize("padded", [False, True], ids=["table1", "padded"])
@pytest.mark.parametrize("name", jax_alloc.policy_names())
def test_policy_matches_jax_dispatch(name, padded):
    jf, tf = _fleets(padded)
    n = tf.num_agents
    atol = ATOL.get(name, 1e-6)
    for g_total in (1.0, 0.6, 0.0):
        for t, lam, ema, queue in _states(4, n, seed=2 * jax_alloc.policy_names().index(name) + padded):
            want = np.asarray(jax_alloc.dispatch(
                name, jnp.asarray(t), jnp.asarray(lam), jnp.asarray(ema), jnp.asarray(queue),
                jf, jnp.float32(g_total)))
            got = alloc.dispatch(name, t, *map(torch.from_numpy, (lam, ema, queue)), tf,
                                 g_total).numpy()
            np.testing.assert_allclose(got, want, atol=atol, rtol=0)
            assert got.min() >= 0.0 and got.sum() <= g_total + 1e-6
            assert (got[4:] == 0.0).all()  # padding slots get exactly nothing


def test_tensor_budget_and_ema_forecast():
    tf = agents.paper_fleet()
    lam = torch.tensor([80.0, 40.0, 45.0, 25.0])
    for name in alloc.policy_names():
        g = alloc.dispatch(name, 1, lam, lam, lam, tf, torch.tensor(0.5))
        assert float(g.sum()) <= 0.5 + 1e-6
    prev, obs = np.float32([1.0, 7.5]), np.float32([3.0, 0.25])
    np.testing.assert_array_equal(
        alloc.ema_forecast(torch.from_numpy(prev), torch.from_numpy(obs), 0.3).numpy(),
        np.asarray(jax_alloc.ema_forecast(jnp.asarray(prev), jnp.asarray(obs), 0.3)))


def test_registry_rejects_duplicates_and_unknown_names():
    with pytest.raises(ValueError, match="already registered"):
        alloc.register_policy("adaptive")(lambda *a: None)
    with pytest.raises(ValueError, match="unknown policy"):
        alloc.get_policy("nope")


def test_fleet_billing_and_ceiling():
    f = agents.pad_fleet(agents.paper_fleet(), 6)
    f.validate()
    assert f.num_agents == 6 and float(f.num_active) == 4.0
    assert f.names[-1] == "_pad_1" and float(f.base_throughput[-1]) == 1.0
    assert billing_cost(3600.0, agents.T4_PRICE_PER_HOUR) == pytest.approx(0.72)
    with pytest.raises(ValueError, match="ceiling"):
        check_budget_ceiling(2.0, 1.0)


def _batch(n_real, n, rows, seed):
    """A (rows, N) batch of random states, idle rows and agents among them."""
    rng = np.random.default_rng(seed)
    lam, ema, queue = (rng.uniform(0.0, hi, (rows, n)).astype(np.float32)
                       for hi in (300.0, 300.0, 50.0))
    lam[1], queue[1] = 0.0, 0.0
    lam[2, 0], queue[2] = 0.0, 0.0
    for x in (lam, ema, queue):
        x[:, n_real:] = 0.0
    return [torch.from_numpy(x) for x in (lam, ema, queue)]


@pytest.mark.parametrize("padded", [False, True], ids=["table1", "padded"])
@pytest.mark.parametrize("name", alloc.policy_names())
def test_policy_on_a_batch_equals_its_rows(name, padded):
    """Every policy on a (W, N) batch, with one shared budget and with a
    budget per row, equals the same policy on each row alone, bit for bit
    on the CPU; and on a batch of fleets (F, 1, N) over (F, W, N) rows."""
    _, tf = _fleets(padded)
    n, rows = tf.num_agents, 6
    lam, ema, queue = _batch(4, n, rows, seed=alloc.policy_id(name))
    budgets = torch.tensor([1.0, 0.6, 0.0, 0.3, 1.0, 0.45])
    for g_total in (0.8, budgets[:, None]):
        got = alloc.dispatch(name, 7, lam, ema, queue, tf, g_total)
        for i in range(rows):
            row_budget = g_total if isinstance(g_total, float) else g_total[i, 0]
            want = alloc.dispatch(name, 7, lam[i], ema[i], queue[i], tf, row_budget)
            assert torch.equal(got.expand(rows, n)[i], want), (name, i)
    fleets = [agents.pad_fleet(agents.synthetic_fleet(k, seed=k), 6) for k in (3, 6)]
    stacked = agents.stack_fleets(fleets)
    view = agents.Fleet(names=stacked.names, **{
        f: getattr(stacked, f)[:, None, :] for f in
        ("model_size_mb", "base_throughput", "min_gpu", "priority", "active")})
    lam, ema, queue = (x[:4, :6].reshape(2, 2, 6) * view.active for x in _batch(6, 6, 6, 1))
    got = alloc.dispatch(name, 3, lam, ema, queue, view, 1.0)
    for f, fl in enumerate(fleets):
        for w in range(2):
            want = alloc.dispatch(name, 3, lam[f, w], ema[f, w], queue[f, w], fl, 1.0)
            assert torch.equal(got.expand(2, 2, 6)[f, w], want), (name, f, w)


def test_policy_stack_rows_equal_dispatch():
    """``policy_stack`` runs policy i on row i of a (P, W, N) state, with a
    shared budget or one per row; ``policy_switch`` and
    ``policy_stack_blocks`` select by id and by block."""
    tf = agents.paper_fleet()
    names = alloc.policy_names()
    p = len(names)
    lam, ema, queue = (torch.stack([x] * p) for x in _batch(4, 4, 3, seed=9))
    budgets = torch.linspace(0.2, 1.0, p * 3).reshape(p, 3)
    for budget in (1.0, budgets):
        g = alloc.policy_stack(5, lam, ema, queue, tf, budget, names)
        assert g.shape == (p, 3, 4)
        for i, name in enumerate(names):
            b = budget if isinstance(budget, float) else budget[i][:, None]
            want = alloc.dispatch(name, 5, lam[i], ema[i], queue[i], tf, b)
            assert torch.equal(g[i], want.expand(3, 4)), name
            assert torch.equal(alloc.policy_switch(alloc.policy_id(name), 5, lam[i], ema[i],
                                                   queue[i], tf, b), want)
    blocks = alloc.policy_stack_blocks(5, lam[3:6], ema[3:6], queue[3:6], tf, 1.0, names, 3, 1)
    assert torch.equal(blocks, alloc.policy_stack(5, lam, ema, queue, tf, 1.0, names)[3:6])
    with pytest.raises(ValueError, match="equal blocks"):
        alloc.policy_stack_blocks(5, lam, ema, queue, tf, 1.0, names, 4, 0)
    assert [alloc.policy_id(n) for n in names] == list(range(p))
