"""Independent pure-numpy oracle of the fleet simulator (port of
``repro/core/reference_sim.py``).

A second, deliberately naive implementation of the queue dynamics (python
loops, float64) that tests hold the port's tensor simulator
(``core/simulator.py``) against.  Covers the **entire** policy registry
(including ``throughput_greedy`` and ``objective_descent``, whose
projected-gradient loop is re-derived here with a hand-written analytic
gradient rather than autograd) and the workflow-routing path: when a
``Workflow`` is given, exogenous arrivals feed only source agents and each
step's served requests are forwarded into downstream queues for the next
step, exactly as in ``simulator.simulate_core``.

The serverless capacity layer (``core/capacity.py``) is re-implemented here
as an explicit python loop over the warm pool: cohorts leave a plain list
delay line, the idle clock and the keep-alive window are straight-line
float64 arithmetic, and the allocator's budget each step is the loop's own
``warm`` — so the oracle cross-validates the simulator under ``reactive``
and ``scale_to_zero`` autoscaling, not just the static budget.

The arithmetic is the reference oracle's, line for line: on the same
inputs (the port's fleets, workflows, capacity configs and failure specs
hold the reference's float32 values, and ``failures.failure_uniforms`` its
bits) the two oracles agree bit for bit.  Fleet, workflow and spec fields
are torch tensors here; they are read on the host as float64.

**Where the oracle leaves the float32 simulators.**  The simulators guard
each policy's total demand: ``adaptive``, ``water_filling``,
``ema_water_filling`` and ``sqrt_demand`` divide by
``max(total, 1e-9)`` (``allocator.py``, as the reference's).  This oracle,
as the reference's, divides by the bare total (``_adaptive``,
``_water_fill``).  So wherever a policy's total is positive but below
1e-9 the two disagree, with normal floats too: ``adaptive`` at rates
(0, 0, 0, 1e-30) gives (0.1, 0.3, 0.25, 0.35) in both simulators and
(0.0606, 0.1818, 0.1515, 0.6061) here; ``water_filling`` at
(0, 0, 1e-8, 0) gives agent 2 a share of 0.25 in both simulators and 1.0
here.  Rates whose float32 products underflow (1.4e-45 · 0.35) give zeros
in both simulators; only a subnormal rate (below 1.18e-38) splits the
port, which keeps it, from JAX on the CPU, which flushes it.  The copy
keeps the unguarded divisions: it is the reference's oracle, faults
included.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.agents import Fleet
from repro_torch.core.capacity import (
    COLD_START_HORIZON,
    CapacityConfig,
    capacity_policy_names,
)
from repro_torch.core.routing import Workflow

_EPS = 1e-9


def _np(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a float64 numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def synthesize_loop(
    spec, num_steps: int | None = None, block_size: int = 1
) -> np.ndarray:
    """Eager python-loop twin of ``workload.materialize``.

    Walks the registered generator one step at a time — ``workload_step``
    called per t, state threaded through a plain python variable — so the
    loop in ``materialize`` (and therefore the in-loop synthesis of the
    streaming simulator, which runs the *same* step functions) is
    cross-validated by a second control-flow path, exactly like this
    module's queue-dynamics loop cross-validates the simulator.  Returns
    the (S, N) arrival tensor as float64 rows.

    ``block_size`` > 1 is the eager twin of the *time-blocked* stream: the
    horizon is walked ⌈S/B⌉ blocks at a time through ``workload.step_block``
    — a python outer loop, the block state threaded by hand, and a
    naturally ragged tail block — so block decomposition is
    cross-validated by a second control-flow frame too.  Every B yields
    identical rows.  The generators are the port's own, so its ``poisson``
    rows are the port's sampler's (``core/workload.py``), not
    ``jax.random.poisson``'s.
    """
    from repro_torch.core import workload as workload_mod

    steps = int(spec.num_steps if num_steps is None else num_steps)
    b = int(block_size)
    if b < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    state = workload_mod.workload_init(spec, device="cpu")
    rows = []
    if b == 1:
        for t in range(steps):
            lam, state = workload_mod.workload_step(spec, state, t)
            rows.append(_np(lam))
        return np.stack(rows)
    for t0 in range(0, steps, b):
        lam_rows, state = workload_mod.step_block(spec, state, t0, min(t0 + b, steps) - t0)
        rows.append(_np(lam_rows))
    return np.concatenate(rows)


# Every registry entry the oracle reproduces; kept in sync with
# ``allocator.policy_names()`` by tests/test_torch_reference_sim.py.
SUPPORTED_POLICIES = (
    "static_equal",
    "round_robin",
    "adaptive",
    "water_filling",
    "predictive",
    "throughput_greedy",
    "objective_descent",
    "sqrt_demand",
    "ema_water_filling",
)


def _normalize(g: np.ndarray, g_total: float) -> np.ndarray:
    """Proportional scale-down iff over capacity (Algorithm 1 lines 19-25)."""
    if g.sum() > g_total:
        g = g * (g_total / max(g.sum(), _EPS))
    return g


def _adaptive(src: np.ndarray, R: np.ndarray, P: np.ndarray, g_total: float) -> np.ndarray:
    # Unguarded, as the reference oracle: a total in (0, 1e-9) leaves the
    # simulators, which divide by max(total, 1e-9) (module docstring).
    d = src * R / P
    if d.sum() <= 0:
        return np.zeros_like(src)
    g = np.maximum(R, d / d.sum() * g_total)
    return _normalize(g, g_total)


def _water_fill(pressure: np.ndarray, R: np.ndarray, g_total: float) -> np.ndarray:
    """Shared water-filling shape: proportional-to-pressure with a busy
    min-GPU floor, used by ``water_filling`` (pressure from observed
    intake), ``ema_water_filling`` (pressure from the EMA forecast) and —
    through a sqrt of the pressure — ``sqrt_demand``.  The division is
    unguarded, as ``_adaptive``'s."""
    if pressure.sum() <= 0:
        return np.zeros_like(pressure)
    prop = pressure / pressure.sum() * g_total
    g = np.maximum(np.where(pressure > 0, R, 0.0), prop)
    return _normalize(g, g_total)


def _throughput_greedy(
    q: np.ndarray, lam: np.ndarray, T: np.ndarray, R: np.ndarray, g_total: float
) -> np.ndarray:
    x = q + lam
    busy = x > 0
    g = np.where(busy, R, 0.0)
    need = np.where(busy, x / np.maximum(T, _EPS), 0.0)
    extra = np.maximum(need - g, 0.0)
    residual = max(g_total - g.sum(), 0.0)
    # Highest-throughput agents first; a stable sort, as the simulator's.
    order = np.argsort(-T, kind="stable")
    sorted_need = extra[order]
    cum_before = np.cumsum(sorted_need) - sorted_need
    grant_sorted = np.clip(residual - cum_before, 0.0, sorted_need)
    grant = np.zeros_like(g)
    grant[order] = grant_sorted
    return _normalize(g + grant, g_total)


def _objective_descent(
    q: np.ndarray,
    lam: np.ndarray,
    T: np.ndarray,
    R: np.ndarray,
    P: np.ndarray,
    g_total: float,
    alpha: float = 1.0,
    gamma: float = 10.0,
    steps: int = 12,
    lr: float = 0.05,
    latency_cap: float = 1000.0,
) -> np.ndarray:
    """Projected gradient descent on the one-step Eq. (2) lookahead, with
    the gradient derived by hand (the oracle must not depend on autograd).

    Kinks (min/max ties) get the 0.5/0.5 split that ``torch.minimum``/
    ``torch.maximum`` (and JAX's ``lax.min``/``lax.max``) use, so the
    implementations agree even on the measure-zero tie set.
    """
    n = len(T)
    x = q + lam
    busy = x > 0
    if not busy.any():
        return np.zeros(n)
    floor = np.where(busy, R, 0.0)

    def project(g):
        return _normalize(np.clip(g, floor, 1.0), g_total)

    def grad(g):
        c = g * T
        denom = np.maximum(c, 1e-6)
        served = np.minimum(c, x)
        new_q = x - served
        r = new_q / denom
        ds_dc = np.where(c < x, 1.0, np.where(c > x, 0.0, 0.5))
        dden_dc = np.where(c > 1e-6, 1.0, np.where(c < 1e-6, 0.0, 0.5))
        dr_dc = (-ds_dc * denom - new_q * dden_dc) / denom**2
        dlat_dc = dr_dc * np.where(
            r < latency_cap, 1.0, np.where(r > latency_cap, 0.0, 0.5)
        )
        return (alpha * dlat_dc / n - gamma * ds_dc) * T

    g = project(_adaptive(lam, R, P, g_total))
    for _ in range(steps):
        g = project(g - lr * grad(g))
    return g


def _capacity_desired(
    name: str,
    ema_tot: float,
    q_tot: float,
    idle_s: float,
    keep_alive_s: float,
    target_rate: float,
    backlog_per: float,
    min_instances: float,
    g_total: float,
    num_gpus: float,
) -> float:
    """The registry's three capacity rules, straight-line python.  The
    cold-start delay is not an input: it shapes *when* a request warms
    (the caller's delay line), never how many instances are desired."""
    if name == "fixed":
        return g_total
    rate_need = np.ceil(ema_tot / max(target_rate, _EPS))
    backlog_boost = np.floor(q_tot / max(backlog_per, _EPS))
    desired = rate_need + backlog_boost
    if name == "reactive":
        return float(np.clip(desired, min_instances, num_gpus))
    if name == "scale_to_zero":
        floor = max(min_instances, 1.0)
        active_desired = float(np.clip(desired, floor, num_gpus))
        return active_desired if idle_s <= keep_alive_s else 0.0
    raise ValueError(
        f"unknown capacity policy {name!r}; oracle supports "
        f"{capacity_policy_names()}"
    )


def simulate_numpy(
    policy: str,
    arrivals,
    fleet: Fleet,
    g_total: float = 1.0,
    latency_cap: float = 1000.0,
    ema_alpha: float = 0.3,
    workflow: Workflow | None = None,
    capacity: CapacityConfig | None = None,
    num_gpus: float = 1.0,
    failures=None,
) -> dict:
    """Returns per-step arrays matching SimTrace semantics (plus
    ``completed``, the requests exiting the workflow at each agent,
    ``warm``/``pending``, the warm pool's trajectory, ``misrouted``, and —
    under a ``failures`` spec — ``dropped``/``retried``/``expired``/
    ``recovery``).  ``arrivals`` is an (S, N) array or tensor.

    The failure layer (``core/failures.py``) is re-implemented here as
    straight-line float64 python: the revocation/outage Markov chains are
    replayed from the *same* counter-based uniforms the simulator draws
    (``failures.failure_uniforms`` is pure in ``t``, so both control-flow
    frames see identical chains — comparisons on identical floats are
    exact), and the deadline/retry class bookkeeping is an eager mirror of
    ``failures.deadline_step``."""
    if policy not in SUPPORTED_POLICIES:
        raise ValueError(
            f"unknown policy {policy!r}; oracle supports {SUPPORTED_POLICIES}"
        )
    T = _np(fleet.base_throughput)
    R = _np(fleet.min_gpu)
    P = _np(fleet.priority)
    n = len(T)
    steps = arrivals.shape[0]
    active = _np(fleet.active)
    if workflow is None:
        route = np.zeros((n, n))
        source = np.ones(n)
        fan_out = np.ones(n)
    else:
        route = _np(workflow.route)
        source = _np(workflow.source)
        fan_out = _np(workflow.fan_out)
    exit_frac = np.maximum(1.0 - route.sum(axis=1), 0.0)
    # Same gating as the simulator: exogenous arrivals enter only at active
    # source agents, routed mass never wakes a padded slot.  (The policy
    # branches themselves are mask-unaware — the oracle cross-validates
    # unpadded fleets; padded-fleet parity is the registry's job.)
    arrivals = _np(arrivals) * source[None, :] * active[None, :]

    if capacity is not None:
        cap_name = capacity_policy_names()[int(capacity.policy_id)]
        cold_start_s = float(_np(capacity.cold_start_s))
        keep_alive_s = float(_np(capacity.keep_alive_s))
        target_rate = float(_np(capacity.target_rate_per_instance))
        backlog_per = float(_np(capacity.backlog_per_instance))
        min_instances = float(_np(capacity.min_instances))
        delay = int(np.clip(np.round(cold_start_s), 0, COLD_START_HORIZON - 1))
    warm = float(g_total)
    pipeline = np.zeros(COLD_START_HORIZON)
    idle_s = 0.0

    if failures is not None:
        from repro_torch.core.failures import RETRY_CLASSES, failure_uniforms

        C = RETRY_CLASSES
        f_rev_enter = float(_np(failures.revoke_p_enter))
        f_rev_exit = float(_np(failures.revoke_p_exit))
        f_rev_frac = float(_np(failures.revoke_frac))
        f_down_enter = float(_np(failures.fail_p_enter))
        f_down_exit = float(_np(failures.fail_p_exit))
        f_out_start = float(_np(failures.outage_start))
        f_out_len = float(_np(failures.outage_len))
        f_out_agent = float(_np(failures.outage_agent))
        deadline = np.broadcast_to(_np(failures.deadline_s), (n,)).copy()
        budget = float(np.clip(_np(failures.retry_budget), 0, C - 1))
        rev_on = 0.0
        down = np.zeros(n)
        fail_prev = 0.0
        recovering = 0.0
        q_mark = 0.0
        retry_q = np.zeros((C - 1, n))

    q = np.zeros(n)
    endo = np.zeros(n)
    ema = arrivals[0].copy()
    out = {"allocation": [], "served": [], "queue": [], "latency": [],
           "completed": [], "warm": [], "pending": [], "misrouted": [],
           "dropped": [], "retried": [], "expired": [], "recovery": []}

    for t in range(steps):
        lam = arrivals[t] + endo  # total intake: exogenous + routed
        # EMA is seeded with the first observation; applying the update
        # again at t=0 would double-count it.
        if t > 0:
            ema = ema_alpha * lam + (1 - ema_alpha) * ema
        if capacity is not None:
            # Same step order as capacity.capacity_step: warm-ups, idle
            # clock, decision, instant scale-down, cold-start requests.
            warm += pipeline[0]
            pipeline = np.append(pipeline[1:], 0.0)
            idle_s = 0.0 if (lam.sum() + q.sum()) > 0 else idle_s + 1.0
            pending = pipeline.sum()
            desired = _capacity_desired(
                cap_name, ema.sum(), q.sum(), idle_s, keep_alive_s,
                target_rate, backlog_per, min_instances, g_total, num_gpus,
            )
            warm = min(warm, desired)
            request = max(desired - (warm + pending), 0.0)
            if delay == 0:
                warm += request
            else:
                # slot k warms at step t+k+1: a d-second delay is slot d-1
                pipeline[delay - 1] += request
            g_total_t = warm
            pending_t = pipeline.sum()
        else:
            g_total_t = g_total
            pending_t = 0.0
        if policy == "static_equal":
            g = np.full(n, g_total_t / n)
        elif policy == "round_robin":
            g = np.zeros(n)
            g[t % n] = g_total_t
        elif policy in ("adaptive", "predictive"):
            g = _adaptive(lam if policy == "adaptive" else ema, R, P, g_total_t)
        elif policy == "water_filling":
            g = _water_fill((q + lam) / np.maximum(T, _EPS), R, g_total_t)
        elif policy == "ema_water_filling":
            g = _water_fill((q + ema) / np.maximum(T, _EPS), R, g_total_t)
        elif policy == "sqrt_demand":
            g = _water_fill(
                np.sqrt((q + lam) / np.maximum(T, _EPS)), R, g_total_t
            )
        elif policy == "throughput_greedy":
            g = _throughput_greedy(q, lam, T, R, g_total_t)
        else:  # objective_descent
            # NB: the registry entry always runs the policy's internal
            # latency_cap default (1000), independent of the sim-level cap.
            g = _objective_descent(q, lam, T, R, P, g_total_t)
        if failures is None:
            cap = g * T
            served = np.minimum(cap, q + lam)
            q = q + lam - served
            lat = np.minimum(q / np.maximum(cap, _EPS), latency_cap)
            dropped = retried = expired = np.zeros(n)
            in_rec = 0.0
        else:
            # Replay the chains from the simulator's own uniforms (exact).
            u_rev, u_down = failure_uniforms(failures, t, n)
            u_rev = float(_np(u_rev))
            u_down = _np(u_down)
            rev_on = float(
                (u_rev >= f_rev_exit) if rev_on > 0.5 else (u_rev < f_rev_enter)
            )
            down = np.where(down > 0.5, u_down >= f_down_exit,
                            u_down < f_down_enter).astype(np.float64)
            phi = f_rev_frac * rev_on
            sched = 1.0 if f_out_start <= t < f_out_start + f_out_len else 0.0
            col = (np.arange(n) == f_out_agent).astype(np.float64)
            down_eff = np.clip(down + sched * col, 0.0, 1.0)
            up = 1.0 - down_eff
            fail_t = float(max(float(phi > 0),
                               float(((down_eff * active) > 0.5).any())))
            pre_q_tot = float((q * active).sum())
            onset = fail_t * (1.0 - fail_prev) * (1.0 - recovering)
            if onset > 0:
                q_mark = pre_q_tot
            # Failure-aware physics (mirror of _failure_queue_step).
            cap = g * up * T
            served_raw = np.minimum(cap, q + lam)
            served = served_raw * (1.0 - phi)
            q_post = q + lam - served
            cap_eff = cap * (1.0 - phi)
            # Deadline/retry class bookkeeping (mirror of deadline_step).
            enabled = (deadline > 0).astype(np.float64)
            expired = enabled * np.maximum(
                q_post - cap_eff * np.maximum(deadline, 0.0), 0.0
            )
            x = q + lam
            f_surv = q_post / np.maximum(x, _EPS)
            m0 = np.maximum(x - retry_q.sum(axis=0), 0.0)
            m = np.vstack([m0[None, :], retry_q])
            m_post = m * f_surv[None, :]
            exp_frac = expired / np.maximum(q_post, _EPS)
            e = m_post * exp_frac[None, :]
            retry_mask = (np.arange(C) < budget).astype(np.float64)[:, None]
            ret = e * retry_mask
            dro = e * (1.0 - retry_mask)
            promoted = np.vstack([np.zeros((1, n)), ret[:-1]])
            new_m = (m_post - e) + promoted
            retry_q = new_m[1:]
            dropped = dro.sum(axis=0)
            retried = ret.sum(axis=0)
            q = q_post - dropped
            # Dead-band snap mirrors _failure_queue_step: roundoff residue
            # around an exactly-drained queue must not flip queue>0
            # branches (greedy allocators) or the clipped-latency cliff
            # across float widths.
            q = q * (q > 1e-4)
            lat = np.minimum(q / np.maximum(cap_eff, _EPS), latency_cap) * (
                q > 1e-4
            )
            # Recovery bookkeeping.
            new_q_tot = float((q * active).sum())
            in_rec = (1.0 - fail_t) * max(fail_prev, recovering)
            recovering = recovering if fail_t > 0 else (
                in_rec * float(new_q_tot > q_mark)
            )
            fail_prev = fail_t
            if capacity is not None:
                # Revoked instances leave the warm pool; the autoscaler
                # re-provisions them through the cold-start line next step.
                warm *= (1.0 - phi)
            # Billing excludes revoked instance-seconds (as in the simulator).
            g_total_t = g_total_t * (1.0 - phi)
        fwd = (served * fan_out) @ route
        endo = fwd * active
        out["allocation"].append(g.copy())
        out["served"].append(served.copy())
        out["queue"].append(q.copy())
        out["latency"].append(lat.copy())
        out["completed"].append(served * exit_frac)
        out["warm"].append(g_total_t)
        out["pending"].append(pending_t)
        out["misrouted"].append(fwd * (1.0 - active))
        out["dropped"].append(np.asarray(dropped, np.float64).copy()
                              if failures is not None else np.zeros(n))
        out["retried"].append(np.asarray(retried, np.float64).copy()
                              if failures is not None else np.zeros(n))
        out["expired"].append(np.asarray(expired, np.float64).copy()
                              if failures is not None else np.zeros(n))
        out["recovery"].append(float(in_rec))
    return {k: np.asarray(v) for k, v in out.items()}
