"""Discrete-time fleet simulator (paper §IV-B): the trace path of
``repro/core/simulator.py`` as a step loop over tensors on the card.

* One-second steps: requests arrive, the allocator distributes the GPU,
  agents serve ``min(g_i·T_i, queue_i + arrivals_i)``, leftovers carry over;
* the per-step latency is the Little's-law drain time of the post-step
  queue at the current service rate, clipped at ``latency_cap`` seconds (a
  starved agent reports the cap, which gives round-robin's ≈756 s);
* cost bills warm-instance-seconds (``capacity.billing_cost``).

The three serverless layers are optional and compose, as in the reference:
a ``Workflow`` routes each step's served requests into downstream queues
for the next step (``core/routing.py``), a ``CapacityConfig`` makes the
budget the output of a warm-pool autoscaler (``core/capacity.py``), and a
``FailureSpec`` injects revocation, outages and deadlines
(``core/failures.py``).  With each left out, the loop runs the reference's
feature-off program, and ``independent(n)``, ``fixed`` capacity with no
cold start, and a disabled failure spec give the same trajectories bit for
bit.

``simulate`` checks its inputs, moves them to the device (``cuda`` unless
the caller asks for another), draws a whole run's failure uniforms there,
and hands them to ``simulate_core``.  That loop is the reference's
``lax.scan`` body step by step, a Python loop of ``num_steps`` iterations
that writes into ``(S, N)`` outputs preallocated on the device and never
waits on the device (no ``.item()``, no copy to the host), so the host only
queues kernels.  The policy is looked up by name in the port's registry.

**Streaming** (``simulate_stream_core``) is the sweep grids' path
(``core/sweep.py``): the state is ``(P, *cells, N)``, every named policy
runs once per step on its own row (``allocator.policy_stack``), and the
METRIC_NAMES reductions accumulate in running sums (``MetricAccum``), so no
(S, N) trajectory exists.  Its arrivals are a materialized tensor or a
``WorkloadSpec`` synthesized on the device inside the loop, one
``step_block`` per B steps (``block_size``); the failure uniforms are drawn
per block on the device too.  ``trace_metrics`` and the stream share one
finalizer (``finalize_metrics``), so there is one metric definition, and
every block size gives the same metrics bit for bit.  Like
``simulate_core``, the loop never waits on the device.
"""
from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Sequence

import torch

from repro_torch._device import resolve_device
from repro_torch.core import allocator as alloc
from repro_torch.core import capacity as cap_mod
from repro_torch.core import failures as fail_mod
from repro_torch.core import prng
from repro_torch.core import workload as workload_mod
from repro_torch.core.agents import Fleet, T4_PRICE_PER_HOUR
from repro_torch.core.capacity import CapacityConfig, billing_cost
from repro_torch.core.failures import FailureSpec
from repro_torch.core.routing import Workflow, check_workflow

_EPS = 1e-9

# The dead band under which a post-drop queue snaps to exactly zero.
_DEAD_BAND = 1e-4

# Env default of the streaming loop's time-block size (``resolve_block_size``).
BLOCK_ENV = "REPRO_SWEEP_BLOCK"


def resolve_block_size(block_size: int | None = None) -> int:
    """The streaming time-block size B: ``block_size``, else the
    ``REPRO_SWEEP_BLOCK`` environment variable, else 1."""
    if block_size is None:
        raw = os.environ.get(BLOCK_ENV, "").strip()
        block_size = int(raw) if raw else 1
    b = int(block_size)
    if b < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    return b


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static simulation knobs.

    ``g_total`` is the allocator's budget without a capacity layer and the
    warm pool's t=0 baseline with one; ``num_gpus`` is the warm-pool
    instance ceiling; ``price_per_hour`` bills warm-instance-seconds.
    """

    num_steps: int = 100
    g_total: float = 1.0
    latency_cap: float = 1000.0
    price_per_hour: float = T4_PRICE_PER_HOUR
    num_gpus: float = 1.0
    ema_alpha: float = 0.3

    def __post_init__(self):
        cap_mod.check_budget_ceiling(self.g_total, self.num_gpus)


@dataclasses.dataclass
class SimTrace:
    """Per-step, per-agent trajectories (everything Fig. 2 plots).

    ``arrivals`` is the exogenous input (gated by the workflow's sources and
    the fleet's active mask); ``completed`` the requests that exit the
    workflow; ``warm`` the allocator's per-step budget and ``pending`` the
    instances still cold.  The failure trajectories are zeros when nothing
    fails.
    """

    allocation: torch.Tensor  # (S, N) g_i(t)
    served: torch.Tensor      # (S, N) requests served in step t
    queue: torch.Tensor       # (S, N) backlog after step t
    latency: torch.Tensor     # (S, N) clipped drain-time estimate
    arrivals: torch.Tensor    # (S, N) exogenous arrivals (source-gated)
    completed: torch.Tensor = None  # (S, N) requests exiting the workflow
    warm: torch.Tensor = None       # (S,) warm instances = g_total(t)
    pending: torch.Tensor = None    # (S,) instances mid cold start
    misrouted: torch.Tensor = None  # (S, N) mass routed into inactive slots
    dropped: torch.Tensor = None    # (S, N) deadline drops (budget exhausted)
    retried: torch.Tensor = None    # (S, N) deadline-expired mass re-queued
    expired: torch.Tensor = None    # (S, N) SLO-violating mass (pre-retry)
    recovery: torch.Tensor = None   # (S,) post-outage backlog-drain indicator

    def __post_init__(self):
        if self.completed is None:
            self.completed = self.served
        steps = self.served.shape[:-1]
        if self.warm is None:
            self.warm = torch.ones(steps, dtype=torch.float32, device=self.served.device)
        if self.pending is None:
            self.pending = torch.zeros_like(self.warm)
        for f in ("misrouted", "dropped", "retried", "expired"):
            if getattr(self, f) is None:
                setattr(self, f, torch.zeros_like(self.served))
        if self.recovery is None:
            self.recovery = torch.zeros_like(self.warm)

    def fields(self) -> dict[str, torch.Tensor]:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}


@dataclasses.dataclass(frozen=True)
class SimSummary:
    """Table II row for one policy."""

    policy: str
    avg_latency: float
    latency_std: float          # std across agents' mean latencies (Table II)
    per_agent_latency: tuple
    total_throughput: float     # served requests / second
    per_agent_throughput: tuple
    cost: float                 # warm-instance-seconds billed in $
    gpu_utilization: float      # mean Σ g_i
    littles_law_latency: float  # unclipped long-run estimate
    mean_queue: float
    sink_throughput: float = 0.0        # requests exiting the workflow / s
    critical_path_latency: float = 0.0  # longest source→sink latency chain
    per_agent_queue: tuple = ()         # per-stage mean backlog
    utilization: float = 0.0            # Σ g / warm-instance-seconds
    cold_start_stall_time: float = 0.0  # backlogged seconds with pending pool
    mean_warm_instances: float = 0.0    # mean warm pool size
    dropped: float = 0.0                # deadline drops / s (budget exhausted)
    retried: float = 0.0                # deadline-expired mass re-queued / s
    slo_violations: float = 0.0         # deadline-expired mass / s (pre-retry)
    recovery_time: float = 0.0          # steps draining post-outage backlog
    misrouted: float = 0.0              # mass lost to inactive route slots / s

    @classmethod
    def from_metrics(cls, policy: str, m: dict, per_agent_latency,
                     per_agent_throughput, per_agent_queue) -> "SimSummary":
        """The one METRIC_NAMES-dict → summary mapping."""
        per_agent = lambda xs: tuple(float(x) for x in xs)
        return cls(
            policy=policy,
            per_agent_latency=per_agent(per_agent_latency),
            per_agent_throughput=per_agent(per_agent_throughput),
            per_agent_queue=per_agent(per_agent_queue),
            **{k: m[k] for k in METRIC_NAMES},
        )


def _total(x: torch.Tensor) -> torch.Tensor:
    """A fleet-wide total over the agents, summed in float64 and rounded to
    float32 once.  Thresholds read these totals (the autoscaler's whole
    instances, the recovery watermark), so they must not depend on the
    order a device sums in."""
    return x.sum(-1, dtype=torch.float64).to(torch.float32)


def _routing_terms(workflow: Workflow | None, fleet: Fleet, arrivals: torch.Tensor):
    """Gate the exogenous arrivals and precompute the routing terms.

    Returns ``(route_eff, exit_frac, gated_arrivals)``; the routing terms
    are ``None`` without a workflow, the loop's signal to skip the
    endogenous path.
    """
    if workflow is None:
        return None, None, arrivals * fleet.active
    route_eff = workflow.route * workflow.fan_out[..., :, None]  # forwarded copies
    exit_frac = torch.clamp(1.0 - workflow.route.sum(dim=-1), min=0.0)
    return route_eff, exit_frac, arrivals * (fleet.active * workflow.source)


def _route(served, fleet, route_eff, exit_frac):
    """``(completed, new_endo, misrouted)`` of one step's served requests;
    ``new_endo`` and ``misrouted`` are ``None`` without a workflow (the
    reference's exact zeros)."""
    if route_eff is None:
        return served, None, None
    # Routed mass arrives downstream next step; mass routed into an
    # inactive slot is dropped, but accounted.  A stacked route (..., N, N)
    # multiplies each row by its own cell's matrix.
    if route_eff.ndim == 2:
        fwd = served @ route_eff
    else:
        fwd = (served.unsqueeze(-2) @ route_eff).squeeze(-2)
    return served * exit_frac, fwd * fleet.active, fwd * (1.0 - fleet.active)


def _queue_step(queue, lam, g, fleet: Fleet, config: SimConfig, route_eff, exit_frac):
    """One step of the serving/queueing physics — THE definition.

    Returns ``(served, new_queue, latency, completed, new_endo, misrouted)``.
    """
    capacity_rps = g * fleet.base_throughput
    served = torch.minimum(capacity_rps, queue + lam)
    new_queue = queue + lam - served
    latency = torch.clamp(new_queue / torch.clamp(capacity_rps, min=_EPS),
                          max=config.latency_cap)
    return (served, new_queue, latency) + _route(served, fleet, route_eff, exit_frac)


def _failure_queue_step(queue, lam, g, fleet: Fleet, config: SimConfig, route_eff,
                        exit_frac, failures: FailureSpec, phi, up, retry_q):
    """Failure-aware twin of ``_queue_step``.

    An agent outage (``up`` → 0) zeroes the agent's capacity and keeps its
    queue; revocation (``phi`` > 0) yanks a ``phi`` fraction of the
    in-service work back into the queue; deadlines expire backlog beyond
    the deadline's worth of effective service (``deadline_step``).

    Returns ``(served, new_queue, latency, completed, new_endo, misrouted,
    new_retry_q, dropped, retried, expired)``.
    """
    capacity_rps = g * up * fleet.base_throughput
    served_raw = torch.minimum(capacity_rps, queue + lam)
    served = served_raw * (1.0 - phi)
    q_post = queue + lam - served
    cap_eff = capacity_rps * (1.0 - phi)
    new_queue, new_retry_q, dropped, retried, viol = fail_mod.deadline_step(
        failures, queue, lam, served, q_post, cap_eff, retry_q, eps=_EPS)
    # Snap the drop accounting's roundoff residue to an exact zero, and gate
    # the latency cliff on the same dead band (the reference's reason: a
    # float32 run and the float64 oracle must not land on opposite sides of
    # a queue > 0 branch).
    live = new_queue > _DEAD_BAND
    new_queue = new_queue * live
    latency = torch.clamp(new_queue / torch.clamp(cap_eff, min=_EPS),
                          max=config.latency_cap) * live
    return ((served, new_queue, latency) + _route(served, fleet, route_eff, exit_frac)
            + (new_retry_q, dropped, retried, viol))


@torch.no_grad()
def simulate_core(
    policy: str,
    arrivals: torch.Tensor,
    fleet: Fleet,
    config: SimConfig,
    workflow: Workflow | None = None,
    capacity: CapacityConfig | None = None,
    failures: FailureSpec | None = None,
    uniforms: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> SimTrace:
    """The step loop, on the device of ``arrivals`` (every input already
    there; ``uniforms`` = the run's ``(u_rev (S,), u_down (S, N))`` when
    ``failures`` is given).

    Per step, as the reference's scan body: the EMA (seeded with the first
    observation, not updated at t=0), the autoscaler before the policy, the
    policy on the step's budget, the failure chains, the physics, and the
    revoked share clawed out of the warm pool.  ``objective_descent`` turns
    gradients back on inside itself.
    """
    policy_fn = alloc.get_policy(policy)
    num_steps, n = arrivals.shape
    dev = arrivals.device
    route_eff, exit_frac, arrivals = _routing_terms(workflow, fleet, arrivals)
    elastic = capacity is not None
    failing = failures is not None

    per_agent = lambda: torch.zeros((num_steps, n), dtype=torch.float32, device=dev)
    per_step = lambda: torch.zeros((num_steps,), dtype=torch.float32, device=dev)
    tr = SimTrace(
        allocation=per_agent(), served=per_agent(), queue=per_agent(),
        latency=per_agent(), arrivals=arrivals, completed=per_agent(),
        warm=per_step(), pending=per_step(), misrouted=per_agent(),
        dropped=per_agent(), retried=per_agent(), expired=per_agent(),
        recovery=per_step(),
    )
    if not (elastic or failing):
        tr.warm.fill_(config.g_total)  # the static budget, written once
    queue = torch.zeros(n, dtype=torch.float32, device=dev)
    lam_ema = arrivals[0]
    endo = None  # routed mass arriving this step (None: none can)
    if elastic:
        cstate = cap_mod.init_capacity_state(config.g_total, dev)
    if failing:
        fstate = fail_mod.init_failure_state(n, dev)
    for t in range(num_steps):
        lam = arrivals[t] if endo is None else arrivals[t] + endo  # total intake
        if t > 0:
            lam_ema = alloc.ema_forecast(lam_ema, lam, config.ema_alpha)
        if elastic:
            cstate, g_total_t, pending_t = cap_mod.capacity_step(
                cstate, capacity, t, _total(lam), _total(lam_ema), _total(queue),
                config.g_total, config.num_gpus,
            )
            tr.pending[t] = pending_t
        else:
            g_total_t = config.g_total  # python float: the pre-capacity program
        g = policy_fn(t, lam, lam_ema, queue, fleet, g_total_t)
        if failing:
            phi, avail, rev_nxt, down_nxt = fail_mod.advance_failures(
                failures, t, fstate.rev_on, fstate.down, uniforms[0][t], uniforms[1][t])
            fail_t = torch.maximum(
                (phi > 0).to(torch.float32),
                (((1.0 - avail) * fleet.active) > 0.5).any().to(torch.float32),
            )
            pre_q_tot = _total(queue * fleet.active)
            onset = fail_t * (1.0 - fstate.fail_prev) * (1.0 - fstate.recovering)
            q_mark = torch.where(onset > 0, pre_q_tot, fstate.q_mark)
            (served, new_queue, latency, completed, new_endo, mis,
             new_retry_q, dropped, retried, viol) = _failure_queue_step(
                queue, lam, g, fleet, config, route_eff, exit_frac,
                failures, phi, avail, fstate.retry_q,
            )
            # Once the failure clears, count the steps until the backlog
            # drains back under its pre-failure watermark.
            new_q_tot = _total(new_queue * fleet.active)
            in_rec = (1.0 - fail_t) * torch.maximum(fstate.fail_prev, fstate.recovering)
            recovering = torch.where(
                fail_t > 0, fstate.recovering,
                in_rec * (new_q_tot > q_mark).to(torch.float32),
            )
            fstate = fail_mod.FailureState(
                rev_on=rev_nxt, down=down_nxt, fail_prev=fail_t,
                recovering=recovering, q_mark=q_mark, retry_q=new_retry_q,
            )
            if elastic:
                # Revoked instances leave the warm pool.
                cstate = cap_mod.CapacityState(
                    cstate.warm * (1.0 - phi), cstate.pipeline, cstate.idle_s)
            tr.dropped[t], tr.retried[t], tr.expired[t] = dropped, retried, viol
            tr.recovery[t] = in_rec
            # Billing excludes the revoked instance-seconds.
            tr.warm[t] = g_total_t * (1.0 - phi)
        else:
            served, new_queue, latency, completed, new_endo, mis = _queue_step(
                queue, lam, g, fleet, config, route_eff, exit_frac)
            if elastic:
                tr.warm[t] = g_total_t
        tr.allocation[t], tr.served[t], tr.queue[t] = g, served, new_queue
        tr.latency[t], tr.completed[t] = latency, completed
        if mis is not None:
            tr.misrouted[t] = mis
        queue, endo = new_queue, new_endo
    return tr


def simulate_inputs(
    policy: str,
    arrivals,
    fleet: Fleet,
    config: SimConfig = SimConfig(),
    workflow: Workflow | None = None,
    capacity: CapacityConfig | None = None,
    failures: FailureSpec | None = None,
    device="cuda",
) -> dict:
    """Check a run's inputs and put them on ``device``: the keyword
    arguments of ``simulate_core``, with the failure uniforms of every step
    drawn on the device before the loop (``failures.failure_uniforms_t``,
    the host draws' bits)."""
    dev = resolve_device(device)
    alloc.get_policy(policy)  # fail fast on unregistered policies
    fleet.validate()
    if workflow is not None:
        check_workflow(workflow, fleet.num_agents)
    if capacity is not None:
        cap_mod.check_capacity(capacity, config.g_total, config.num_gpus)
    failures = fail_mod.resolve_failures(failures)
    arrivals = torch.as_tensor(arrivals, dtype=torch.float32).to(dev)
    uniforms = None
    if failures is not None:
        fail_mod.check_failures(failures)
        if failures.batched:
            raise ValueError("simulate() takes a single FailureSpec")
        uniforms = fail_mod.failure_uniforms_t(
            prng.key_t(failures.key_data, dev), 0, arrivals.shape[0], fleet.num_agents)
        failures = failures.to(dev)
    return dict(
        policy=policy, arrivals=arrivals, fleet=fleet.to(dev), config=config,
        workflow=None if workflow is None else workflow.to(dev),
        capacity=None if capacity is None else capacity.to(dev),
        failures=failures, uniforms=uniforms,
    )


def simulate(
    policy: str,
    arrivals,
    fleet: Fleet,
    config: SimConfig = SimConfig(),
    workflow: Workflow | None = None,
    capacity: CapacityConfig | None = None,
    failures: FailureSpec | None = None,
    device="cuda",
) -> SimTrace:
    """Run one registered policy over an (S, N) arrival matrix on
    ``device``, optionally routing through a ``Workflow``, scaling the warm
    pool with a ``CapacityConfig`` and injecting a ``FailureSpec``."""
    return simulate_core(**simulate_inputs(
        policy, arrivals, fleet, config, workflow, capacity, failures, device))


# Order of the metric vector returned by trace_metrics (the reference's).
METRIC_NAMES = (
    "avg_latency",
    "latency_std",
    "total_throughput",
    "gpu_utilization",
    "mean_queue",
    "littles_law_latency",
    "sink_throughput",
    "critical_path_latency",
    "cost",
    "utilization",
    "cold_start_stall_time",
    "mean_warm_instances",
    "dropped",
    "retried",
    "slo_violations",
    "recovery_time",
    "misrouted",
)


def critical_path_latency(per_agent_latency: torch.Tensor, workflow: Workflow | None,
                          mask: torch.Tensor) -> torch.Tensor:
    """Longest source→sink chain of per-stage latencies through the DAG:
    ``cp_i = lat_i + max over successors cp_j``, N times (a DAG over N
    agents has depth < N), maximized over the sources.  Without a workflow,
    the max per-agent latency over active agents.  Batched over leading
    axes; a stacked route (..., N, N) chains each row through its own."""
    if workflow is None:
        return (per_agent_latency * mask).max(dim=-1).values
    adj = (workflow.route > 0).to(per_agent_latency.dtype)  # (..., N, N)
    cp = per_agent_latency
    for _ in range(per_agent_latency.shape[-1]):
        cp = per_agent_latency + (adj * cp[..., None, :]).max(dim=-1).values
    return (cp * workflow.source * mask).max(dim=-1).values


class MetricAccum(NamedTuple):
    """The METRIC_NAMES reductions as running sums: the streaming loop's
    metric state.  Leaves may carry leading batch axes (the stream's policy
    and cell axes)."""

    lat_sum: torch.Tensor        # (..., N) Σ_t latency
    served_sum: torch.Tensor     # (..., N) Σ_t served
    queue_sum: torch.Tensor      # (..., N) Σ_t queue
    completed_sum: torch.Tensor  # (..., N) Σ_t completed
    alloc_sum: torch.Tensor      # (...,)   Σ_t Σ_i g_i
    warm_sum: torch.Tensor       # (...,)   Σ_t warm(t) — warm-instance-seconds
    stall_steps: torch.Tensor    # (...,)   steps with pending > 0 and backlog
    dropped_sum: torch.Tensor    # (...,)   Σ_t Σ_i deadline drops
    retried_sum: torch.Tensor    # (...,)   Σ_t Σ_i re-queued expired mass
    viol_sum: torch.Tensor       # (...,)   Σ_t Σ_i deadline-expired mass
    misrouted_sum: torch.Tensor  # (...,)   Σ_t Σ_i mass lost to inactive slots
    recovery_steps: torch.Tensor  # (...,)  steps draining post-outage backlog


def init_metric_accum(num_agents: int, batch_shape: tuple = (), device="cuda") -> MetricAccum:
    """Zero sums for ``batch_shape`` cells of ``num_agents`` agents."""
    device = resolve_device(device)
    agent = lambda: torch.zeros(batch_shape + (num_agents,), dtype=torch.float32, device=device)
    scalar = lambda: torch.zeros(batch_shape, dtype=torch.float32, device=device)
    return MetricAccum(agent(), agent(), agent(), agent(), *(scalar() for _ in range(8)))


def accumulate_metrics(acc: MetricAccum, mask, g, served, queue, latency, completed, warm,
                       pending=None, misrouted=None, dropped=None, retried=None, viol=None,
                       recovery=None) -> MetricAccum:
    """Fold one step's outputs into the running sums.  An input left
    ``None`` (no capacity layer, no workflow, no failures) contributes
    nothing, as the reference's zeros do."""
    msum = lambda x: (x * mask).sum(-1)
    plus = lambda s, x: s if x is None else s + x
    stall = None
    if pending is not None:
        backlogged = msum(queue) > 0
        stall = ((pending > 0) & backlogged).to(torch.float32)
    return MetricAccum(
        lat_sum=acc.lat_sum + latency,
        served_sum=acc.served_sum + served,
        queue_sum=acc.queue_sum + queue,
        completed_sum=acc.completed_sum + completed,
        alloc_sum=acc.alloc_sum + g.sum(-1),
        warm_sum=acc.warm_sum + warm,
        stall_steps=plus(acc.stall_steps, stall),
        dropped_sum=plus(acc.dropped_sum, None if dropped is None else msum(dropped)),
        retried_sum=plus(acc.retried_sum, None if retried is None else msum(retried)),
        viol_sum=plus(acc.viol_sum, None if viol is None else msum(viol)),
        misrouted_sum=plus(acc.misrouted_sum, None if misrouted is None else msum(misrouted)),
        recovery_steps=plus(acc.recovery_steps, recovery),
    )


def finalize_metrics(acc: MetricAccum, num_steps: int, active: torch.Tensor | None = None,
                     workflow: Workflow | None = None, *, config: SimConfig):
    """METRIC_NAMES reductions from the running sums — THE metric definition.
    Batched over the sums' leading axes (``active`` and ``workflow``
    broadcast against them).

    Returns (metric vector (..., M) in METRIC_NAMES order, per-agent mean
    latency, per-agent mean throughput, per-agent mean queue).
    """
    m = torch.ones_like(acc.lat_sum) if active is None else active
    n_active = torch.clamp(m.sum(-1), min=1.0)
    mmean = lambda x: (x * m).sum(-1) / n_active  # masked mean over agents
    per_lat = acc.lat_sum / num_steps
    per_tput = acc.served_sum / num_steps
    per_queue = acc.queue_sum / num_steps
    # Unclipped long-run latency: mean backlog over long-run service rate.
    littles = mmean(per_queue / torch.clamp(per_tput, min=_EPS))
    lat_mean = mmean(per_lat)
    lat_std = torch.sqrt(mmean((per_lat - lat_mean[..., None]) ** 2))
    cols = [
        lat_mean,
        lat_std,
        per_tput.sum(-1),
        acc.alloc_sum / num_steps,
        mmean(per_queue),
        littles,
        (acc.completed_sum / num_steps * m).sum(-1),
        critical_path_latency(per_lat, workflow, m),
        billing_cost(acc.warm_sum, config.price_per_hour),
        acc.alloc_sum / torch.clamp(acc.warm_sum, min=_EPS),
        acc.stall_steps,
        acc.warm_sum / num_steps,
        acc.dropped_sum / num_steps,
        acc.retried_sum / num_steps,
        acc.viol_sum / num_steps,
        acc.recovery_steps,
        acc.misrouted_sum / num_steps,
    ]
    shape = torch.broadcast_shapes(*(c.shape for c in cols))
    vec = torch.stack([c.expand(shape) for c in cols], dim=-1)
    return vec, per_lat, per_tput, per_queue


def trace_metrics(trace: SimTrace, active: torch.Tensor | None = None,
                  workflow: Workflow | None = None, *, config: SimConfig):
    """Table II + workflow + capacity + failure reductions of one trace,
    through ``finalize_metrics``.  ``active`` masks padded agents;
    ``config`` must be the config the trace ran under (it prices the
    cost)."""
    m = torch.ones_like(trace.latency[0]) if active is None else active.to(trace.latency.device)
    backlogged = (trace.queue * m).sum(dim=-1) > 0
    msum = lambda x: (x * m).sum()
    acc = MetricAccum(
        lat_sum=trace.latency.sum(dim=0),
        served_sum=trace.served.sum(dim=0),
        queue_sum=trace.queue.sum(dim=0),
        completed_sum=trace.completed.sum(dim=0),
        alloc_sum=trace.allocation.sum(),
        warm_sum=trace.warm.sum(dim=0),  # 1 s steps: Σ_t warm(t) · 1 s
        stall_steps=((trace.pending > 0) & backlogged).sum().to(torch.float32),
        dropped_sum=msum(trace.dropped),
        retried_sum=msum(trace.retried),
        viol_sum=msum(trace.expired),
        misrouted_sum=msum(trace.misrouted),
        recovery_steps=trace.recovery.sum(dim=0),
    )
    if workflow is not None:
        workflow = workflow.to(trace.latency.device)
    return finalize_metrics(acc, trace.latency.shape[0], m, workflow, config=config)


def summarize(policy: str, trace: SimTrace, config: SimConfig = SimConfig(),
              active: torch.Tensor | None = None,
              workflow: Workflow | None = None) -> SimSummary:
    """Table II metrics from a trace (``active`` masks padded agents)."""
    vec, per_lat, per_tput, per_queue = trace_metrics(trace, active, workflow, config=config)
    m = dict(zip(METRIC_NAMES, vec.cpu().tolist()))
    return SimSummary.from_metrics(policy, m, per_lat.cpu(), per_tput.cpu(), per_queue.cpu())


def run_policy(
    policy: str,
    arrivals,
    fleet: Fleet,
    config: SimConfig = SimConfig(),
    workflow: Workflow | None = None,
    capacity: CapacityConfig | None = None,
    failures: FailureSpec | None = None,
    device="cuda",
) -> SimSummary:
    trace = simulate(policy, arrivals, fleet, config, workflow, capacity, failures, device)
    return summarize(policy, trace, config, fleet.active, workflow)


@torch.no_grad()
def simulate_stream_core(
    arrivals: torch.Tensor | None,
    fleet: Fleet,
    config: SimConfig,
    policy_names: Sequence[str] | None = None,
    workflow: Workflow | None = None,
    capacity: CapacityConfig | None = None,
    workload_spec=None,
    num_policy_blocks: int = 1,
    policy_block: int | None = None,
    block_size: int | None = None,
    gen_name: str | None = None,
    failures: FailureSpec | None = None,
):
    """Every named policy's run and its metrics in one pass over the
    horizon, with no (S, ·) trajectory kept: the sweep grids' path.

    The state is ``(P, *cells, N)``: P policy rows (``names[i]`` on row
    ``i``, once per step, ``allocator.policy_stack``) over the cells of a
    grid.  ``cells`` is the broadcast of the inputs' leading axes: the
    arrivals' ``(*A, S, N)`` (or the spec's leading shape), the fleet's,
    the workflow's, and a stacked capacity's or failure spec's.  Every input
    is already on the device and shaped to broadcast that way
    (``core/sweep.py`` arranges it).

    Per step, as ``simulate_core``: the EMA (seeded with the first row, not
    updated at t=0), the autoscaler of each row's own pool, the policies,
    the failure chains (shared by the policy rows, their bookkeeping per
    row, as the reference's ``simulate_stream_core``), the physics, the
    revoked share out of the warm pool; then the step folds into the
    running sums (``accumulate_metrics``).  With capacity and failures the
    pool's and the chains' states go last, as in the reference's carry.

    ``workload_spec`` (a ``WorkloadSpec``, or a ``workload.Synth`` prepared
    on the device) replaces ``arrivals``: each block of B =
    ``resolve_block_size(block_size)`` steps is synthesized in one
    ``step_block`` call (B = 1: one ``workload_step`` per step), and the
    failure uniforms of the block are drawn in one call.  A horizon that B
    does not divide ends in a shorter block.  Every B gives the same
    metrics bit for bit.  ``gen_name`` names the generator of every row
    (the direct-dispatch fast path).

    **Policy blocks** (``num_policy_blocks`` > 1): the named policy list is
    cut into equal contiguous blocks and this call computes only block
    ``policy_block`` (a host integer: the policy coordinate of a rank of
    the sweep mesh, ``core/sharding.py``), each of its policies once per
    step through ``allocator.policy_stack_blocks``; the state and metric
    rows shrink to P/blocks.

    The loop never waits on the device: steps and blocks are host
    integers, and every host value enters as a fill.

    Returns ``(metrics (*cells, P, M), per-agent latency (*cells, P, N),
    per-agent throughput, per-agent queue)``, P the rows of the block when
    blocked.
    """
    names = alloc.policy_names() if policy_names is None else tuple(policy_names)
    if (arrivals is None) == (workload_spec is None):
        raise ValueError("pass exactly one of arrivals= / workload_spec=")
    blocks = int(num_policy_blocks)
    if blocks > 1:
        if len(names) % blocks:
            raise ValueError(f"{len(names)} policies do not split into {blocks} equal blocks")
        if policy_block is None:
            raise ValueError("num_policy_blocks > 1 requires policy_block")
    dev = fleet.active.device
    p, n = len(names) // blocks, fleet.num_agents
    elastic, failing = capacity is not None, failures is not None
    synth = workload_spec
    if synth is not None and not isinstance(synth, workload_mod.Synth):
        synth = workload_mod.Synth(synth, dev, gen_name)
    if synth is not None:
        num_steps, lead = synth.num_steps, synth.lead
    else:
        num_steps, lead = arrivals.shape[-2], tuple(arrivals.shape[:-2])
    shapes = [lead, fleet.active.shape[:-1]]
    if workflow is not None:
        shapes.append(workflow.source.shape[:-1])
    if elastic and capacity.batched:
        shapes.append(capacity.policy_id.shape)
    if failing and failures.batched:
        shapes.append(failures.revoke_frac.shape)
    cells = tuple(torch.broadcast_shapes(*shapes))
    state = (p,) + cells + (n,)
    active = fleet.active
    route_eff = exit_frac = None
    if workflow is not None:
        route_eff = workflow.route * workflow.fan_out[..., :, None]
        exit_frac = torch.clamp(1.0 - workflow.route.sum(dim=-1), min=0.0)
    gate = active if workflow is None else active * workflow.source
    gate_blk = gate[..., None, :]

    def dispatch(t, lam, lam_ema, queue, budget):
        if blocks > 1:
            return alloc.policy_stack_blocks(t, lam, lam_ema, queue, fleet, budget, names,
                                             blocks, policy_block)
        return alloc.policy_stack(t, lam, lam_ema, queue, fleet, budget, names)

    wstate = synth.init() if synth is not None else None
    lam0 = (synth.step(wstate, 0)[0] if synth is not None else arrivals[..., 0, :]) * gate
    queue = torch.zeros(state, dtype=torch.float32, device=dev)
    lam_ema = lam0.expand(state)
    endo = None
    acc = init_metric_accum(n, (p,) + cells, dev)
    if elastic:
        cstate = cap_mod.init_capacity_state(config.g_total, dev, (p,) + cells)
    if failing:
        fstate = fail_mod.init_failure_state(n, dev, batch_shape=(p,) + cells, chain_shape=cells)
        fkey = failures.key_data
        if not isinstance(fkey, torch.Tensor):
            fkey = prng.key_t(fkey, dev)

    bsz = resolve_block_size(block_size)
    for t0 in range(0, num_steps, bsz):
        b = min(bsz, num_steps - t0)
        if synth is None:
            lam_blk = arrivals[..., t0:t0 + b, :] * gate_blk
        elif bsz == 1:
            row, wstate = synth.step(wstate, t0)
            lam_blk = row[..., None, :] * gate_blk
        else:
            lam_blk, wstate = synth.block(wstate, t0, b)
            lam_blk = lam_blk * gate_blk
        if failing:
            u_rev_blk, u_down_blk = fail_mod.failure_uniforms_t(fkey, t0, b, n)
        for j in range(b):
            t = t0 + j
            lam_exo = lam_blk[..., j, :]
            lam = lam_exo.expand(state) if endo is None else lam_exo + endo
            if t > 0:
                lam_ema = alloc.ema_forecast(lam_ema, lam, config.ema_alpha)
            pending_t = None
            if elastic:
                cstate, g_total_t, pending_t = cap_mod.capacity_step(
                    cstate, capacity, t, _total(lam), _total(lam_ema), _total(queue),
                    config.g_total, config.num_gpus,
                )
            else:
                g_total_t = config.g_total  # python float: the pre-capacity program
            g = dispatch(t, lam, lam_ema, queue, g_total_t)
            dropped = retried = viol = in_rec = None
            if failing:
                phi, avail, rev_nxt, down_nxt = fail_mod.advance_failures(
                    failures, t, fstate.rev_on, fstate.down, u_rev_blk[..., j],
                    u_down_blk[..., j, :])
                fail_t = torch.maximum(
                    (phi > 0).to(torch.float32),
                    (((1.0 - avail) * active) > 0.5).any(-1).to(torch.float32),
                )
                pre_q_tot = _total(queue * active)
                onset = fail_t * (1.0 - fstate.fail_prev) * (1.0 - fstate.recovering)
                q_mark = torch.where(onset > 0, pre_q_tot, fstate.q_mark)
                (served, new_queue, latency, completed, new_endo, mis,
                 new_retry_q, dropped, retried, viol) = _failure_queue_step(
                    queue, lam, g, fleet, config, route_eff, exit_frac,
                    failures, phi[..., None], avail, fstate.retry_q,
                )
                new_q_tot = _total(new_queue * active)
                in_rec = (1.0 - fail_t) * torch.maximum(fstate.fail_prev, fstate.recovering)
                recovering = torch.where(
                    fail_t > 0, fstate.recovering,
                    in_rec * (new_q_tot > q_mark).to(torch.float32),
                )
                fstate = fail_mod.FailureState(
                    rev_on=rev_nxt, down=down_nxt, fail_prev=fail_t,
                    recovering=recovering, q_mark=q_mark, retry_q=new_retry_q,
                )
                if elastic:
                    cstate = cap_mod.CapacityState(
                        cstate.warm * (1.0 - phi), cstate.pipeline, cstate.idle_s)
                warm_t = g_total_t * (1.0 - phi)  # billing excludes the revoked share
            else:
                served, new_queue, latency, completed, new_endo, mis = _queue_step(
                    queue, lam, g, fleet, config, route_eff, exit_frac)
                warm_t = g_total_t
            acc = accumulate_metrics(
                acc, active, g, served, new_queue, latency, completed, warm_t, pending_t,
                misrouted=mis, dropped=dropped, retried=retried, viol=viol, recovery=in_rec,
            )
            queue, endo = new_queue, new_endo
    out = finalize_metrics(acc, num_steps, active, workflow, config=config)
    return tuple(x.movedim(0, -2) for x in out)
