"""GPU-fraction allocation policies (port of ``repro/core/allocator.py``).

``adaptive_allocation`` is the paper's contribution (Algorithm 1), kept
faithful line-for-line.  ``static_equal`` and ``round_robin`` are the paper's
baselines; the rest are the reference package's beyond-paper policies.  All
policies are O(N) tensor arithmetic and return g with Σ g <= g_total and
g >= 0, for a python-float or a 0-d tensor ``g_total`` (including 0).

Every policy is registered under the uniform signature

    (t, lam_obs, lam_ema, queue, fleet, g_total) -> g

in the same order as the reference registry, so ``policy_names()`` and
``policy_id`` are identical.  Entries are mask-aware: ``fleet.active`` gates
every input and the output, so padded slots contribute zero demand and
receive exactly g = 0.

Every policy takes a batch of rows: the state is ``(..., N)``, the fleet's
leaves broadcast against it, and every reduction runs over the last axis
only, so each row is allocated on its own.  ``g_total`` is a python float, a
0-d tensor, or a ``(..., 1)`` tensor of per-row budgets.  For one (N,) row
this is the single-row program, bit for bit.  ``policy_stack`` runs each
named policy once per step on its own row of a ``(P, ..., N)`` state: the
streaming sweep's dispatch (``core/simulator.py::simulate_stream_core``).

Eager PyTorch evaluates ``a·b + c`` as two rounded operations, so the
reference's guard against fused multiply-add contraction (``_committed``)
has no counterpart here.
"""
from __future__ import annotations

from typing import Callable, Sequence, TYPE_CHECKING

import torch

from repro_torch._device import resolve_device

if TYPE_CHECKING:
    from repro_torch.core.agents import Fleet

_EPS = 1e-9


def _like(x, ref: torch.Tensor) -> torch.Tensor:
    """``x`` (python number or tensor) as a tensor of ``ref``'s dtype/device.

    A python number becomes a fill on ``ref``'s device rather than a copy
    from the host, so the simulator's step loop on the card never syncs.
    """
    if isinstance(x, torch.Tensor):
        return x.to(dtype=ref.dtype, device=ref.device)
    return torch.full((), x, dtype=ref.dtype, device=ref.device)


def _normalize_capacity(g: torch.Tensor, g_total) -> torch.Tensor:
    """Algorithm 1 lines 19-25: proportional scale-down iff over capacity.

    Whether a fleet is over capacity decides the whole allocation (a
    scaled-down agent keeps a queue residue, which makes it busy and earns
    it a floor next step), so the total runs in float64 and the result
    rounds to float32 once: the same on every device whatever order it sums
    in (at N = 256 a float32 sum in another order moves a cell's latency by
    half)."""
    allocated = g.sum(-1, keepdim=True, dtype=torch.float64)
    scale = torch.where(
        allocated > g_total,
        g_total / torch.clamp(allocated, min=_EPS),
        torch.ones_like(allocated),
    )
    return (g * scale).to(torch.float32)


def adaptive_allocation(lam, min_gpu, priority, g_total=1.0) -> torch.Tensor:
    """Paper Algorithm 1, faithful.

    demand        d_i = lam_i * R_i / P_i                 (line 5)
    proportional  g_i = d_i / D_total * G_total           (line 15)
    minimum       g_i = max(R_i, g_i)                     (line 16)
    normalize     g *= G_total / G_allocated if over      (lines 21-25)
    All-idle fleets (D_total == 0) release everything     (lines 10-12).

    D_total runs in float64 and each share rounds to float32 once, as in
    ``_normalize_capacity``: the shares decide whether the fleet is over
    capacity, so they must not depend on the order a device sums in.
    """
    demand = lam * min_gpu / priority
    d_total = demand.sum(-1, keepdim=True, dtype=torch.float64)
    prop = (demand / torch.clamp(d_total, min=_EPS) * g_total).to(torch.float32)
    g = torch.maximum(min_gpu, prop)
    g = _normalize_capacity(g, g_total)
    return torch.where(d_total > 0, g, torch.zeros_like(g))


def static_equal(num_agents: int, g_total=1.0, device="cuda") -> torch.Tensor:
    """Baseline: G_total/N to every agent, regardless of load."""
    return torch.full((num_agents,), g_total / num_agents, dtype=torch.float32,
                      device=resolve_device(device))


def masked_static_equal(active: torch.Tensor, g_total=1.0) -> torch.Tensor:
    """G_total/N_active to each unmasked agent, 0 to padding."""
    n_active = torch.clamp(active.sum(-1, keepdim=True), min=1.0)
    return (active * (g_total / n_active)).to(torch.float32)


def round_robin(t, num_agents: int, g_total=1.0, device="cuda") -> torch.Tensor:
    """Baseline: 100% of the GPU to agent (t mod N) — '100% sequential'."""
    dev = resolve_device(device)
    agent = torch.remainder(torch.as_tensor(t, device=dev).to(torch.int64), num_agents)
    return torch.nn.functional.one_hot(agent, num_agents).to(torch.float32) * g_total


def masked_round_robin(t, active: torch.Tensor, g_total=1.0) -> torch.Tensor:
    """The full GPU goes to the (t mod N_active)-th unmasked agent.

    The rotation is integer arithmetic so a long-running engine never skips
    agents to float rounding of the tick.
    """
    n_active = torch.clamp(active.sum(-1, keepdim=True).to(torch.int32), min=1)
    rank = (torch.cumsum(active, -1) - 1.0).to(torch.int32)  # rank among active
    chosen = torch.remainder(torch.as_tensor(t).to(torch.int32), n_active)
    share = torch.where(rank == chosen, _like(g_total, active), torch.zeros_like(active))
    return (active * share).to(torch.float32)


# ---------------------------------------------------------------------------
# Beyond-paper policies.
# ---------------------------------------------------------------------------

def water_filling(queue, lam, base_throughput, min_gpu, g_total=1.0) -> torch.Tensor:
    """Equalize projected latency (q + lam)/(g·T) across busy agents:
    g_i ∝ (q_i + lam_i)/T_i, then Algorithm 1's floors and normalization
    (the total in float64, as ``adaptive_allocation``'s)."""
    pressure = (queue + lam) / torch.clamp(base_throughput, min=_EPS)
    total = pressure.sum(-1, keepdim=True, dtype=torch.float64)
    prop = (pressure / torch.clamp(total, min=_EPS) * g_total).to(torch.float32)
    g = torch.maximum(torch.where(pressure > 0, min_gpu, torch.zeros_like(min_gpu)), prop)
    g = _normalize_capacity(g, g_total)
    return torch.where(total > 0, g, torch.zeros_like(g))


def sqrt_demand(queue, lam, base_throughput, min_gpu, g_total=1.0) -> torch.Tensor:
    """Square-root fair share: g_i ∝ √((q_i + lam_i)/T_i), floors keyed on
    the raw pressure (same busy set as water-filling; the total in
    float64, as ``adaptive_allocation``'s)."""
    pressure = (queue + lam) / torch.clamp(base_throughput, min=_EPS)
    weight = torch.sqrt(pressure)
    total = weight.sum(-1, keepdim=True, dtype=torch.float64)
    prop = (weight / torch.clamp(total, min=_EPS) * g_total).to(torch.float32)
    g = torch.maximum(torch.where(pressure > 0, min_gpu, torch.zeros_like(min_gpu)), prop)
    g = _normalize_capacity(g, g_total)
    return torch.where(total > 0, g, torch.zeros_like(g))


def ema_water_filling(queue, lam_ema, base_throughput, min_gpu, g_total=1.0) -> torch.Tensor:
    """Water-filling on the EMA forecast instead of the instantaneous rate."""
    return water_filling(queue, lam_ema, base_throughput, min_gpu, g_total)


def ema_forecast(lam_prev_ema, lam_obs, alpha: float = 0.3) -> torch.Tensor:
    """One EMA update; the predictive policy's workload model."""
    return alpha * lam_obs + (1.0 - alpha) * lam_prev_ema


def predictive_adaptive(lam_ema, min_gpu, priority, g_total=1.0) -> torch.Tensor:
    """Algorithm 1 on the EMA-forecast arrival rate (paper §VI future work)."""
    return adaptive_allocation(lam_ema, min_gpu, priority, g_total)


def throughput_greedy(queue, lam, base_throughput, min_gpu, g_total=1.0) -> torch.Tensor:
    """Maximize Σ_i min(g_i·T_i, q_i + lam_i) s.t. g >= R on busy agents:
    after the floors, residual capacity goes to agents in decreasing T_i
    order (stable) until each one's backlog is covered.

    The last agent served gets what is left, the budget minus two sums over
    the agents; a starved agent's latency q/(g·T) magnifies any rounding
    of that difference.  The sums run in float64 and the grant rounds to
    float32 once, so that it does not depend on the order a device sums in
    (the card's parallel scan, the host's sequential one)."""
    zero = torch.zeros_like(min_gpu)
    busy = (queue + lam) > 0
    g = torch.where(busy, min_gpu, zero)
    need = torch.where(busy, (queue + lam) / torch.clamp(base_throughput, min=_EPS), zero)
    extra_need = torch.clamp(need - g, min=0.0)
    residual = torch.clamp(g_total - g.sum(-1, keepdim=True, dtype=torch.float64), min=0.0)
    order = torch.argsort(-base_throughput, dim=-1, stable=True)
    shape = torch.broadcast_shapes(extra_need.shape, order.shape)
    order = order.expand(shape)
    sorted_need = extra_need.expand(shape).gather(-1, order)
    cum_before = torch.cumsum(sorted_need, -1, dtype=torch.float64) - sorted_need
    left = torch.clamp(residual - cum_before, min=0.0).to(torch.float32)
    grant_sorted = torch.minimum(left, sorted_need)
    grant = torch.zeros_like(grant_sorted).scatter(-1, order, grant_sorted)
    return _normalize_capacity(g + grant, g_total)


def objective_descent(
    queue, lam, base_throughput, min_gpu, priority, g_total=1.0, *,
    alpha: float = 1.0, gamma: float = 10.0, steps: int = 12, lr: float = 0.05,
    latency_cap: float = 1000.0, active: torch.Tensor | None = None,
) -> torch.Tensor:
    """Optimize the paper's Eq. (2) by projected gradient.

    One-step lookahead objective alpha·L(g) − gamma·H(g), differentiated
    with ``torch.autograd.grad`` through the smooth queue dynamics;
    projection = clip to [R_i·busy, 1] then capacity-normalize.  ``steps``
    iterations of a Python loop replace the reference's ``fori_loop``.
    ``torch.minimum``/``torch.maximum`` split the gradient evenly at ties,
    as ``jnp.minimum``/``jnp.maximum`` do.  Over a batch of rows the
    objective is summed over the rows, so each row gets its own gradient.
    """
    mask = torch.ones_like(queue) if active is None else active
    busy = mask * (queue + lam) > 0
    floor = torch.where(busy, min_gpu, torch.zeros_like(min_gpu))
    n_active = torch.clamp(mask.sum(-1), min=1.0)
    cap_floor = _like(1e-6, queue)
    lat_cap = _like(latency_cap, queue)
    one = _like(1.0, queue)

    def objective(g):
        capacity = g * base_throughput
        served = torch.minimum(capacity, queue + lam) * mask
        new_q = (queue + lam) * mask - served
        lat = torch.minimum(new_q / torch.maximum(capacity, cap_floor), lat_cap)
        per_row = alpha * (lat * mask).sum(-1) / n_active - gamma * served.sum(-1)
        return per_row.sum()

    def project(g):
        g = torch.minimum(torch.maximum(g, floor), one) * mask
        return _normalize_capacity(g, g_total)

    any_busy = busy.any(-1, keepdim=True)
    g0 = adaptive_allocation(lam, min_gpu, priority, g_total)
    g0 = torch.where(any_busy, g0, torch.zeros_like(g0))
    g = project(g0).detach()
    with torch.enable_grad():
        for _ in range(steps):
            g_var = g.requires_grad_(True)
            (grad,) = torch.autograd.grad(objective(g_var), g_var)
            g = project(g_var.detach() - lr * grad)
    return torch.where(any_busy, g, torch.zeros_like(g))


# ---------------------------------------------------------------------------
# Policy registry — the single dispatch table, in the reference's order.
# ---------------------------------------------------------------------------

PolicyFn = Callable[..., torch.Tensor]

_REGISTRY: dict[str, PolicyFn] = {}


def register_policy(name: str) -> Callable[[PolicyFn], PolicyFn]:
    """Register ``fn(t, lam_obs, lam_ema, queue, fleet, g_total) -> g``;
    registry order defines the stable integer policy id."""

    def deco(fn: PolicyFn) -> PolicyFn:
        if name in _REGISTRY:
            raise ValueError(f"policy {name!r} already registered")
        _REGISTRY[name] = fn
        return fn

    return deco


def policy_names() -> tuple[str, ...]:
    """All registered policies, in registration (= policy-id) order."""
    return tuple(_REGISTRY)


def policy_id(name: str) -> int:
    """Integer id of a registered policy (its index in ``policy_names()``)."""
    get_policy(name)
    return policy_names().index(name)


def get_policy(name: str) -> PolicyFn:
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown policy {name!r}; registered policies: {policy_names()}"
        )
    return _REGISTRY[name]


def dispatch(name: str, t, lam_obs, lam_ema, queue, fleet: "Fleet", g_total=1.0) -> torch.Tensor:
    """Eager by-name dispatch (the serving-engine path)."""
    return get_policy(name)(t, lam_obs, lam_ema, queue, fleet, g_total)


def policy_switch(policy_id: int, t, lam_obs, lam_ema, queue, fleet: "Fleet", g_total=1.0,
                  names: Sequence[str] | None = None) -> torch.Tensor:
    """Dispatch by integer id over ``names`` (default: the live registry
    order).  The id is a host value: the port evaluates the one policy it
    names, where the reference's ``lax.switch`` would select a branch."""
    names = policy_names() if names is None else tuple(names)
    return get_policy(names[int(policy_id)])(t, lam_obs, lam_ema, queue, fleet, g_total)


def policy_stack(t, lam_obs, lam_ema, queue, fleet: "Fleet", g_total,
                 names: Sequence[str] | None = None) -> torch.Tensor:
    """Evaluate each named policy exactly once, ``names[i]`` on row ``i`` of
    the ``(P, ..., N)`` state: the streaming sweep's O(P) dispatch.

    ``g_total`` is one budget shared by every row (python float or 0-d
    tensor) or a ``(P, ...)`` tensor of per-row budgets (each policy row
    drives its own warm pool under elastic capacity).  Returns g of the
    state's shape.
    """
    names = policy_names() if names is None else tuple(names)
    per_row = isinstance(g_total, torch.Tensor) and g_total.ndim > 0
    rows = []
    for i, name in enumerate(names):
        budget = g_total[i].unsqueeze(-1) if per_row else g_total
        g = get_policy(name)(t, lam_obs[i], lam_ema[i], queue[i], fleet, budget)
        rows.append(g.expand(lam_obs[i].shape))
    return torch.stack(rows)


def policy_stack_blocks(t, lam_obs, lam_ema, queue, fleet: "Fleet", g_total,
                        names: Sequence[str], num_blocks: int, block_index: int) -> torch.Tensor:
    """``policy_stack`` over one contiguous block of ``names``: block
    ``block_index`` of ``num_blocks`` equal blocks, whose rows the state
    holds.  Each policy of the block still runs once per step."""
    names = tuple(names)
    if num_blocks <= 0 or len(names) % num_blocks:
        raise ValueError(f"{len(names)} policies do not split into {num_blocks} equal blocks")
    size = len(names) // num_blocks
    block = names[int(block_index) * size:(int(block_index) + 1) * size]
    return policy_stack(t, lam_obs, lam_ema, queue, fleet, g_total, block)


@register_policy("static_equal")
def _static_equal_entry(t, lam_obs, lam_ema, queue, fleet, g_total):
    return masked_static_equal(fleet.active, g_total)


@register_policy("round_robin")
def _round_robin_entry(t, lam_obs, lam_ema, queue, fleet, g_total):
    return masked_round_robin(t, fleet.active, g_total)


@register_policy("adaptive")
def _adaptive_entry(t, lam_obs, lam_ema, queue, fleet, g_total):
    m = fleet.active
    return adaptive_allocation(lam_obs * m, fleet.min_gpu * m, fleet.priority, g_total) * m


@register_policy("water_filling")
def _water_filling_entry(t, lam_obs, lam_ema, queue, fleet, g_total):
    m = fleet.active
    return water_filling(
        queue * m, lam_obs * m, fleet.base_throughput, fleet.min_gpu * m, g_total
    ) * m


@register_policy("predictive")
def _predictive_entry(t, lam_obs, lam_ema, queue, fleet, g_total):
    m = fleet.active
    return predictive_adaptive(lam_ema * m, fleet.min_gpu * m, fleet.priority, g_total) * m


@register_policy("throughput_greedy")
def _throughput_greedy_entry(t, lam_obs, lam_ema, queue, fleet, g_total):
    m = fleet.active
    return throughput_greedy(
        queue * m, lam_obs * m, fleet.base_throughput, fleet.min_gpu * m, g_total
    ) * m


@register_policy("objective_descent")
def _objective_descent_entry(t, lam_obs, lam_ema, queue, fleet, g_total):
    m = fleet.active
    return objective_descent(
        queue * m, lam_obs * m, fleet.base_throughput, fleet.min_gpu * m,
        fleet.priority, g_total, active=m,
    ) * m


@register_policy("sqrt_demand")
def _sqrt_demand_entry(t, lam_obs, lam_ema, queue, fleet, g_total):
    m = fleet.active
    return sqrt_demand(
        queue * m, lam_obs * m, fleet.base_throughput, fleet.min_gpu * m, g_total
    ) * m


@register_policy("ema_water_filling")
def _ema_water_filling_entry(t, lam_obs, lam_ema, queue, fleet, g_total):
    m = fleet.active
    return ema_water_filling(
        queue * m, lam_ema * m, fleet.base_throughput, fleet.min_gpu * m, g_total
    ) * m
