"""GPU-fraction allocation policies (port of ``repro/core/allocator.py``).

``adaptive_allocation`` is the paper's contribution (Algorithm 1), kept
faithful line-for-line.  ``static_equal`` and ``round_robin`` are the paper's
baselines; the rest are the reference package's beyond-paper policies.  All
policies are O(N) tensor arithmetic and return g with Σ g <= g_total and
g >= 0, for a python-float or a 0-d tensor ``g_total`` (including 0).

Every policy is registered under the uniform signature

    (t, lam_obs, lam_ema, queue, fleet, g_total) -> g

in the same order as the reference registry, so ``policy_names()`` (and the
integer policy id a later sweep port derives from it) is identical.  Entries
are mask-aware: ``fleet.active`` gates every input and the output, so padded
slots contribute zero demand and receive exactly g = 0.

Eager PyTorch evaluates ``a·b + c`` as two rounded operations, so the
reference's guard against fused multiply-add contraction (``_committed``)
has no counterpart here.
"""
from __future__ import annotations

from typing import Callable, TYPE_CHECKING

import torch

if TYPE_CHECKING:
    from repro_torch.core.agents import Fleet

_EPS = 1e-9


def _like(x, ref: torch.Tensor) -> torch.Tensor:
    """``x`` (python number or tensor) as a tensor of ``ref``'s dtype/device."""
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


def _normalize_capacity(g: torch.Tensor, g_total) -> torch.Tensor:
    """Algorithm 1 lines 19-25: proportional scale-down iff over capacity."""
    allocated = g.sum()
    scale = torch.where(
        allocated > g_total,
        g_total / torch.clamp(allocated, min=_EPS),
        torch.ones_like(allocated),
    )
    return g * scale


def adaptive_allocation(lam, min_gpu, priority, g_total=1.0) -> torch.Tensor:
    """Paper Algorithm 1, faithful.

    demand        d_i = lam_i * R_i / P_i                 (line 5)
    proportional  g_i = d_i / D_total * G_total           (line 15)
    minimum       g_i = max(R_i, g_i)                     (line 16)
    normalize     g *= G_total / G_allocated if over      (lines 21-25)
    All-idle fleets (D_total == 0) release everything     (lines 10-12).
    """
    demand = lam * min_gpu / priority
    d_total = demand.sum()
    prop = demand / torch.clamp(d_total, min=_EPS) * g_total
    g = torch.maximum(min_gpu, prop)
    g = _normalize_capacity(g, g_total)
    return torch.where(d_total > 0, g, torch.zeros_like(g))


def masked_static_equal(active: torch.Tensor, g_total=1.0) -> torch.Tensor:
    """G_total/N_active to each unmasked agent, 0 to padding."""
    n_active = torch.clamp(active.sum(), min=1.0)
    return (active * (g_total / n_active)).to(torch.float32)


def masked_round_robin(t, active: torch.Tensor, g_total=1.0) -> torch.Tensor:
    """The full GPU goes to the (t mod N_active)-th unmasked agent.

    The rotation is integer arithmetic so a long-running engine never skips
    agents to float rounding of the tick.
    """
    n_active = torch.clamp(active.sum().to(torch.int32), min=1)
    rank = (torch.cumsum(active, 0) - 1.0).to(torch.int32)  # rank among active
    chosen = torch.remainder(torch.as_tensor(t).to(torch.int32), n_active)
    share = torch.where(rank == chosen, _like(g_total, active), torch.zeros_like(active))
    return (active * share).to(torch.float32)


# ---------------------------------------------------------------------------
# Beyond-paper policies.
# ---------------------------------------------------------------------------

def water_filling(queue, lam, base_throughput, min_gpu, g_total=1.0) -> torch.Tensor:
    """Equalize projected latency (q + lam)/(g·T) across busy agents:
    g_i ∝ (q_i + lam_i)/T_i, then Algorithm 1's floors and normalization."""
    pressure = (queue + lam) / torch.clamp(base_throughput, min=_EPS)
    total = pressure.sum()
    prop = pressure / torch.clamp(total, min=_EPS) * g_total
    g = torch.maximum(torch.where(pressure > 0, min_gpu, torch.zeros_like(min_gpu)), prop)
    g = _normalize_capacity(g, g_total)
    return torch.where(total > 0, g, torch.zeros_like(g))


def sqrt_demand(queue, lam, base_throughput, min_gpu, g_total=1.0) -> torch.Tensor:
    """Square-root fair share: g_i ∝ √((q_i + lam_i)/T_i), floors keyed on
    the raw pressure (same busy set as water-filling)."""
    pressure = (queue + lam) / torch.clamp(base_throughput, min=_EPS)
    weight = torch.sqrt(pressure)
    total = weight.sum()
    prop = weight / torch.clamp(total, min=_EPS) * g_total
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
    order (stable) until each one's backlog is covered."""
    zero = torch.zeros_like(min_gpu)
    busy = (queue + lam) > 0
    g = torch.where(busy, min_gpu, zero)
    need = torch.where(busy, (queue + lam) / torch.clamp(base_throughput, min=_EPS), zero)
    extra_need = torch.clamp(need - g, min=0.0)
    residual = torch.clamp(g_total - g.sum(), min=0.0)
    order = torch.argsort(-base_throughput, stable=True)
    sorted_need = extra_need[order]
    cum_before = torch.cumsum(sorted_need, 0) - sorted_need
    grant_sorted = torch.minimum(torch.clamp(residual - cum_before, min=0.0), sorted_need)
    grant = torch.zeros_like(grant_sorted).scatter(0, order, grant_sorted)
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
    as ``jnp.minimum``/``jnp.maximum`` do.
    """
    mask = torch.ones_like(queue) if active is None else active
    busy = mask * (queue + lam) > 0
    floor = torch.where(busy, min_gpu, torch.zeros_like(min_gpu))
    n_active = torch.clamp(mask.sum(), min=1.0)
    cap_floor = _like(1e-6, queue)
    lat_cap = _like(latency_cap, queue)
    one = _like(1.0, queue)

    def objective(g):
        capacity = g * base_throughput
        served = torch.minimum(capacity, queue + lam) * mask
        new_q = (queue + lam) * mask - served
        lat = torch.minimum(new_q / torch.maximum(capacity, cap_floor), lat_cap)
        return alpha * (lat * mask).sum() / n_active - gamma * served.sum()

    def project(g):
        g = torch.minimum(torch.maximum(g, floor), one) * mask
        return _normalize_capacity(g, g_total)

    g0 = adaptive_allocation(lam, min_gpu, priority, g_total)
    g0 = torch.where(busy.any(), g0, torch.zeros_like(g0))
    g = project(g0).detach()
    with torch.enable_grad():
        for _ in range(steps):
            g_var = g.requires_grad_(True)
            (grad,) = torch.autograd.grad(objective(g_var), g_var)
            g = project(g_var.detach() - lr * grad)
    return torch.where(busy.any(), g, torch.zeros_like(g))


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


def get_policy(name: str) -> PolicyFn:
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown policy {name!r}; registered policies: {policy_names()}"
        )
    return _REGISTRY[name]


def dispatch(name: str, t, lam_obs, lam_ema, queue, fleet: "Fleet", g_total=1.0) -> torch.Tensor:
    """Eager by-name dispatch (the serving-engine path)."""
    return get_policy(name)(t, lam_obs, lam_ema, queue, fleet, g_total)


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
