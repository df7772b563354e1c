"""Serverless capacity layer: a discrete warm pool with cold starts (port of
``repro/core/capacity.py``).

The allocator's budget ``g_total(t)`` is the output of a warm-pool
autoscaler over whole instances, and billing counts warm-instance-seconds:

* the pool holds ``warm`` instances (each adds 1.0 to the allocator's
  budget) plus ``pending`` instances still cold;
* every step a registered **capacity policy** looks at the fleet-wide
  intake, its EMA forecast, the backlog and the idle clock, and returns a
  desired warm count.  Scale-down is instantaneous; scale-up requests enter
  a delay line and serve nothing for ``round(cold_start_s)`` steps;
* ``num_gpus`` is the instance ceiling.

The registry holds ``fixed`` / ``reactive`` / ``scale_to_zero`` in the
reference's order, so capacity-policy ids agree.  The simulator runs
``capacity_step`` on the card inside its step loop, the serving engine on
the host once per tick: one definition for both.

The port keeps the two selectors that decide control flow on the host as
Python values (``policy_id`` and ``cold_start_s``, which fixes the
delay-line slot), and the knobs the policies compute with as float32
tensors that move to the simulator's device (``CapacityConfig.to``).

``stack_capacities`` stacks configs on a leading capacity axis for
``core/sweep.py::sweep_capacity``: there every leaf, the policy id and the
cold start too, is a tensor, so each row evaluates all three capacity
policies and selects its own, and the cold-start request enters the delay
line through a one-hot over its fixed horizon.  The pool state may carry
leading axes (a streaming sweep's policy and cell axes); the delay line is
its last axis.  One config over one pool runs the single-row program, bit
for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device

_EPS = 1e-9

# Length of the cold-start delay line: one slot per whole second a
# requested instance can still be cold.
COLD_START_HORIZON = 32


def billing_cost(instance_seconds, price_per_hour: float):
    """Dollars for ``instance_seconds`` of warm capacity — THE billing formula.

    Provisioned billing is the special case ``instance_seconds =
    num_gpus · duration``; serverless billing passes ``Σ_t warm(t) · 1 s``.
    """
    return instance_seconds / 3600.0 * price_per_hour


def check_budget_ceiling(g_total: float, num_gpus: float) -> None:
    """A static budget that could never be provisioned under its own
    instance ceiling is a config error."""
    if g_total > num_gpus:
        raise ValueError(
            f"g_total={g_total} exceeds the instance ceiling num_gpus={num_gpus}"
        )


def _f32(x, device="cpu") -> torch.Tensor:
    """A 0-d float32 tensor filled on ``device`` (no copy from the host)."""
    return torch.full((), x, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class CapacityConfig:
    """One capacity policy and its knobs.

    ``policy_id`` (the registry index) and ``cold_start_s`` (rounded to
    float32) are host values; the other knobs are 0-d float32 tensors.  A
    stacked config (``stack_capacities``) holds every field, these two
    too, as a (C,) tensor.
    """

    policy_id: int | torch.Tensor
    cold_start_s: float | torch.Tensor     # seconds pending before warm
    keep_alive_s: torch.Tensor             # () idle window (scale_to_zero)
    target_rate_per_instance: torch.Tensor  # () rps one instance absorbs
    backlog_per_instance: torch.Tensor     # () queued reqs per extra instance
    min_instances: torch.Tensor            # () reactive floor
    name: str = "capacity"

    @property
    def batched(self) -> bool:
        return isinstance(self.policy_id, torch.Tensor)

    @property
    def policy(self) -> str:
        """Registry name of the selected capacity policy."""
        return capacity_policy_names()[self.policy_id]

    @property
    def delay(self) -> int:
        """Whole steps a requested instance stays cold: ``round(cold_start_s)``
        with ties to even, as ``jnp.round``, clipped to the delay line."""
        return min(max(round(self.cold_start_s), 0), COLD_START_HORIZON - 1)

    def to(self, device) -> "CapacityConfig":
        return self.map(lambda x: x.to(device))

    def map(self, fn) -> "CapacityConfig":
        """``fn`` applied to every tensor leaf (the stacked selectors too)."""
        tensors = {f: getattr(self, f) for f in _TENSOR_FIELDS}
        if self.batched:
            tensors.update(policy_id=self.policy_id, cold_start_s=self.cold_start_s)
        return dataclasses.replace(self, **{f: fn(v) for f, v in tensors.items()})


_TENSOR_FIELDS = ("keep_alive_s", "target_rate_per_instance", "backlog_per_instance",
                  "min_instances")


def capacity_config(
    policy: str = "fixed",
    *,
    cold_start_s: float = 0.0,
    keep_alive_s: float = 10.0,
    target_rate_per_instance: float = 60.0,
    backlog_per_instance: float = 50.0,
    min_instances: float = 0.0,
    name: str | None = None,
) -> CapacityConfig:
    """Build a ``CapacityConfig`` by capacity-policy name (the reference's
    defaults: one instance serves ~60 rps, ~50 queued requests justify an
    extra instance)."""
    return CapacityConfig(
        policy_id=capacity_policy_id(policy),
        cold_start_s=float(np.float32(cold_start_s)),
        keep_alive_s=_f32(keep_alive_s),
        target_rate_per_instance=_f32(target_rate_per_instance),
        backlog_per_instance=_f32(backlog_per_instance),
        min_instances=_f32(min_instances),
        name=policy if name is None else name,
    )


def check_capacity(cap: CapacityConfig, g_total: float, num_gpus: float) -> None:
    """Eager sanity constraints, checked before a run (one config or a
    stacked batch)."""
    value = lambda x: np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x, np.float64)
    cold = value(cap.cold_start_s)
    if (cold < 0).any() or (cold > COLD_START_HORIZON - 1).any():
        raise ValueError(
            f"cold_start_s must be in [0, {COLD_START_HORIZON - 1}] "
            f"(COLD_START_HORIZON), got {cold}"
        )
    if (value(cap.keep_alive_s) < 0).any():
        raise ValueError(f"keep_alive_s must be >= 0: {value(cap.keep_alive_s)}")
    if (value(cap.target_rate_per_instance) <= 0).any():
        raise ValueError("target_rate_per_instance must be positive")
    if (value(cap.backlog_per_instance) <= 0).any():
        raise ValueError("backlog_per_instance must be positive")
    mins = value(cap.min_instances)
    if (mins < 0).any() or (mins > num_gpus).any():
        raise ValueError(f"min_instances must be in [0, num_gpus={num_gpus}]: {mins}")
    check_budget_ceiling(g_total, num_gpus)


def stack_capacities(caps: Sequence[CapacityConfig]) -> CapacityConfig:
    """Stack configs on a new leading capacity axis: every field becomes a
    (C,) tensor (the policy id int64, the cold start float32)."""
    caps = list(caps)
    if not caps:
        raise ValueError("stack_capacities needs at least one config")
    if any(c.batched for c in caps):
        raise ValueError("stack_capacities takes single configs")
    stack = lambda field: torch.stack([getattr(c, field).cpu() for c in caps])
    return CapacityConfig(
        policy_id=torch.tensor([c.policy_id for c in caps], dtype=torch.int64),
        cold_start_s=torch.tensor([c.cold_start_s for c in caps], dtype=torch.float32),
        **{f: stack(f) for f in _TENSOR_FIELDS},
        name="stacked",
    )


@dataclasses.dataclass
class CapacityState:
    """The warm pool's state between steps.

    ``pipeline[..., k]`` is the number of requested instances that become
    warm in ``k`` steps; ``idle_s`` counts consecutive seconds with zero
    fleet-wide demand (the keep-alive clock).  Leaves may carry leading
    batch axes.
    """

    warm: torch.Tensor      # (...,) serving instances
    pipeline: torch.Tensor  # (..., COLD_START_HORIZON) cold cohorts
    idle_s: torch.Tensor    # (...,)


def init_capacity_state(g_total: float, device="cuda", batch_shape: tuple = ()) -> CapacityState:
    """The pool at t=0: the provisioned baseline is already warm, on
    ``device`` (``cuda`` unless the caller asks for the host)."""
    device = resolve_device(device)
    return CapacityState(
        warm=torch.full(batch_shape, g_total, dtype=torch.float32, device=device),
        pipeline=torch.zeros(batch_shape + (COLD_START_HORIZON,), dtype=torch.float32,
                             device=device),
        idle_s=torch.zeros(batch_shape, dtype=torch.float32, device=device),
    )


# ---------------------------------------------------------------------------
# Capacity-policy registry, in the reference's order.
#
# Uniform signature:
#   (t, lam_tot, lam_ema_tot, queue_tot, warm, pending, idle_s,
#    cap, g_total, num_gpus) -> desired warm count (0-d tensor)
# ---------------------------------------------------------------------------

CapacityPolicyFn = Callable[..., torch.Tensor]

_CAP_REGISTRY: dict[str, CapacityPolicyFn] = {}


def register_capacity_policy(name: str) -> Callable[[CapacityPolicyFn], CapacityPolicyFn]:
    def deco(fn: CapacityPolicyFn) -> CapacityPolicyFn:
        if name in _CAP_REGISTRY:
            raise ValueError(f"capacity policy {name!r} already registered")
        _CAP_REGISTRY[name] = fn
        return fn

    return deco


def capacity_policy_names() -> tuple[str, ...]:
    """All registered capacity policies, in registration (= id) order."""
    return tuple(_CAP_REGISTRY)


def capacity_policy_id(name: str) -> int:
    if name not in _CAP_REGISTRY:
        raise ValueError(
            f"unknown capacity policy {name!r}; registered: {capacity_policy_names()}"
        )
    return capacity_policy_names().index(name)


def _reactive_desired(lam_ema_tot, queue_tot, cap):
    """Whole instances for the forecast rate, whole extra instances for the
    standing backlog."""
    rate_need = torch.ceil(
        lam_ema_tot / torch.clamp(cap.target_rate_per_instance, min=_EPS))
    backlog_boost = torch.floor(
        queue_tot / torch.clamp(cap.backlog_per_instance, min=_EPS))
    return rate_need + backlog_boost


@register_capacity_policy("fixed")
def _fixed(t, lam_tot, lam_ema_tot, queue_tot, warm, pending, idle_s, cap,
           g_total, num_gpus):
    """Always-on provisioned pool — the pre-capacity static budget."""
    return torch.full_like(warm, g_total)


@register_capacity_policy("reactive")
def _reactive(t, lam_tot, lam_ema_tot, queue_tot, warm, pending, idle_s, cap,
              g_total, num_gpus):
    desired = _reactive_desired(lam_ema_tot, queue_tot, cap)
    return torch.clamp(torch.maximum(desired, cap.min_instances), max=num_gpus)


@register_capacity_policy("scale_to_zero")
def _scale_to_zero(t, lam_tot, lam_ema_tot, queue_tot, warm, pending, idle_s,
                   cap, g_total, num_gpus):
    """Reactive scaling that releases the whole pool after ``keep_alive_s``
    idle seconds; while any demand is present the floor is
    ``max(min_instances, 1)``."""
    desired = _reactive_desired(lam_ema_tot, queue_tot, cap)
    floor = torch.clamp(cap.min_instances, min=1.0)
    active_desired = torch.clamp(torch.maximum(desired, floor), max=num_gpus)
    return torch.where(idle_s <= cap.keep_alive_s, active_desired,
                       torch.zeros_like(active_desired))


def capacity_step(
    state: CapacityState,
    cap: CapacityConfig,
    t,
    lam_tot: torch.Tensor,
    lam_ema_tot: torch.Tensor,
    queue_tot: torch.Tensor,
    g_total: float,
    num_gpus: float,
) -> tuple[CapacityState, torch.Tensor, torch.Tensor]:
    """One autoscaler tick; returns ``(new_state, warm, pending)`` where
    ``warm`` is the step's allocator budget ``g_total(t)``.

    Order within a step, as the reference: (1) cohorts whose cold start
    elapsed become warm, (2) the idle clock advances, (3) the capacity
    policy picks a desired count, (4) scale-down is instantaneous, (5)
    missing instances (beyond warm + pending) are requested and enter the
    delay line at ``round(cold_start_s)`` — a zero cold start serves the
    same step.  All on the device of ``state``, with no host sync.
    """
    warm = state.warm + state.pipeline[..., 0]
    pipeline = torch.cat([state.pipeline[..., 1:], torch.zeros_like(state.pipeline[..., :1])],
                         dim=-1)
    busy = (lam_tot + queue_tot) > 0
    idle_s = torch.where(busy, torch.zeros_like(state.idle_s), state.idle_s + 1.0)
    pending = pipeline.sum(-1)
    if cap.batched:
        # Every row evaluates each capacity policy and keeps its own.
        desired = torch.zeros_like(warm)
        for k, fn in enumerate(_CAP_REGISTRY.values()):
            d = fn(t, lam_tot, lam_ema_tot, queue_tot, warm, pending, idle_s, cap,
                   g_total, num_gpus)
            desired = torch.where(cap.policy_id == k, d, desired)
    else:
        desired = _CAP_REGISTRY[cap.policy](
            t, lam_tot, lam_ema_tot, queue_tot, warm, pending, idle_s, cap,
            g_total, num_gpus,
        )
    warm = torch.minimum(warm, desired)
    request = torch.clamp(desired - (warm + pending), min=0.0)
    # Slot k is consumed at the start of step t+k+1, so a d-second cold
    # start lands in slot d-1 (d = 0 was served directly above).
    if cap.batched:
        delay = torch.clamp(torch.round(cap.cold_start_s), 0, COLD_START_HORIZON - 1)
        direct = torch.where(delay == 0, request, torch.zeros_like(request))
        slot = torch.clamp(delay - 1.0, min=0.0)
        lanes = torch.arange(COLD_START_HORIZON, dtype=torch.float32, device=warm.device)
        onehot = (lanes == slot[..., None]).to(torch.float32)
        pipeline = pipeline + onehot * (request - direct)[..., None]
        warm = warm + direct
    else:
        delay = cap.delay
        direct = request if delay == 0 else torch.zeros_like(request)
        warm = warm + direct
        pipeline[..., max(delay - 1, 0)] += request - direct
    return CapacityState(warm=warm, pipeline=pipeline, idle_s=idle_s), warm, pipeline.sum(-1)
