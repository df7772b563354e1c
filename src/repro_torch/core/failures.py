"""Failure injection: revocation, agent outages and request deadlines (port
of ``repro/core/failures.py``).

Three injectors, each gated by its own knobs (all-zero knobs disable it
exactly), which compose:

* **instance revocation** — a two-state Markov chain whose "on" state claws
  back ``revoke_frac`` of the warm capacity mid-step: the revoked share of
  in-service work drains back into the queues, and under an elastic
  capacity policy the revoked instances leave the warm pool;
* **agent failure/recovery** — per-agent outage chains, plus an optional
  scheduled outage window for one agent; queues are kept across an outage;
* **request deadlines** — backlog whose projected sojourn exceeds
  ``deadline_s`` expires; expired mass is retried (up to ``retry_budget``
  attempts) or dropped.

The draws are counter-based and bit for bit JAX's: step ``t`` uses
``uniform(fold_in(fold_in(key, t), slot))`` through ``core/prng.py``.  They
are pure in ``t``, so ``simulate`` draws a whole run's uniforms before its
step loop and the streaming sweep each block's, both on the device
(``failure_uniforms_t``, the numpy ``failure_uniforms``' bits).

``stack_failures`` stacks scenarios on a leading chaos axis (the failure
axis of ``core/sweep.py::sweep``).  The chain and deadline functions take
leaves that broadcast against the state's leading axes: a scalar knob as
(..., 1) over (..., N) agents (``advance_failures`` and ``deadline_step``
add that axis themselves), so one spec over one (N,) row runs the
single-row program bit for bit.

``REPRO_FAILURES=0`` disables failure injection at the entry points
(``simulate``, ``FleetEngine``, the sweeps), as in the reference.
"""
from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import prng

# Retry classes tracked per agent: class 0 is first-attempt mass, classes
# 1..RETRY_CLASSES-1 are mass on its k-th retry.
RETRY_CLASSES = 4

FAILURE_ENV = "REPRO_FAILURES"

# fold_in slots for the per-step uniforms (the reference's).
_SLOT_REVOKE = 0
_SLOT_DOWN = 1

_LEAVES = ("revoke_p_enter", "revoke_p_exit", "revoke_frac", "fail_p_enter",
           "fail_p_exit", "outage_start", "outage_len", "outage_agent",
           "deadline_s", "retry_budget")


@dataclasses.dataclass(frozen=True)
class FailureSpec:
    """A chaos scenario: float32 tensor knobs plus the raw PRNG key.

    * ``revoke_p_enter`` / ``revoke_p_exit`` — transition probabilities of
      the revocation chain (both zero: injector off); ``revoke_frac`` — the
      fraction of warm capacity yanked while the chain is on;
    * ``fail_p_enter`` / ``fail_p_exit`` — per-agent outage chains;
    * ``outage_start`` / ``outage_len`` / ``outage_agent`` — a scheduled
      outage window for one agent (len 0: off);
    * ``deadline_s`` — sojourn deadline in seconds, () or (N,) (≤ 0: off);
    * ``retry_budget`` — retries before expired mass is dropped;
    * ``key_data`` — (2,) uint32 raw key (``prng.key(seed)``).
    """

    name: str
    revoke_p_enter: torch.Tensor
    revoke_p_exit: torch.Tensor
    revoke_frac: torch.Tensor
    fail_p_enter: torch.Tensor
    fail_p_exit: torch.Tensor
    outage_start: torch.Tensor
    outage_len: torch.Tensor
    outage_agent: torch.Tensor
    deadline_s: torch.Tensor
    retry_budget: torch.Tensor
    key_data: np.ndarray

    @property
    def batched(self) -> bool:
        return self.revoke_frac.ndim > 0

    def to(self, device) -> "FailureSpec":
        return self.map(lambda x: x.to(device))

    def map(self, fn) -> "FailureSpec":
        """``fn`` applied to every tensor leaf."""
        return dataclasses.replace(self, **{f: fn(getattr(self, f)) for f in _LEAVES})


def failure_spec(
    name: str = "custom",
    *,
    revoke_p_enter: float = 0.0,
    revoke_p_exit: float = 1.0,
    revoke_frac: float = 0.0,
    fail_p_enter: float = 0.0,
    fail_p_exit: float = 1.0,
    outage_start: int = 0,
    outage_len: int = 0,
    outage_agent: int = 0,
    deadline_s: float | Sequence[float] = 0.0,
    retry_budget: int = 0,
    seed: int = 0,
) -> FailureSpec:
    """Build a validated :class:`FailureSpec` (all injectors default off)."""
    f32 = lambda x: torch.from_numpy(np.array(x, dtype=np.float32))
    spec = FailureSpec(
        name=name,
        revoke_p_enter=f32(revoke_p_enter),
        revoke_p_exit=f32(revoke_p_exit),
        revoke_frac=f32(revoke_frac),
        fail_p_enter=f32(fail_p_enter),
        fail_p_exit=f32(fail_p_exit),
        outage_start=f32(outage_start),
        outage_len=f32(outage_len),
        outage_agent=f32(outage_agent),
        deadline_s=f32(deadline_s),
        retry_budget=f32(retry_budget),
        key_data=prng.key(seed),
    )
    check_failures(spec)
    return spec


def check_failures(spec: FailureSpec) -> None:
    """Eager validation of the knobs."""
    arr = lambda x: x.cpu().numpy().astype(np.float64)
    for f in ("revoke_p_enter", "revoke_p_exit", "fail_p_enter", "fail_p_exit"):
        v = arr(getattr(spec, f))
        if ((v < 0) | (v > 1)).any():
            raise ValueError(f"failures.{f} must lie in [0, 1], got {v}")
    rf = arr(spec.revoke_frac)
    if ((rf < 0) | (rf > 1)).any():
        raise ValueError(f"failures.revoke_frac must lie in [0, 1], got {rf}")
    rb = arr(spec.retry_budget)
    if (rb < 0).any() or (rb > RETRY_CLASSES - 1).any():
        raise ValueError(
            f"failures.retry_budget must lie in [0, {RETRY_CLASSES - 1}] "
            f"(RETRY_CLASSES={RETRY_CLASSES}), got {rb}"
        )
    if (arr(spec.outage_len) < 0).any():
        raise ValueError("failures.outage_len must be >= 0")


def stack_failures(specs: Sequence[FailureSpec]) -> FailureSpec:
    """Stack scenarios on a leading chaos axis: leaves (B,), ``deadline_s``
    (B,) or (B, N), ``key_data`` (B, 2), ``name`` the tuple of names."""
    specs = list(specs)
    if not specs:
        raise ValueError("stack_failures needs at least one spec")
    names = [s.name for s in specs]
    if len(set(names)) != len(names):
        raise ValueError(f"failure scenario names must be unique, got {names}")
    dshape = torch.broadcast_shapes(*(tuple(s.deadline_s.shape) for s in specs))
    leaves = {}
    for f in _LEAVES:
        vals = [getattr(s, f).cpu() for s in specs]
        if f == "deadline_s":
            vals = [v.expand(dshape) for v in vals]
        leaves[f] = torch.stack(vals)
    return FailureSpec(name=tuple(names), key_data=np.stack([s.key_data for s in specs]),
                       **leaves)


def failure_names() -> tuple[str, ...]:
    """The injector families composed by this module (introspection)."""
    return ("revocation", "agent_outage", "deadline")


def failures_env_enabled() -> bool:
    return os.environ.get(FAILURE_ENV, "1") not in ("0", "false", "off")


def resolve_failures(failures: FailureSpec | None) -> FailureSpec | None:
    """Apply the ``REPRO_FAILURES`` kill switch at the entry points."""
    if failures is not None and not failures_env_enabled():
        return None
    return failures


def failure_scenario_library(seed: int = 0) -> tuple[FailureSpec, ...]:
    """The reference's canonical chaos scenarios."""
    return (
        failure_spec("none", seed=seed),
        failure_spec("revoke_mild", revoke_p_enter=0.05, revoke_p_exit=0.5,
                     revoke_frac=0.5, seed=seed),
        failure_spec("revoke_harsh", revoke_p_enter=0.2, revoke_p_exit=0.3,
                     revoke_frac=0.9, seed=seed),
        failure_spec("agent_flaky", fail_p_enter=0.05, fail_p_exit=0.4,
                     seed=seed),
        failure_spec("deadline_tight", deadline_s=2.0, retry_budget=1,
                     seed=seed),
        failure_spec("chaos", revoke_p_enter=0.1, revoke_p_exit=0.4,
                     revoke_frac=0.7, fail_p_enter=0.03, fail_p_exit=0.5,
                     deadline_s=3.0, retry_budget=2, seed=seed),
    )


# ---------------------------------------------------------------------------
# Per-step chain machinery (shared by the simulator and the engine)
# ---------------------------------------------------------------------------

class FailureState(NamedTuple):
    """Failure-chain state between steps.  The chains (``rev_on``,
    ``down``, ``fail_prev``) are shared by a streaming sweep's policy rows;
    the bookkeeping carries the rows' axes (``batch_shape``)."""
    rev_on: torch.Tensor      # ()    revocation chain on/off
    down: torch.Tensor        # (N,)  agent outage chains
    fail_prev: torch.Tensor   # ()    failure was active last step
    recovering: torch.Tensor  # (...,)  draining post-outage backlog
    q_mark: torch.Tensor      # (...,)  pre-outage backlog watermark
    retry_q: torch.Tensor     # (..., RETRY_CLASSES-1, N) retried mass


def init_failure_state(num_agents: int, device="cuda", batch_shape: tuple = (),
                       chain_shape: tuple = ()) -> FailureState:
    """Every chain off and nothing to retry, on ``device`` (``cuda`` unless
    the caller asks for the host)."""
    device = resolve_device(device)
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    return FailureState(rev_on=z(*chain_shape), down=z(*chain_shape, num_agents),
                        fail_prev=z(*chain_shape), recovering=z(*batch_shape),
                        q_mark=z(*batch_shape),
                        retry_q=z(*batch_shape, RETRY_CLASSES - 1, num_agents))


def failure_uniforms(spec: FailureSpec, t, num_agents: int):
    """The step-``t`` uniforms ``(u_rev (), u_down (N,))`` as float32 CPU
    tensors, bit for bit the reference's.  ``t`` may also be an array of
    steps: the results then gain its shape in front."""
    key_t = prng.fold_in(spec.key_data, np.asarray(t, np.uint32))
    u_rev = prng.uniform(prng.fold_in(key_t, _SLOT_REVOKE))
    u_down = prng.uniform(prng.fold_in(key_t, _SLOT_DOWN), (num_agents,))
    return torch.from_numpy(np.array(u_rev)), torch.from_numpy(u_down)


def failure_uniforms_t(key: torch.Tensor, t0: int, b: int, num_agents: int):
    """``failure_uniforms`` for steps t0 .. t0+b-1 on the device of the int64
    keys (..., 2) (``prng.key_t(spec.key_data)``): (u_rev (..., b),
    u_down (..., b, N)), the numpy function's bits."""
    ts = torch.arange(t0, t0 + b, dtype=torch.int64, device=key.device)
    key_t = prng.fold_in_t(key[..., None, :], ts)  # (..., b, 2)
    slot = lambda s: prng.fold_in_t(key_t, torch.full((), s, dtype=torch.int64,
                                                      device=key.device))
    return prng.uniform_t(slot(_SLOT_REVOKE)), prng.uniform_t(slot(_SLOT_DOWN), (num_agents,))


def advance_failures(spec: FailureSpec, t: int, rev_on, down, u_rev, u_down):
    """One step of the revocation and outage chains.

    Returns ``(phi, up, rev_nxt, down_nxt)``: the fraction of warm capacity
    revoked this step, the per-agent availability gate (1 = healthy), and
    the chain states to carry (``down_nxt`` is the stochastic chain only;
    the scheduled outage is recomputed from ``t``).  A chain in its state
    stays unless ``u >= p_exit``; out of it, it enters when ``u < p_enter``.
    """
    rev_nxt = torch.where(rev_on > 0.5, u_rev >= spec.revoke_p_exit,
                          u_rev < spec.revoke_p_enter).to(torch.float32)
    agent = lambda x: x[..., None]  # a per-scenario knob over the agents
    down_nxt = torch.where(down > 0.5, u_down >= agent(spec.fail_p_exit),
                           u_down < agent(spec.fail_p_enter)).to(torch.float32)
    phi = spec.revoke_frac * rev_nxt
    tf = float(t)
    sched = ((tf >= spec.outage_start)
             & (tf < spec.outage_start + spec.outage_len)).to(torch.float32)
    col = (torch.arange(down.shape[-1], dtype=torch.float32, device=down.device)
           == agent(spec.outage_agent)).to(torch.float32)
    down_eff = torch.clamp(down_nxt + agent(sched) * col, 0.0, 1.0)
    return phi, 1.0 - down_eff, rev_nxt, down_nxt


def deadline_step(spec: FailureSpec, queue, lam, served, q_post, cap_eff,
                  retry_q, eps: float = 1e-9):
    """Fluid deadline/retry accounting for one step.

    ``q_post = queue + lam - served`` is the surviving backlog and
    ``cap_eff`` the effective (revocation-scaled) service rate.  Backlog
    whose projected sojourn ``q_post / cap_eff`` exceeds ``deadline_s``
    expires proportionally across retry classes; expired mass in classes
    below ``retry_budget`` re-enters the queue one class up, the rest is
    dropped.

    Returns ``(new_q, new_retry_q, dropped, retried, expired)``, with
    ``new_q = q_post - dropped``.
    """
    enabled = (spec.deadline_s > 0).to(torch.float32)
    expired = enabled * torch.clamp(
        q_post - cap_eff * torch.clamp(spec.deadline_s, min=0.0), min=0.0)
    x = queue + lam
    f_surv = q_post / torch.clamp(x, min=eps)
    m0 = torch.clamp(x - retry_q.sum(-2), min=0.0)
    m = torch.cat([m0[..., None, :], retry_q], dim=-2)  # (..., C, N)
    m_post = m * f_surv[..., None, :]
    exp_frac = expired / torch.clamp(q_post, min=eps)
    e = m_post * exp_frac[..., None, :]          # expired mass per class
    k = torch.arange(RETRY_CLASSES, dtype=torch.float32, device=queue.device)
    budget = torch.clamp(spec.retry_budget, 0.0, RETRY_CLASSES - 1.0)
    retry_mask = (k < budget[..., None]).to(torch.float32)[..., None]   # (..., C, 1)
    ret = e * retry_mask                          # re-enters, one class up
    dro = e * (1.0 - retry_mask)                  # budget exhausted: drop
    promoted = torch.cat([torch.zeros_like(ret[..., :1, :]), ret[..., :-1, :]], dim=-2)
    new_m = (m_post - e) + promoted
    dropped = dro.sum(-2)
    return q_post - dropped, new_m[..., 1:, :], dropped, ret.sum(-2), expired
