"""Workload (arrival-process) generators (port of ``repro/core/workload.py``).

The paper simulates 100 one-second steps at fixed per-agent rates
(constant arrivals reproduce Table II); Poisson, spike, overload, dominated
and diurnal workloads support the §V-B robustness study, and ``bursty``
(per-agent on/off Markov-modulated bursts) and ``correlated`` (fleet-wide
surges of one shared chain) feed the sweep grids.

Two forms, as in the reference:

* the *materialized* generators (``constant``, ``poisson``, ``spike``, ...)
  return a whole (S, N) float32 tensor on the host.  Their draws come from
  one key per scenario (``split`` of the library's seed), exactly as the
  reference's do;
* a ``WorkloadSpec`` is the same process as an O(N) parameter row, and the
  **workload registry** holds one per-step generator per process:

      step(t, rates, knobs, state, key_t, aux) -> (lam (G, N), state (G, N))

  with ``key_t = fold_in(key, t)``, so step t's draw needs no (S, N) slab:
  the streaming simulator synthesizes each step's arrivals on the card
  inside its loop (``Synth``), and ``materialize`` runs the same step
  functions into the (S, N) tensor.  ``step_block`` synthesizes B steps in
  one call (stateless generators as one batched evaluation, the Markov
  chains from one batched draw of their uniforms), bit for bit B calls of
  ``workload_step``.

Exactness against the reference: the threefry draws are ``jax.random``'s
bits (``core/prng.py``), so constant, spike, scaled, dominated, bursty,
correlated and ``synthetic_rates`` equal the reference's arrays bit for
bit.  Three things are arranged for that: sums that set up a rate vector
run in the order of XLA's CPU reduction (``_xla_sum``); diurnal's
``sin(2πt/period)`` is the C library's ``sinf``, the function XLA's CPU
backend evaluates, taken from an (S,) table per diurnal row built on the
host (the card's ``sin`` differs in the last bit); and poisson is **not**
``jax.random.poisson``'s sampler (Knuth below λ = 10, rejection above, with
a data-dependent number of draws).  The port's poisson is an inverse-CDF
sampler over the same threefry uniforms: one uniform per agent and step,
mapped through a float64 Poisson(λ) CDF built on the host.  It is exact in
distribution up to the CDF's float64 rounding and a truncated tail of mass
below 1e-20, and identical for every block size and on every device; it
matches the reference in distribution only.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
import math
import os
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import prng

# The paper's aggregate arrival rate (Table II's workload), req/s.
PAPER_TOTAL_RATE = 190.0

# ``REPRO_SWEEP_SYNTH=0`` forces materialized arrivals everywhere, whatever
# the entry points were asked.
SYNTH_ENV = "REPRO_SWEEP_SYNTH"

# Fixed-width generator parameter row (per-generator meaning, unused slots 0).
KNOB_SLOTS = 4

# ``fold_in`` slot of a generator's initial-state draw; step t folds t.
_INIT_FOLD = 0x7FFFFFFF


def synth_env_enabled() -> bool:
    """False iff ``REPRO_SWEEP_SYNTH=0`` (or ``false``/``off``) is set."""
    return os.environ.get(SYNTH_ENV, "").lower() not in ("0", "false", "off")


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def _xla_sum(v) -> np.float32:
    """float32 sum of a vector in the order of XLA's CPU reduction: windows
    of 32 elements, each summed left to right, the vector zero-padded
    evenly on both sides to whole windows, recursively over the window
    sums; 32 elements or fewer left to right."""
    v = _f32(v).ravel()
    if v.size <= 32:
        return np.cumsum(v, dtype=np.float32)[-1] if v.size else np.float32(0.0)
    total = -(-v.size // 32) * 32
    lo = (total - v.size) // 2
    padded = np.concatenate([np.zeros(lo, np.float32), v,
                             np.zeros(total - v.size - lo, np.float32)])
    windows = np.cumsum(padded.reshape(-1, 32), axis=1, dtype=np.float32)[:, -1]
    return _xla_sum(windows)


@functools.lru_cache(maxsize=1)
def _sinf_fn():
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    lib.sinf.restype = ctypes.c_float
    lib.sinf.argtypes = [ctypes.c_float]
    return lib.sinf


@functools.lru_cache(maxsize=64)
def _diurnal_sin(period: float, num_steps: int) -> np.ndarray:
    """``sin(2π t / period)`` for t in [0, num_steps) in float32, the C
    library's ``sinf`` of the reference's float32 phase."""
    t = np.arange(num_steps, dtype=np.float32)
    phase = np.float32(2.0 * np.pi) * t / np.float32(period)
    sinf = _sinf_fn()
    return np.array([sinf(x) for x in phase.tolist()], np.float32)


def synthetic_rates(num_agents: int, seed: int = 0, total_rate: float = PAPER_TOTAL_RATE,
                    key=None) -> torch.Tensor:
    """A reproducible per-agent rate vector summing to ``total_rate``:
    proportions ``uniform(key(seed), (N,), 0.5, 1.5)`` normalized, the
    reference's draw bit for bit.  (N,) float32 on the host."""
    if num_agents < 1:
        raise ValueError(f"num_agents must be >= 1, got {num_agents}")
    key = prng.key(seed) if key is None else np.asarray(key, np.uint32)
    w = prng.uniform(key, (num_agents,), minval=0.5, maxval=1.5)
    return torch.from_numpy(np.float32(total_rate) * w / _xla_sum(w))


# ---------------------------------------------------------------------------
# Materialized generators: (S, N) float32 tensors on the host.
# ---------------------------------------------------------------------------

def constant(rates, num_steps: int) -> torch.Tensor:
    """lam_i(t) = rates_i for all t (reproduces the paper's Table II):
    (num_steps, N) float32 on the host."""
    rates = torch.from_numpy(_f32(rates).copy())
    return rates.expand(num_steps, rates.shape[0]).contiguous()


def _poisson_cdf(rates: np.ndarray) -> np.ndarray:
    """Poisson(λ) CDFs for a (..., N) rate array: (..., N, K) float64, with
    K past λ_max by 12 standard deviations and 24 (the tail beyond has
    mass below 1e-20).  A zero rate gives a CDF of ones (every draw 0)."""
    lam = np.asarray(rates, np.float64)
    lam_max = float(lam.max()) if lam.size else 0.0
    k_max = int(math.ceil(lam_max + 12.0 * math.sqrt(lam_max) + 24.0))
    k = np.arange(k_max, dtype=np.float64)
    log_fact = np.concatenate([[0.0], np.cumsum(np.log(np.arange(1, k_max, dtype=np.float64)))])
    with np.errstate(divide="ignore", invalid="ignore"):
        log_pmf = -lam[..., None] + k * np.log(lam)[..., None] - log_fact
    pmf = np.where(lam[..., None] > 0, np.exp(log_pmf), (k == 0).astype(np.float64))
    return np.cumsum(pmf, axis=-1)


def _poisson_draw(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The inverse CDF: ``#{k : cdf[k] <= u}`` for uniforms u (..., B, N)
    against CDFs (..., N, K); float32 counts (..., B, N)."""
    values = u.transpose(-1, -2).to(torch.float64).contiguous()
    k = torch.searchsorted(cdf, values, right=True)
    return k.transpose(-1, -2).to(torch.float32)


def poisson(rates, num_steps: int, key) -> torch.Tensor:
    """Poisson(lam_i) arrivals per step from one key: the uniforms
    ``uniform(key, (S, N))`` through the inverse CDF (the module docstring
    says how this differs from ``jax.random.poisson``)."""
    r = _f32(rates)
    u = torch.from_numpy(prng.uniform(np.asarray(key, np.uint32), (num_steps, r.shape[0])))
    return _poisson_draw(torch.from_numpy(_poisson_cdf(r)), u)


def spike(rates, num_steps: int, spike_agent: int, spike_start: int, spike_len: int,
          magnitude: float = 10.0) -> torch.Tensor:
    """A ``magnitude``× arrival-rate spike on one agent (§V-B adaptation)."""
    base = constant(rates, num_steps)
    t = torch.arange(num_steps)[:, None]
    in_spike = (t >= spike_start) & (t < spike_start + spike_len)
    col = torch.arange(base.shape[1])[None, :] == spike_agent
    return torch.where(in_spike & col, base * float(np.float32(magnitude)), base)


def scaled(rates, num_steps: int, factor: float) -> torch.Tensor:
    """Uniformly scaled demand, e.g. 3× overload (§V-B)."""
    return constant(_f32(rates) * np.float32(factor), num_steps)


def dominated_rates(rates, agent: int, share: float = 0.9) -> torch.Tensor:
    """The rate vector redistributed so one agent carries ``share`` of the
    total (the §V-B monopolization rates)."""
    r = _f32(rates)
    n = r.shape[0]
    if n < 2:
        raise ValueError(
            "dominated needs >= 2 agents: with a single agent there is "
            f"nobody to redistribute the remaining {1.0 - share:.2f} share to"
        )
    total = _xla_sum(r)
    out = np.full((n,), total * np.float32(1.0 - share) / np.float32(n - 1), np.float32)
    out[agent] = total * np.float32(share)
    return torch.from_numpy(out)


def dominated(rates, num_steps: int, agent: int, share: float = 0.9) -> torch.Tensor:
    """One agent carries ``share`` of total requests (§V-B)."""
    return constant(dominated_rates(rates, agent, share), num_steps)


def diurnal(rates, num_steps: int, period: int = 50, depth: float = 0.5) -> torch.Tensor:
    """Sinusoidal load swing ``1 + depth·sin(2πt/period)``."""
    s = _diurnal_sin(float(np.float32(period)), num_steps)
    mod = np.float32(1.0) + np.float32(depth) * s
    return torch.from_numpy(_f32(rates)[None, :] * mod[:, None])


def _chain(state0: np.ndarray, u: np.ndarray, p_enter: float, p_exit: float) -> np.ndarray:
    """The two-state chain over uniforms u (S, ...): a state stays on unless
    ``u >= p_exit``, and turns on when ``u < p_enter``; (S, ...) bool."""
    out = np.empty(u.shape, bool)
    state = state0
    for t in range(u.shape[0]):
        state = np.where(state, u[t] >= np.float32(p_exit), u[t] < np.float32(p_enter))
        out[t] = state
    return out


def bursty(rates, num_steps: int, key, on_factor: float = 4.0, off_factor: float = 0.25,
           p_enter: float = 0.08, p_exit: float = 0.25) -> torch.Tensor:
    """Markov-modulated on/off bursts, independent per agent: a lull enters
    a burst with probability ``p_enter`` per step, a burst ends with
    ``p_exit``; ``on_factor``·rate in a burst, ``off_factor``·rate in a
    lull.  The reference's draws: the initial states from the first half of
    ``split(key)``, the (S, N) uniforms from the second."""
    r = _f32(rates)
    key_init, key_steps = prng.split(np.asarray(key, np.uint32))
    state0 = prng.bernoulli(key_init, 0.5, r.shape)
    u = prng.uniform(key_steps, (num_steps, r.shape[0]))
    on = _chain(state0, u, p_enter, p_exit)
    factors = np.where(on, np.float32(on_factor), np.float32(off_factor))
    return torch.from_numpy(r[None, :] * factors)


def correlated(rates, num_steps: int, key, surge_factor: float = 4.0, p_enter: float = 0.05,
               p_exit: float = 0.2) -> torch.Tensor:
    """Fleet-wide surges: one shared on/off chain multiplies every agent's
    rate by ``surge_factor`` during a surge."""
    r = _f32(rates)
    u = prng.uniform(np.asarray(key, np.uint32), (num_steps,))
    on = _chain(np.asarray(False), u, p_enter, p_exit)
    factors = np.where(on, np.float32(surge_factor), np.float32(1.0))
    return torch.from_numpy(r[None, :] * factors[:, None])


# ---------------------------------------------------------------------------
# The workload registry: per-step generators for in-loop synthesis.
#
# Rows are batched: rates (G, N), knobs (G, KNOB_SLOTS), state (G, N), keys
# int64 (G, 2) per step or (G, B, 2) per block.  ``aux`` is what a
# generator precomputes once per run (``prepare``): poisson's CDF table,
# diurnal's sine table.
# ---------------------------------------------------------------------------

class _WorkloadGen(NamedTuple):
    step: Callable     # (t, rates, knobs, state, key_t, aux) -> (lam, state)
    init: Callable     # (rates, knobs, key_init, aux) -> state
    block: Callable    # (t0, b, rates, knobs, state, keys, aux) -> (rows (G, B, N), state)
    prepare: Callable  # (rates np (G, N), knobs np (G, K), horizon, device) -> aux


_WORKLOADS: dict[str, _WorkloadGen] = {}


def _zeros_init(rates, knobs, key, aux):
    return torch.zeros_like(rates)


def _no_aux(rates, knobs, horizon, device):
    return None


def _scan_block(step: Callable) -> Callable:
    """Block synthesis by B sequential step calls: the reference every
    specialized block must equal."""

    def block(t0, b, rates, knobs, state, keys, aux):
        rows = []
        for j in range(b):
            lam, state = step(t0 + j, rates, knobs, state, keys[:, j], aux)
            rows.append(lam)
        return torch.stack(rows, dim=1), state

    return block


def register_workload(name: str, init: Callable | None = None, block: Callable | None = None,
                      prepare: Callable | None = None):
    """Register a per-step arrival generator under ``name``; registration
    order defines ``workload_id``, as in the reference.  ``block`` defaults
    to B sequential step calls; ``init`` to a zero state."""

    def deco(fn: Callable) -> Callable:
        if name in _WORKLOADS:
            raise ValueError(f"workload generator {name!r} already registered")
        _WORKLOADS[name] = _WorkloadGen(
            fn, _zeros_init if init is None else init,
            _scan_block(fn) if block is None else block,
            _no_aux if prepare is None else prepare,
        )
        return fn

    return deco


def workload_names() -> tuple[str, ...]:
    """Registered generator names, in registration (= id) order."""
    return tuple(_WORKLOADS)


def workload_id(name: str) -> int:
    if name not in _WORKLOADS:
        raise ValueError(f"unknown workload generator {name!r}; registered: {workload_names()}")
    return list(_WORKLOADS).index(name)


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """An arrival process as an O(N) parameter row: the in-loop twin of an
    (S, N) arrival tensor.  Leaves may carry leading axes (a stacked
    scenario column, ``stack_specs``):

    * ``gen_id``   — int32 registry index (host), () or (...,);
    * ``rates``    — (..., N) float32 base rates;
    * ``knobs``    — (..., KNOB_SLOTS) float32 generator parameters;
    * ``key_data`` — (..., 2) uint32 raw PRNG key (host).
    """

    gen_id: np.ndarray
    rates: torch.Tensor
    knobs: torch.Tensor
    key_data: np.ndarray
    name: str = "workload"
    num_steps: int = 100

    @property
    def lead_shape(self) -> tuple:
        return tuple(self.gen_id.shape)


def make_spec(gen: str, rates, num_steps: int, key=None, knobs: Sequence[float] = (),
              name: str | None = None) -> WorkloadSpec:
    """Build a ``WorkloadSpec`` for a registered generator; ``key`` (raw key
    data) defaults to ``key(0)`` for the deterministic generators."""
    if len(knobs) > KNOB_SLOTS:
        raise ValueError(f"at most {KNOB_SLOTS} knobs, got {len(knobs)}")
    if not 0 < int(num_steps) < _INIT_FOLD:
        raise ValueError(f"num_steps must be in (0, 2**31-1), got {num_steps}")
    kv = np.zeros(KNOB_SLOTS, np.float32)
    kv[: len(knobs)] = np.asarray(knobs, np.float32)
    return WorkloadSpec(
        gen_id=np.asarray(workload_id(gen), np.int32),
        rates=torch.from_numpy(_f32(rates).copy()),
        knobs=torch.from_numpy(kv),
        key_data=prng.key(0) if key is None else np.asarray(key, np.uint32),
        name=gen if name is None else name,
        num_steps=int(num_steps),
    )


def stack_specs(specs: Sequence[WorkloadSpec], name: str = "stacked") -> WorkloadSpec:
    """Stack specs on a new leading axis (a sweep's scenario column);
    already-stacked specs stack again into the (F, W) fleet-sweep block."""
    specs = list(specs)
    if not specs:
        raise ValueError("stack_specs needs at least one spec")
    steps = {s.num_steps for s in specs}
    if len(steps) != 1:
        raise ValueError(f"specs must share one horizon, got {sorted(steps)}")
    return WorkloadSpec(
        gen_id=np.stack([s.gen_id for s in specs]),
        rates=torch.stack([s.rates for s in specs]),
        knobs=torch.stack([s.knobs for s in specs]),
        key_data=np.stack([s.key_data for s in specs]),
        name=name,
        num_steps=steps.pop(),
    )


def gen_groups(gen_id) -> tuple:
    """Rows of a flat generator-id array grouped by generator, in order of
    first appearance: ``((gen_name, (row, ...)), ...)``."""
    names = workload_names()
    groups: dict[int, list[int]] = {}
    for i, gid in enumerate(np.asarray(gen_id).reshape(-1).tolist()):
        groups.setdefault(int(gid), []).append(i)
    return tuple((names[gid], tuple(idx)) for gid, idx in groups.items())


class Synth:
    """A (stacked) spec prepared on ``device`` for synthesis in a step
    loop: its rows grouped by generator (each group one batched call, no
    per-row dispatch), keys, knobs and each generator's ``aux`` on the
    device before the loop.  A spec of one generator is one group, so it
    runs as the reference's static fast path; ``gen`` names that generator
    and is checked against the spec.  States are (..., N) tensors of the
    spec's leading shape."""

    def __init__(self, spec: WorkloadSpec, device="cuda", gen: str | None = None,
                 horizon: int | None = None):
        self.lead = spec.lead_shape
        self.n = spec.rates.shape[-1]
        self.device = resolve_device(device)
        self.num_steps = spec.num_steps
        horizon = spec.num_steps if horizon is None else int(horizon)
        gids = spec.gen_id.reshape(-1)
        rates = _f32(spec.rates).reshape(-1, self.n)
        knobs = _f32(spec.knobs).reshape(-1, KNOB_SLOTS)
        keys = np.asarray(spec.key_data, np.uint32).reshape(-1, 2)
        if gen is not None and (gids != workload_id(gen)).any():
            raise ValueError(f"gen={gen!r} but the spec holds other generators")
        self.rows = len(gids)
        self.groups = []
        for name, idx in gen_groups(gids):
            fn = _WORKLOADS[name]
            ix = np.asarray(idx)
            self.groups.append((
                name, fn, torch.as_tensor(ix, device=self.device),
                torch.from_numpy(rates[ix]).to(self.device),
                torch.from_numpy(knobs[ix]).to(self.device),
                prng.key_t(keys[ix], self.device),
                fn.prepare(rates[ix], knobs[ix], horizon, self.device),
            ))
        self.whole = len(self.groups) == 1  # one group, rows in order

    def _rows(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape((self.rows,) + x.shape[len(self.lead):])

    def _gather(self, parts, tail: tuple) -> torch.Tensor:
        if self.whole:
            return parts[0].reshape(self.lead + tail)
        out = torch.empty((self.rows,) + tail, dtype=torch.float32, device=self.device)
        for (_, _, idx, *_), p in zip(self.groups, parts):
            out.index_copy_(0, idx, p)
        return out.reshape(self.lead + tail)

    def _pick(self, state, idx):
        return state if self.whole else state.index_select(0, idx)

    def init(self) -> torch.Tensor:
        parts = []
        for _, fn, _, rates, knobs, keys, aux in self.groups:
            k0 = prng.fold_in_t(keys, torch.full((), _INIT_FOLD, dtype=torch.int64,
                                                 device=self.device))
            parts.append(fn.init(rates, knobs, k0, aux))
        return self._gather(parts, (self.n,))

    def step(self, state: torch.Tensor, t: int):
        """Step t's (..., N) arrivals and the next state."""
        state = self._rows(state)
        lams, states = [], []
        for _, fn, idx, rates, knobs, keys, aux in self.groups:
            kt = prng.fold_in_t(keys, torch.full((), t, dtype=torch.int64, device=self.device))
            lam, st = fn.step(t, rates, knobs, self._pick(state, idx), kt, aux)
            lams.append(lam)
            states.append(st)
        return self._gather(lams, (self.n,)), self._gather(states, (self.n,))

    def block(self, state: torch.Tensor, t0: int, b: int):
        """Steps t0 .. t0+b-1 in one call: (..., b, N) arrivals and the state
        after them, bit for bit ``b`` calls of ``step``."""
        state = self._rows(state)
        ts = torch.arange(t0, t0 + b, dtype=torch.int64, device=self.device)
        rows, states = [], []
        for _, fn, idx, rates, knobs, keys, aux in self.groups:
            kb = prng.fold_in_t(keys[:, None, :], ts)  # (G, b, 2)
            r, st = fn.block(t0, b, rates, knobs, self._pick(state, idx), kb, aux)
            rows.append(r)
            states.append(st)
        return self._gather(rows, (b, self.n)), self._gather(states, (self.n,))


def workload_init(spec: WorkloadSpec, gen: str | None = None, device="cuda") -> torch.Tensor:
    """The generator's t=0 state, drawn from ``fold_in(key, 2**31 - 1)``."""
    return Synth(spec, device, gen).init()


def workload_step(spec: WorkloadSpec, state: torch.Tensor, t: int, gen: str | None = None):
    """Step t's (..., N) arrival row and the next state: pure in t (the key
    is ``fold_in(key, t)``)."""
    return Synth(spec, state.device, gen, horizon=t + 1).step(state, t)


def step_block(spec: WorkloadSpec, state: torch.Tensor, t0: int, b: int,
               gen: str | None = None):
    """Steps t0 .. t0+b-1 in one call: ((..., b, N) rows, next state)."""
    return Synth(spec, state.device, gen, horizon=t0 + b).block(state, t0, b)


def materialize(spec: WorkloadSpec, num_steps: int | None = None) -> torch.Tensor:
    """The spec's (S, N) arrivals (or (..., S, N) for a stacked spec) on the
    host, by the same per-step generators the step loop runs."""
    steps = spec.num_steps if num_steps is None else int(num_steps)
    synth = Synth(spec, "cpu", horizon=steps)
    state, rows = synth.init(), []
    for t in range(steps):
        lam, state = synth.step(state, t)
        rows.append(lam)
    return torch.stack(rows, dim=-2)


# -- registered generators ---------------------------------------------------
#
# Per-generator ``knobs`` layout (unused slots zero):
#   constant    —
#   poisson     —
#   spike       (agent, start, length, magnitude)
#   diurnal     (period, depth)
#   bursty      (on_factor, off_factor, p_enter, p_exit)
#   correlated  (surge_factor, p_enter, p_exit)
#
# ``scaled``/``dominated`` scenarios are ``constant`` specs over transformed
# rate vectors.

def _knob(knobs, i):
    return knobs[..., i:i + 1]  # (G, 1): broadcasts over agents


def _constant_block(t0, b, rates, knobs, state, keys, aux):
    return rates[:, None, :].expand(rates.shape[0], b, rates.shape[1]), state


@register_workload("constant", block=_constant_block)
def _constant_step(t, rates, knobs, state, key_t, aux):
    return rates, state


def _poisson_prepare(rates, knobs, horizon, device):
    return torch.from_numpy(_poisson_cdf(rates)).to(device)


def _poisson_block(t0, b, rates, knobs, state, keys, aux):
    u = prng.uniform_t(keys, (rates.shape[-1],))  # (G, b, N)
    return _poisson_draw(aux, u), state


@register_workload("poisson", block=_poisson_block, prepare=_poisson_prepare)
def _poisson_step(t, rates, knobs, state, key_t, aux):
    u = prng.uniform_t(key_t, (rates.shape[-1],))  # (G, N)
    return _poisson_draw(aux, u[:, None, :])[:, 0], state


def _in_spike(tf, knobs, n, device):
    start, length = _knob(knobs, 1), _knob(knobs, 2)
    col = torch.arange(n, dtype=torch.float32, device=device) == _knob(knobs, 0)
    return (tf >= start) & (tf < start + length) & col


def _spike_block(t0, b, rates, knobs, state, keys, aux):
    tf = torch.arange(t0, t0 + b, dtype=torch.float32, device=rates.device)
    hit = _in_spike(tf[None, :, None], knobs[:, None, :], rates.shape[-1], rates.device)
    r = rates[:, None, :]
    return torch.where(hit, r * _knob(knobs, 3)[:, None, :], r.expand_as(hit)), state


@register_workload("spike", block=_spike_block)
def _spike_step(t, rates, knobs, state, key_t, aux):
    hit = _in_spike(float(t), knobs, rates.shape[-1], rates.device)
    return torch.where(hit, rates * _knob(knobs, 3), rates), state


def _diurnal_prepare(rates, knobs, horizon, device):
    tab = np.stack([_diurnal_sin(float(p), horizon) for p in knobs[:, 0]])
    return torch.from_numpy(tab).to(device)  # (G, horizon)


def _diurnal_block(t0, b, rates, knobs, state, keys, aux):
    mod = 1.0 + _knob(knobs, 1) * aux[:, t0:t0 + b]  # (G, b)
    return rates[:, None, :] * mod[:, :, None], state


@register_workload("diurnal", block=_diurnal_block, prepare=_diurnal_prepare)
def _diurnal_step(t, rates, knobs, state, key_t, aux):
    mod = 1.0 + _knob(knobs, 1) * aux[:, t:t + 1]
    return rates * mod, state


def _bursty_init(rates, knobs, key, aux):
    return prng.bernoulli_t(key, 0.5, (rates.shape[-1],)).to(torch.float32)


def _bursty_advance(rates, knobs, state, u):
    # The one recurrence: step and block both run it.
    on, off, p_enter, p_exit = (_knob(knobs, i) for i in range(4))
    nxt = torch.where(state > 0.5, u >= p_exit, u < p_enter)
    return rates * torch.where(nxt, on, off), nxt.to(torch.float32)


def _bursty_block(t0, b, rates, knobs, state, keys, aux):
    u = prng.uniform_t(keys, (rates.shape[-1],))  # (G, b, N) in one draw
    rows = []
    for j in range(b):
        lam, state = _bursty_advance(rates, knobs, state, u[:, j])
        rows.append(lam)
    return torch.stack(rows, dim=1), state


@register_workload("bursty", init=_bursty_init, block=_bursty_block)
def _bursty_step(t, rates, knobs, state, key_t, aux):
    return _bursty_advance(rates, knobs, state, prng.uniform_t(key_t, (rates.shape[-1],)))


def _correlated_advance(rates, knobs, state, u):
    surge, p_enter, p_exit = (_knob(knobs, i) for i in range(3))
    nxt = torch.where(state[:, :1] > 0.5, u >= p_exit, u < p_enter)  # (G, 1)
    lam = rates * torch.where(nxt, surge, torch.ones_like(surge))
    return lam, nxt.to(torch.float32).expand_as(rates)


def _correlated_block(t0, b, rates, knobs, state, keys, aux):
    u = prng.uniform_t(keys)  # (G, b)
    rows = []
    for j in range(b):
        lam, state = _correlated_advance(rates, knobs, state, u[:, j:j + 1])
        rows.append(lam)
    return torch.stack(rows, dim=1), state


@register_workload("correlated", block=_correlated_block)
def _correlated_step(t, rates, knobs, state, key_t, aux):
    return _correlated_advance(rates, knobs, state, prng.uniform_t(key_t)[:, None])


# -- spec constructors (one per scenario type) -------------------------------

def constant_spec(rates, num_steps: int, name: str = "constant") -> WorkloadSpec:
    return make_spec("constant", rates, num_steps, name=name)


def poisson_spec(rates, num_steps: int, key) -> WorkloadSpec:
    return make_spec("poisson", rates, num_steps, key=key)


def spike_spec(rates, num_steps: int, spike_agent: int, spike_start: int, spike_len: int,
               magnitude: float = 10.0) -> WorkloadSpec:
    return make_spec("spike", rates, num_steps,
                     knobs=(float(spike_agent), float(spike_start), float(spike_len), magnitude))


def scaled_spec(rates, num_steps: int, factor: float, name: str = "scaled") -> WorkloadSpec:
    return make_spec("constant", _f32(rates) * np.float32(factor), num_steps, name=name)


def dominated_spec(rates, num_steps: int, agent: int, share: float = 0.9) -> WorkloadSpec:
    return make_spec("constant", dominated_rates(rates, agent, share), num_steps,
                     name="dominated")


def diurnal_spec(rates, num_steps: int, period: int = 50, depth: float = 0.5) -> WorkloadSpec:
    return make_spec("diurnal", rates, num_steps, knobs=(float(period), depth))


def bursty_spec(rates, num_steps: int, key, on_factor: float = 4.0, off_factor: float = 0.25,
                p_enter: float = 0.08, p_exit: float = 0.25) -> WorkloadSpec:
    return make_spec("bursty", rates, num_steps, key=key,
                     knobs=(on_factor, off_factor, p_enter, p_exit))


def correlated_spec(rates, num_steps: int, key, surge_factor: float = 4.0,
                    p_enter: float = 0.05, p_exit: float = 0.2) -> WorkloadSpec:
    return make_spec("correlated", rates, num_steps, key=key,
                     knobs=(surge_factor, p_enter, p_exit))


def scenario_specs(rates, num_steps: int = 100, seed: int = 0) -> tuple[WorkloadSpec, ...]:
    """The standard 8-scenario library as O(N) specs: the in-loop twin of
    ``sweep.scenario_library`` (same names and processes; the stochastic
    draws are per-step ``fold_in`` counters, so their values differ from
    the library's tensors)."""
    rates = _f32(rates)
    n = int(rates.shape[0])
    k_poisson, k_bursty, k_corr = prng.split(prng.key(seed), 3)
    return (
        constant_spec(rates, num_steps),
        poisson_spec(rates, num_steps, k_poisson),
        spike_spec(rates, num_steps, spike_agent=n - 1, spike_start=num_steps // 2,
                   spike_len=max(num_steps // 10, 1)),
        scaled_spec(rates, num_steps, 3.0, name="overload_3x"),
        dominated_spec(rates, num_steps, agent=0, share=0.9),
        diurnal_spec(rates, num_steps),
        bursty_spec(rates, num_steps, k_bursty),
        correlated_spec(rates, num_steps, k_corr),
    )


def fleet_scenario_specs(rate_vectors: Sequence, n_max: int, num_steps: int = 100,
                         seed: int = 0):
    """Per-fleet spec columns at a common padded width: rate transforms at
    each fleet's true width, then the rates zero-padded to ``n_max`` (every
    generator gives a zero-rate agent zero arrivals).  Returns
    ``(scenario_names, specs[fleet][scenario])``."""
    names, rows = None, []
    for rates in rate_vectors:
        r = _f32(rates)
        true_n = int(r.shape[-1])
        if true_n > n_max:
            raise ValueError(f"rate vector wider ({true_n}) than n_max={n_max}")
        padded = np.pad(r, (0, n_max - true_n))
        k_poisson, k_bursty, k_corr = prng.split(prng.key(seed), 3)
        dom = np.zeros(n_max, np.float32)
        dom[:true_n] = dominated_rates(r, agent=0, share=0.9).numpy()
        lib = (
            constant_spec(padded, num_steps),
            poisson_spec(padded, num_steps, k_poisson),
            spike_spec(padded, num_steps, spike_agent=true_n - 1, spike_start=num_steps // 2,
                       spike_len=max(num_steps // 10, 1)),
            scaled_spec(padded, num_steps, 3.0, name="overload_3x"),
            make_spec("constant", dom, num_steps, name="dominated"),
            diurnal_spec(padded, num_steps),
            bursty_spec(padded, num_steps, k_bursty),
            correlated_spec(padded, num_steps, k_corr),
        )
        lib_names = tuple(s.name for s in lib)
        if names is None:
            names = lib_names
        elif names != lib_names:
            raise ValueError("scenario spec libraries diverged across fleets")
        rows.append(lib)
    return names, tuple(rows)
