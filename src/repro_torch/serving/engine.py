"""Multi-agent serving engine: the paper's allocator as a scheduler over a
fleet of real models (port of ``repro/serving/engine.py``).

Every scheduler tick the engine

  1. observes per-agent arrivals and queue depths,
  2. runs the allocation policy (Algorithm 1 by default),
  3. grants agent i a compute budget of ``g_i * budget_tokens`` tokens
     (prefills are charged their prompt length),
  4. steps each agent's prefills and batched decode steps within its budget,
  5. records the same metrics as the paper's simulator.

The models run on the runtimes' device (``cuda`` unless the caller builds
them on the CPU); the allocator's O(N) arithmetic runs on the host, as the
scheduler's.  Workflow routing, the serverless warm pool and failure
injection (``workflow=``, ``capacity=``, ``failures=``) are not ported yet.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import allocator as alloc
from repro_torch.core.agents import Fleet, T4_PRICE_PER_HOUR
from repro_torch.core.capacity import billing_cost, check_budget_ceiling
from repro_torch.models.model import ModelApi
from repro_torch.models.params import init_params, tree_map


@dataclasses.dataclass
class Request:
    agent: str
    prompt: np.ndarray           # (prompt_len,) int32
    max_new_tokens: int
    arrival_tick: int
    id: int = -1
    tokens_out: list = dataclasses.field(default_factory=list)
    finish_tick: int = -1


@dataclasses.dataclass
class AgentRuntime:
    """One model + its queue + fixed decode batch slots.

    ``params`` live on the device the model runs on; the caches are made
    there too, at the first prefill.
    """

    name: str
    api: ModelApi
    params: object
    max_len: int
    batch_slots: int
    queue: deque = dataclasses.field(default_factory=deque)
    active: list = dataclasses.field(default_factory=list)  # per-slot Request|None
    caches: object = None
    pos: np.ndarray | None = None            # per-slot next position

    def __post_init__(self):
        self.active = [None] * self.batch_slots
        self.pos = np.zeros(self.batch_slots, np.int64)

    @property
    def device(self) -> torch.device:
        return self.params["embed"]["embedding"].device

    def free_slots(self):
        return [i for i, r in enumerate(self.active) if r is None]


class FleetEngine:
    def __init__(
        self,
        fleet: Fleet,
        runtimes: dict[str, AgentRuntime],
        policy: str = "adaptive",
        budget_tokens: int = 64,
        g_total: float = 1.0,
        ema_alpha: float = 0.3,
        workflow=None,
        capacity=None,
        num_gpus: float = 1.0,
        price_per_hour: float = T4_PRICE_PER_HOUR,
        failures=None,
        device="cuda",
    ):
        for arg, value in (("workflow", workflow), ("capacity", capacity),
                           ("failures", failures)):
            if value is not None:
                raise NotImplementedError(
                    f"FleetEngine({arg}=...) is not ported yet; see ROADMAP A2 "
                    "(capacity, routing and failures in the engine)"
                )
        if set(fleet.names) != set(runtimes):
            raise ValueError(f"fleet agents {fleet.names} vs runtimes {sorted(runtimes)}")
        self.device = resolve_device(device)
        for name, rt in runtimes.items():
            if rt.device.type != self.device.type:
                raise ValueError(f"runtime {name!r} holds its model on {rt.device}, "
                                 f"the engine runs on {self.device}")
        alloc.get_policy(policy)  # fail fast on unregistered policies
        check_budget_ceiling(g_total, num_gpus)
        self.fleet = fleet
        self.runtimes = [runtimes[n] for n in fleet.names]
        self.policy = policy
        self.ema_alpha = ema_alpha
        self.budget_tokens = budget_tokens
        self.g_total = g_total
        self.num_gpus = num_gpus
        self.price_per_hour = price_per_hour
        self.tick = 0
        self._next_id = 0
        self._arrivals_this_tick = np.zeros(fleet.num_agents)
        self._ema = np.zeros(fleet.num_agents)
        self._ema_seeded = False
        self.history: list[dict] = []
        self.completed: list[Request] = []

    # -- request intake ------------------------------------------------------

    def submit(self, agent: str, prompt: np.ndarray, max_new_tokens: int):
        idx = self.fleet.names.index(agent)
        req = Request(agent, np.asarray(prompt, np.int32), max_new_tokens, self.tick,
                      id=self._next_id)
        self._next_id += 1
        self.runtimes[idx].queue.append(req)
        self._arrivals_this_tick[idx] += 1
        return req

    # -- allocation ----------------------------------------------------------

    def _forecast(self, lam: np.ndarray) -> torch.Tensor:
        """Seed the EMA with the first observation, update it thereafter."""
        lam_t = torch.as_tensor(np.asarray(lam, np.float32))
        if not self._ema_seeded:
            ema_t = lam_t
            self._ema_seeded = True
        else:
            ema_t = alloc.ema_forecast(
                torch.as_tensor(np.asarray(self._ema, np.float32)), lam_t, self.ema_alpha
            )
        self._ema = ema_t.numpy()
        return ema_t

    def _allocate(self, lam: np.ndarray, queues: np.ndarray, ema_t: torch.Tensor,
                  g_total: float) -> np.ndarray:
        lam_t = torch.as_tensor(np.asarray(lam, np.float32))
        q_t = torch.as_tensor(np.asarray(queues, np.float32))
        g = alloc.dispatch(self.policy, self.tick, lam_t, ema_t, q_t, self.fleet, g_total)
        return g.numpy()

    # -- model stepping ------------------------------------------------------

    def _admit(self, rt: AgentRuntime, budget: int) -> int:
        """Prefill queued requests into free slots; returns tokens spent."""
        spent = 0
        while rt.queue and rt.free_slots():
            req = rt.queue[0]
            cost = len(req.prompt)
            if spent + cost > budget:
                break
            rt.queue.popleft()
            self._prefill_into_slot(rt, rt.free_slots()[0], req)
            spent += cost
        return spent

    def _prefill_into_slot(self, rt: AgentRuntime, slot: int, req: Request):
        cfg = rt.api.cfg
        dev = rt.device
        s = len(req.prompt)
        batch = {"tokens": torch.as_tensor(req.prompt, dtype=torch.int64, device=dev)[None]}
        if cfg.frontend == "vision":
            # The vision stub: zero patch embeddings over the first
            # min(frontend_tokens, s) positions, as the reference engine does.
            fe = min(cfg.frontend_tokens, s)
            batch["frontend_embeds"] = torch.zeros(
                (1, fe, cfg.d_model), dtype=torch.bfloat16, device=dev)
        logits, caches1 = rt.api.prefill(rt.params, batch, rt.max_len)
        req.tokens_out.append(int(torch.argmax(logits[0])))
        if rt.caches is None:
            rt.caches = self._empty_caches(rt)
        _scatter_slot(rt.caches, caches1, slot)
        rt.active[slot] = req
        rt.pos[slot] = s

    def _empty_caches(self, rt: AgentRuntime):
        decls = rt.api.cache_decls(rt.batch_slots, rt.max_len)
        return init_params(decls, 0, dtype=torch.bfloat16, device=rt.device)

    def _decode_once(self, rt: AgentRuntime) -> int:
        """One batched decode step over occupied slots; returns tokens made.

        As in the reference, every slot decodes at ONE position, the largest
        of the occupied slots' positions.
        """
        occupied = [i for i, r in enumerate(rt.active) if r is not None]
        if not occupied:
            return 0
        tokens = np.zeros(rt.batch_slots, np.int64)
        for i in occupied:
            tokens[i] = rt.active[i].tokens_out[-1]
        pos = int(max(rt.pos[i] for i in occupied))
        logits, rt.caches = rt.api.decode_step(
            rt.params, rt.caches, torch.as_tensor(tokens, device=rt.device), pos, rt.max_len
        )
        lg = logits.float().cpu().numpy()
        made = 0
        for i in occupied:
            req = rt.active[i]
            req.tokens_out.append(int(lg[i].argmax()))
            rt.pos[i] += 1
            made += 1
            if len(req.tokens_out) >= req.max_new_tokens or rt.pos[i] >= rt.max_len - 1:
                req.finish_tick = self.tick
                self.completed.append(req)
                rt.active[i] = None
        return made

    # -- main loop -----------------------------------------------------------

    @torch.no_grad()
    def step(self):
        lam = self._arrivals_this_tick.copy()
        self._arrivals_this_tick[:] = 0.0
        queues = np.array(
            [len(rt.queue) + sum(r is not None for r in rt.active) for rt in self.runtimes],
            np.float32,
        )
        ema_t = self._forecast(lam)
        warm, pending = self.g_total, 0.0
        g = self._allocate(lam, queues, ema_t, warm)
        served = np.zeros(len(self.runtimes))
        for i, rt in enumerate(self.runtimes):
            budget = int(round(g[i] * self.budget_tokens))
            spent = self._admit(rt, budget)
            while spent < budget:
                made = self._decode_once(rt)
                if made == 0:
                    break
                spent += made
                served[i] += made
        self.history.append(
            {"tick": self.tick, "allocation": g.tolist(), "arrivals": lam.tolist(),
             "queues": queues.tolist(), "decode_tokens": served.tolist(),
             "routed": 0, "warm": warm, "pending": pending,
             "revoked_frac": 0.0, "down": 0}
        )
        self.tick += 1

    # -- metrics (same definitions as the paper simulator) --------------------

    def metrics(self) -> dict:
        lat = [r.finish_tick - r.arrival_tick for r in self.completed]
        per_agent = {}
        for n in self.fleet.names:
            ls = [r.finish_tick - r.arrival_tick for r in self.completed if r.agent == n]
            per_agent[n] = float(np.mean(ls)) if ls else float("nan")
        toks = sum(len(r.tokens_out) for r in self.completed)
        warm_ticks = sum(h["warm"] for h in self.history)
        return {
            "completed": len(self.completed),
            "avg_latency_ticks": float(np.mean(lat)) if lat else float("nan"),
            "per_agent_latency": per_agent,
            "tokens_generated": toks,
            "throughput_tokens_per_tick": toks / max(self.tick, 1),
            "mean_allocation": np.mean(
                [h["allocation"] for h in self.history], axis=0
            ).tolist() if self.history else [],
            # Billing: one tick = one second of warm capacity.
            "warm_instance_ticks": float(warm_ticks),
            "mean_warm_instances": (
                float(warm_ticks / len(self.history)) if self.history else 0.0
            ),
            "cost_usd": float(billing_cost(warm_ticks, self.price_per_hour)),
            # Failure accounting: zeros until failure injection is ported.
            "dropped": 0,
            "retried": 0,
            "slo_violations": 0,
        }


def _scatter_slot(caches, caches1, slot: int):
    """Write a batch-1 cache tree into slot ``slot`` of the batched cache, in place.

    Batch is axis 0 of every leaf (attention k/v, ssm conv window and
    state); ``copy_`` casts to the batched leaf's dtype, as the reference's
    ``.astype(full.dtype)`` does.  Shapes that differ past axis 0 raise
    ``ValueError``, as in the reference: among them the conv tail of an ssm
    prompt shorter than ``ssm_conv_width - 1`` tokens.
    """

    def upd(full, one):
        if full.ndim != one.ndim or one.shape[0] != 1 or full.shape[1:] != one.shape[1:]:
            raise ValueError((tuple(full.shape), tuple(one.shape)))
        full[slot].copy_(one[0])

    tree_map(upd, caches, caches1)
    return caches
