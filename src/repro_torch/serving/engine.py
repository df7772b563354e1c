"""Multi-agent serving engine: the paper's allocator as a scheduler over a
fleet of real models (port of ``repro/serving/engine.py``).

Every scheduler tick the engine

  1. observes per-agent arrivals and queue depths,
  2. runs the allocation policy (Algorithm 1 by default),
  3. grants agent i a compute budget of ``g_i * budget_tokens`` tokens
     (prefills are charged their prompt length),
  4. steps each agent's prefills and batched decode steps within its budget,
  5. records the same metrics as the paper's simulator,
  6. with a ``Workflow`` (``core/routing.py``): routes each finished request
     to its downstream runtimes — the generated tokens become the child's
     prompt, fractional routing weights accumulate as credit and spawn whole
     children deterministically, and the children arrive at the next tick,
     as the simulator's endogenous arrivals do,
  7. with a ``CapacityConfig`` (``core/capacity.py``): runs the warm-pool
     autoscaler before the policy — the tick's budget is ``warm(t) ·
     budget_tokens`` (``budget_tokens`` is per instance) and billing counts
     warm-instance-ticks,
  8. with a ``FailureSpec`` (``core/failures.py``): advances the same
     revocation and outage chains as the simulator (the revoked share of
     the pool neither serves nor bills; an agent that is down decodes
     nothing and keeps its queue) and retries or drops queued requests past
     their deadline.

The models run on the runtimes' device (``cuda`` unless the caller builds
them on the CPU); the allocator, the autoscaler and the failure chains are
O(N) float32 arithmetic on the host, as the scheduler is.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import allocator as alloc
from repro_torch.core import capacity as cap_mod
from repro_torch.core import failures as fail_mod
from repro_torch.core.agents import Fleet, T4_PRICE_PER_HOUR
from repro_torch.core.capacity import CapacityConfig, billing_cost
from repro_torch.core.failures import FailureSpec
from repro_torch.core.routing import Workflow, check_workflow
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
    parent_id: int = -1          # upstream request that spawned this one
    retries: int = 0             # deadline retries consumed so far


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
        workflow: Workflow | None = None,
        capacity: CapacityConfig | None = None,
        num_gpus: float = 1.0,
        price_per_hour: float = T4_PRICE_PER_HOUR,
        failures: FailureSpec | None = None,
        device="cuda",
    ):
        if set(fleet.names) != set(runtimes):
            raise ValueError(f"fleet agents {fleet.names} vs runtimes {sorted(runtimes)}")
        self.device = resolve_device(device)
        for name, rt in runtimes.items():
            if rt.device.type != self.device.type:
                raise ValueError(f"runtime {name!r} holds its model on {rt.device}, "
                                 f"the engine runs on {self.device}")
        alloc.get_policy(policy)  # fail fast on unregistered policies
        if workflow is not None:
            check_workflow(workflow, fleet.num_agents)
        if capacity is not None:
            cap_mod.check_capacity(capacity, g_total, num_gpus)
        else:
            cap_mod.check_budget_ceiling(g_total, num_gpus)
        failures = fail_mod.resolve_failures(failures)
        if failures is not None:
            if failures.batched:
                raise ValueError("FleetEngine takes a single FailureSpec")
            fail_mod.check_failures(failures)
        # The layers run on the host, with the scheduler.
        host = lambda layer: None if layer is None else layer.to("cpu")
        workflow, capacity, failures = host(workflow), host(capacity), host(failures)
        self.fleet = fleet
        self.runtimes = [runtimes[n] for n in fleet.names]
        self.policy = policy
        self.ema_alpha = ema_alpha
        self.budget_tokens = budget_tokens
        self.g_total = g_total
        self.workflow = workflow
        self.capacity = capacity
        self.num_gpus = num_gpus
        self.price_per_hour = price_per_hour
        self.failures = failures
        # Failure-chain state and counters: the simulator's chains, drawn
        # per tick (the draws are pure in the tick).
        self._rev_on = torch.zeros(())
        self._down = torch.zeros(fleet.num_agents)
        self.dropped = 0
        self.retried = 0
        self.slo_violations = 0
        self._deadline = (
            None if failures is None else
            np.broadcast_to(failures.deadline_s.numpy().astype(np.float64),
                            (fleet.num_agents,)).copy()
        )
        # Warm-pool state: the simulator's ``capacity_step``, run per tick on
        # the host.
        self._cap_state = cap_mod.init_capacity_state(g_total, device="cpu")
        self.tick = 0
        self._next_id = 0
        self._arrivals_this_tick = np.zeros(fleet.num_agents)
        self._ema = np.zeros(fleet.num_agents)
        self._ema_seeded = False
        # Fractional routing credit per (upstream, downstream) pair: whole
        # children spawn when a cell reaches 1.
        self._route_credit = np.zeros((fleet.num_agents, fleet.num_agents))
        self._route_weights = (
            None if workflow is None else
            workflow.route.numpy().astype(np.float64)
            * workflow.fan_out.numpy().astype(np.float64)[:, None]
        )
        self._source_flags = (
            None if workflow is None else workflow.source.numpy().astype(np.float64)
        )
        self.history: list[dict] = []
        self.completed: list[Request] = []

    # -- request intake ------------------------------------------------------

    def submit(self, agent: str, prompt: np.ndarray, max_new_tokens: int,
               parent_id: int = -1):
        idx = self.fleet.names.index(agent)
        # Outside traffic may only enter at sources; routed children
        # (parent_id >= 0) land wherever the matrix sends them.
        if (self.workflow is not None and parent_id < 0
                and self._source_flags[idx] == 0.0):
            raise ValueError(
                f"agent {agent!r} is not a source of workflow "
                f"{self.workflow.name!r}; exogenous requests may only enter "
                "at source agents"
            )
        # Children are submitted while tick T is served and become servable
        # (and counted in lam) at T+1.
        arrival = self.tick + 1 if parent_id >= 0 else self.tick
        req = Request(agent, np.asarray(prompt, np.int32), max_new_tokens, arrival,
                      id=self._next_id, parent_id=parent_id)
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

    def _capacity_tick(self, lam_tot: float, ema_tot: float,
                       queue_tot: float) -> tuple[float, float]:
        """One warm-pool autoscaler update in float32 on the host; returns
        (warm, pending)."""
        f32 = lambda x: torch.tensor(x, dtype=torch.float32)
        self._cap_state, warm, pending = cap_mod.capacity_step(
            self._cap_state, self.capacity, self.tick,
            f32(lam_tot), f32(ema_tot), f32(queue_tot), self.g_total, self.num_gpus,
        )
        return float(warm), float(pending)

    def _allocate(self, lam: np.ndarray, queues: np.ndarray, ema_t: torch.Tensor,
                  g_total: float) -> np.ndarray:
        lam_t = torch.as_tensor(np.asarray(lam, np.float32))
        q_t = torch.as_tensor(np.asarray(queues, np.float32))
        g = alloc.dispatch(self.policy, self.tick, lam_t, ema_t, q_t, self.fleet, g_total)
        return g.numpy()

    # -- failure injection ---------------------------------------------------

    def _failure_tick(self) -> tuple[float, np.ndarray]:
        """Advance the revocation and outage chains for this tick.

        Returns ``(phi, up)``: the fraction of warm capacity revoked and the
        per-agent availability gate.  Revoked instances also leave the warm
        pool, so an elastic autoscaler must bring them back through its cold
        start, as in the simulator.
        """
        if self.failures is None:
            return 0.0, np.ones(self.fleet.num_agents)
        u_rev, u_down = fail_mod.failure_uniforms(
            self.failures, self.tick, self.fleet.num_agents)
        phi, up, self._rev_on, self._down = fail_mod.advance_failures(
            self.failures, self.tick, self._rev_on, self._down, u_rev, u_down)
        phi = float(phi)
        if phi > 0.0 and self.capacity is not None:
            st = self._cap_state
            self._cap_state = cap_mod.CapacityState(
                st.warm * (1.0 - phi), st.pipeline, st.idle_s)
        return phi, up.numpy().astype(np.float64)

    def _enforce_deadlines(self):
        """Retry or drop queued requests whose sojourn exceeds the deadline.

        A request waiting longer than its agent's ``deadline_s`` (ticks)
        violates its SLO: with retry budget left it re-enters the back of
        the queue with a fresh arrival stamp, else it is dropped.  Admitted
        requests never expire, as only backlog does in the fluid model.
        """
        if self.failures is None:
            return
        budget = int(np.clip(float(self.failures.retry_budget), 0,
                             fail_mod.RETRY_CLASSES - 1))
        for i, rt in enumerate(self.runtimes):
            deadline = self._deadline[i]
            if deadline <= 0 or not rt.queue:
                continue
            survivors = deque()
            while rt.queue:
                req = rt.queue.popleft()
                if self.tick - req.arrival_tick <= deadline:
                    survivors.append(req)
                    continue
                self.slo_violations += 1
                if req.retries < budget:
                    req.retries += 1
                    req.arrival_tick = self.tick
                    survivors.append(req)
                    self.retried += 1
                else:
                    self.dropped += 1
            rt.queue = survivors

    # -- workflow routing ----------------------------------------------------

    def _route_finished(self, finished: list[Request]) -> int:
        """Fan finished requests out to downstream runtimes.

        Each finished request at agent i adds ``route[i] * fan_out[i]`` to
        the per-edge credit; every whole unit spawns one child (prompt = the
        parent's generated tokens) through ``submit``, arriving next tick.
        """
        if self.workflow is None or not finished:
            return 0
        spawned = 0
        for req in finished:
            i = self.fleet.names.index(req.agent)
            self._route_credit[i] += self._route_weights[i]
            for j in np.nonzero(self._route_credit[i] >= 1.0)[0]:
                k = int(self._route_credit[i, j])
                self._route_credit[i, j] -= k
                prompt = np.asarray(req.tokens_out, np.int32)
                if prompt.size == 0:
                    prompt = req.prompt
                # The parent's ids may lie beyond the child model's embedding
                # table (a larger vocabulary upstream); wrap them into it.
                rows = self.runtimes[j].params["embed"]["embedding"].shape[0]
                prompt = prompt % rows
                for _ in range(k):
                    self.submit(self.fleet.names[j], prompt,
                                req.max_new_tokens, parent_id=req.id)
                    spawned += 1
        return spawned

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
        if cfg.arch_type == "encdec":
            # The audio stub: 64 zero frames, as the reference engine feeds.
            # Its cache holds the cross K/V of 4096 frames, so the scatter
            # below raises, in the reference and here (ROADMAP C).
            batch["frontend_embeds"] = torch.zeros(
                (1, 64, cfg.d_model), dtype=torch.bfloat16, device=dev)
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
        self._enforce_deadlines()
        lam = self._arrivals_this_tick.copy()
        self._arrivals_this_tick[:] = 0.0
        queues = np.array(
            [len(rt.queue) + sum(r is not None for r in rt.active) for rt in self.runtimes],
            np.float32,
        )
        ema_t = self._forecast(lam)
        if self.capacity is not None:
            warm, pending = self._capacity_tick(
                float(lam.sum()), float(ema_t.numpy().sum()), float(queues.sum()))
        else:
            warm, pending = self.g_total, 0.0
        phi, up = self._failure_tick()
        # The revoked share of the pool grants no tokens this tick.
        warm_eff = warm * (1.0 - phi)
        g = self._allocate(lam, queues, ema_t, warm_eff)
        served = np.zeros(len(self.runtimes))
        done_before = len(self.completed)
        for i, rt in enumerate(self.runtimes):
            if up[i] < 0.5:
                # Agent outage: its queue and slots wait, nothing runs.
                continue
            # g sums to at most the warm pool, so the fleet-wide spend is
            # capped at warm · budget_tokens.
            budget = int(round(g[i] * self.budget_tokens))
            spent = self._admit(rt, budget)
            while spent < budget:
                made = self._decode_once(rt)
                if made == 0:
                    break
                spent += made
                served[i] += made
        # Requests that finished this tick flow downstream, arriving at tick+1.
        routed = self._route_finished(self.completed[done_before:])
        self.history.append(
            {"tick": self.tick, "allocation": g.tolist(), "arrivals": lam.tolist(),
             "queues": queues.tolist(), "decode_tokens": served.tolist(),
             "routed": routed, "warm": warm, "pending": pending,
             "revoked_frac": phi, "down": (up < 0.5).sum().item()}
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
        out = {
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
            # Failure accounting (zeros without failures).
            "dropped": self.dropped,
            "retried": self.retried,
            "slo_violations": self.slo_violations,
        }
        if self.workflow is not None:
            # End to end: a request finishing at a sink closes the chain that
            # began at its root submission.
            sink = self.workflow.sink.numpy()
            by_id = {r.id: r for r in self.completed}

            def root(req: Request) -> Request:
                while req.parent_id >= 0 and req.parent_id in by_id:
                    req = by_id[req.parent_id]
                return req

            done = [r for r in self.completed if sink[self.fleet.names.index(r.agent)] > 0]
            e2e = [r.finish_tick - root(r).arrival_tick for r in done]
            out["sink_completed"] = len(done)
            out["end_to_end_latency_ticks"] = float(np.mean(e2e)) if e2e else float("nan")
            out["routed_requests"] = sum(h.get("routed", 0) for h in self.history)
        return out


def _scatter_slot(caches, caches1, slot: int):
    """Write a batch-1 cache tree into slot ``slot`` of the batched cache, in place.

    Batch is axis 0 of every leaf (attention k/v, ssm and rglru conv window
    and state, enc-dec cross K/V); ``copy_`` casts to the batched leaf's
    dtype, as the reference's ``.astype(full.dtype)`` does, and broadcasts
    as its ``.at[slot].set`` does: the conv tail of a one-token ssm or
    rglru prompt (one row) fills every row of the cache's conv window.
    Shapes that do not broadcast raise ``ValueError``, as in the reference:
    the conv tail of a two-token prompt (two rows for three), and an enc-dec
    prompt's cross K/V of 64 frames against the cache's 4096 (ROADMAP C).
    """

    def upd(full, one):
        if (full.ndim != one.ndim or one.shape[0] != 1
                or any(o not in (1, f) for o, f in zip(one.shape[1:], full.shape[1:]))):
            raise ValueError((tuple(full.shape), tuple(one.shape)))
        full[slot].copy_(one[0])

    tree_map(upd, caches, caches1)
    return caches
