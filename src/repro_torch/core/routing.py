"""Workflow-DAG routing: inter-agent request flow (port of
``repro/core/routing.py``).

* ``route`` is an (N, N) row-substochastic forwarding matrix:
  ``route[i, j]`` is the fraction of requests served at agent i that are
  forwarded to agent j's queue on the next step.  The row deficit
  ``1 - route[i].sum()`` exits the workflow at i (a completed end-to-end
  request).
* ``source`` ∈ {0,1}^N marks where exogenous arrivals enter; ``sink``
  ∈ {0,1}^N marks terminal agents (route row identically zero).
* ``fan_out`` (N,) multiplies forwarded copies: ``arrivals_endogenous =
  (served * fan_out) @ route``.

Generators: ``independent`` (no routing), ``coordinator_star``,
``pipeline_chain``, ``hierarchical`` and ``synthetic_workflow(n, seed)``,
which draws from ``np.random.default_rng(seed)`` exactly as the reference,
so its arrays equal the reference's bit for bit.  ``stack_workflows`` pads
topologies to one width and stacks them on a leading workflow axis ((K, N,
N) route, (K, N) flags): the workflow axis of
``core/sweep.py::sweep_workflows``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class Workflow:
    """Inter-agent request-routing topology over N agent slots (float32)."""

    name: str
    route: torch.Tensor    # (N, N) row-substochastic forwarding matrix
    source: torch.Tensor   # (N,) 1.0 where exogenous arrivals enter
    sink: torch.Tensor     # (N,) 1.0 where requests terminate (row == 0)
    fan_out: torch.Tensor  # (N,) forwarded-copy multiplier, 1.0 = conserving

    @property
    def num_agents(self) -> int:
        return self.route.shape[-1]

    @property
    def exit_fraction(self) -> torch.Tensor:
        """Per-agent fraction of served requests that exit the workflow."""
        return torch.clamp(1.0 - self.route.sum(dim=-1), min=0.0)

    def to(self, device) -> "Workflow":
        return dataclasses.replace(
            self, route=self.route.to(device), source=self.source.to(device),
            sink=self.sink.to(device), fan_out=self.fan_out.to(device))

    def validate(self) -> None:
        """Static sanity constraints, checked eagerly."""
        route = self.route.cpu().numpy()
        src = self.source.cpu().numpy()
        snk = self.sink.cpu().numpy()
        fo = self.fan_out.cpu().numpy()
        n = route.shape[-1]
        if route.shape[-2:] != (n, n):
            raise ValueError(f"route must be square, got {route.shape}")
        for name, flags in (("source", src), ("sink", snk)):
            if flags.shape[-1] != n:
                raise ValueError(f"{name} width {flags.shape[-1]} != {n}")
            if not np.isin(flags, (0.0, 1.0)).all():
                raise ValueError(f"{name} flags must be 0/1: {flags}")
        if (route < -_EPS).any():
            raise ValueError(f"route must be nonnegative: {route}")
        rows = route.sum(axis=-1)
        if (rows > 1.0 + _EPS).any():
            raise ValueError(
                f"route rows must sum to <= 1 (row deficit exits): {rows}"
            )
        if (np.abs(rows * snk) > _EPS).any():
            raise ValueError("sink agents must have an all-zero route row")
        if (fo < 0).any():
            raise ValueError(f"fan_out must be nonnegative: {fo}")
        if src.sum(axis=-1).min() < 1.0:
            raise ValueError("workflow needs at least one source agent")
        # Critical-path metrics and the engine's request routing assume a DAG.
        for adj in route.reshape(-1, n, n):
            if _has_cycle(adj > _EPS):
                raise ValueError("route must be acyclic (a workflow DAG)")


def check_workflow(workflow: Workflow, num_agents: int) -> None:
    """The workflow/fleet contract shared by ``simulate()`` and
    ``FleetEngine``: a single topology that validates and spans exactly the
    fleet's slot count (``pad_workflow`` a narrower one explicitly)."""
    if workflow.route.ndim != 2:
        raise ValueError(
            f"workflow {workflow.name!r} is batched (route shape "
            f"{tuple(workflow.route.shape)}); unbatched entry points take a "
            "single topology"
        )
    workflow.validate()
    if workflow.num_agents != num_agents:
        raise ValueError(
            f"workflow {workflow.name!r} has {workflow.num_agents} agents "
            f"but the fleet has {num_agents}; pad_workflow it explicitly"
        )


def _has_cycle(adj: np.ndarray) -> bool:
    """Kahn's topological sort on a boolean adjacency matrix, O(N + E)."""
    indeg = adj.sum(axis=0)
    ready = [i for i in range(adj.shape[0]) if indeg[i] == 0]
    seen = 0
    while ready:
        i = ready.pop()
        seen += 1
        for j in np.nonzero(adj[i])[0]:
            indeg[j] -= 1
            if indeg[j] == 0:
                ready.append(j)
    return seen < adj.shape[0]


def _t32(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _workflow(name, route, source, sink, fan_out=None):
    n = route.shape[0]
    return Workflow(
        name=name, route=_t32(route), source=_t32(source), sink=_t32(sink),
        fan_out=_t32(np.ones(n) if fan_out is None else fan_out),
    )


def independent(n: int) -> Workflow:
    """No routing: every agent is a source and a sink.  Simulating with it
    equals simulating without a workflow, bit for bit."""
    if n < 1:
        raise ValueError(f"workflow size must be >= 1, got {n}")
    return _workflow("independent", np.zeros((n, n)), np.ones(n), np.ones(n))


def coordinator_star(n: int, fan_out: float = 1.0) -> Workflow:
    """Agent 0 is the coordinator (the only source); every served
    coordinator request fans out uniformly to the n-1 specialist sinks."""
    if n < 2:
        raise ValueError(f"coordinator_star needs >= 2 agents, got {n}")
    route = np.zeros((n, n), np.float32)
    route[0, 1:] = 1.0 / (n - 1)
    source = np.zeros(n, np.float32)
    source[0] = 1.0
    sink = np.ones(n, np.float32)
    sink[0] = 0.0
    fo = np.ones(n, np.float32)
    fo[0] = fan_out
    return _workflow("coordinator_star", route, source, sink, fo)


def pipeline_chain(n: int) -> Workflow:
    """Sequential stages: agent 0 (source) → 1 → … → n-1 (sink)."""
    if n < 1:
        raise ValueError(f"workflow size must be >= 1, got {n}")
    route = np.zeros((n, n), np.float32)
    for i in range(n - 1):
        route[i, i + 1] = 1.0
    source = np.zeros(n, np.float32)
    source[0] = 1.0
    sink = np.zeros(n, np.float32)
    sink[n - 1] = 1.0
    return _workflow("pipeline_chain", route, source, sink)


def hierarchical(n: int, fan_out: float = 1.0) -> Workflow:
    """Coordinator (agent 0, source) fans out to n-2 specialists; every
    specialist forwards to the aggregator (agent n-1, the only sink)."""
    if n < 3:
        raise ValueError(f"hierarchical needs >= 3 agents, got {n}")
    route = np.zeros((n, n), np.float32)
    route[0, 1:n - 1] = 1.0 / (n - 2)
    route[1:n - 1, n - 1] = 1.0
    source = np.zeros(n, np.float32)
    source[0] = 1.0
    sink = np.zeros(n, np.float32)
    sink[n - 1] = 1.0
    fo = np.ones(n, np.float32)
    fo[0] = fan_out
    return _workflow("hierarchical", route, source, sink, fo)


def synthetic_workflow(
    n: int,
    seed: int = 0,
    edge_prob: float = 0.4,
    forward_frac: tuple[float, float] = (0.4, 0.9),
) -> Workflow:
    """A reproducible random DAG over the agent order: edges only go forward,
    each non-terminal agent forwards a random fraction of its served
    requests across a random successor subset and exits the rest.  Sources
    are the in-degree-0 agents, sinks the out-degree-0 ones."""
    if n < 1:
        raise ValueError(f"workflow size must be >= 1, got {n}")
    rng = np.random.default_rng(seed)
    route = np.zeros((n, n), np.float32)
    for i in range(n - 1):
        succ = rng.random(n - 1 - i) < edge_prob
        if not succ.any():
            succ[rng.integers(0, n - 1 - i)] = rng.random() < 0.7
        if succ.any():
            w = rng.uniform(0.1, 1.0, int(succ.sum()))
            frac = rng.uniform(*forward_frac)
            route[i, i + 1:][succ] = frac * w / w.sum()
    source = (route.sum(axis=0) == 0).astype(np.float32)
    sink = (route.sum(axis=1) == 0).astype(np.float32)
    return _workflow(f"synthetic_s{seed}", route, source, sink)


def pad_workflow(wf: Workflow, n_max: int) -> Workflow:
    """Pad ``wf`` to ``n_max`` slots, consistent with ``pad_fleet``: padded
    slots receive nothing, forward nothing, take no exogenous arrivals and
    are not sinks; ``fan_out=1`` keeps them inert."""
    n = wf.num_agents
    if n_max < n:
        raise ValueError(f"cannot pad workflow of {n} agents down to {n_max}")
    if n_max == n:
        return wf
    pad = n_max - n

    def vec(a, fill):
        return torch.cat([a.to(torch.float32),
                          torch.full((pad,), fill, dtype=torch.float32, device=a.device)])

    route = torch.zeros((n_max, n_max), dtype=torch.float32, device=wf.route.device)
    route[:n, :n] = wf.route
    return Workflow(
        name=wf.name, route=route, source=vec(wf.source, 0.0),
        sink=vec(wf.sink, 0.0), fan_out=vec(wf.fan_out, 1.0),
    )


def stack_workflows(workflows: Sequence[Workflow], n_max: int | None = None) -> Workflow:
    """Pad ``workflows`` to a common width and stack every leaf on a new
    leading workflow axis: (K, N, N) route, (K, N) flags."""
    if not workflows:
        raise ValueError("stack_workflows needs at least one workflow")
    width = max(w.num_agents for w in workflows)
    n_max = width if n_max is None else n_max
    if n_max < width:
        raise ValueError(f"n_max={n_max} < widest workflow ({width} agents)")
    padded = [pad_workflow(w, n_max) for w in workflows]
    stack = lambda field: torch.stack([getattr(w, field) for w in padded])
    return Workflow(
        name="+".join(w.name for w in workflows),
        route=stack("route"), source=stack("source"), sink=stack("sink"),
        fan_out=stack("fan_out"),
    )
