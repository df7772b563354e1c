"""(fleet | workflow | capacity | failure × policy × scenario) sweep grids:
the evaluation surface (port of ``repro/core/sweep.py``).

    sweep(fleet, scenario_library(rates))          ->  SweepResult (P, W)
    sweep(fleet, scenarios, failures=[...])        ->  SweepResult (B, P, W)
    sweep_fleets([fleet_4, ..., fleet_256])        ->  SweepResult (F, P, W)
    sweep_workflows(fleet, scenarios=...)          ->  SweepResult (K, P, W)
    sweep_capacity(fleet, scenarios=...)           ->  SweepResult (C, P, W)

By default a grid runs as one **stream** on the device
(``simulator.simulate_stream_core``): the state is ``(P, [L,] W, N)``, each
policy runs once per step on its own row, and the metrics accumulate in
running sums, so no (S, N) trajectory exists.  The leading axis L (fleets
padded to one width and stacked, topologies, capacity configs or chaos
scenarios) and the scenario axis W are cell axes of that one state: every
cell steps in the same launches.  ``stream=False`` (or
``keep_traces=True``) runs the trace oracle instead: the port's
``simulate_core`` once per cell, with ``trace_metrics`` and, when kept,
the traces stacked.  The stream matches it within float tolerance.

Scenarios are materialized ``Scenario`` tensors (copied to the device
once) or ``workload.WorkloadSpec`` rows synthesized on the device inside
the loop (``synthesize``; ``REPRO_SWEEP_SYNTH=0`` materializes them on the
host instead, through the same step functions).  ``block_size`` (or
``REPRO_SWEEP_BLOCK``) sets the stream's time block: identical metrics at
every block size.  ``return_arrays=True`` returns the device tensors.

Entry points run on ``device="cuda"`` unless the caller asks for another.
There is no mesh on one card: the reference's ``core/sharding.py`` has no
counterpart, and ``shard=`` is accepted and ignored (every grid runs on
the one device).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import allocator as alloc
from repro_torch.core import failures as fail_mod
from repro_torch.core import prng
from repro_torch.core import routing
from repro_torch.core import workload
from repro_torch.core.agents import Fleet, pad_fleet, stack_fleets
from repro_torch.core.capacity import (
    CapacityConfig, capacity_config, check_capacity, stack_capacities,
)
from repro_torch.core.routing import Workflow, stack_workflows
from repro_torch.core.simulator import (
    METRIC_NAMES, SimConfig, SimSummary, SimTrace, resolve_block_size, simulate_core,
    simulate_inputs, simulate_stream_core, trace_metrics,
)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named (S, N) arrival matrix; one workload column of the grid."""

    name: str
    arrivals: torch.Tensor


def scenario_library(rates, num_steps: int = 100, seed: int = 0) -> tuple[Scenario, ...]:
    """The standard 8-scenario library over one base rate vector: constant
    (Table II), poisson, spike, overload_3x, dominated, diurnal, bursty and
    correlated, the stochastic ones keyed off ``split(key(seed), 3)`` as
    in the reference."""
    rates = np.asarray(rates.cpu() if isinstance(rates, torch.Tensor) else rates, np.float32)
    n = int(rates.shape[0])
    k_poisson, k_bursty, k_corr = prng.split(prng.key(seed), 3)
    return (
        Scenario("constant", workload.constant(rates, num_steps)),
        Scenario("poisson", workload.poisson(rates, num_steps, k_poisson)),
        Scenario("spike", workload.spike(rates, num_steps, spike_agent=n - 1,
                                         spike_start=num_steps // 2,
                                         spike_len=max(num_steps // 10, 1))),
        Scenario("overload_3x", workload.scaled(rates, num_steps, 3.0)),
        Scenario("dominated", workload.dominated(rates, num_steps, agent=0, share=0.9)),
        Scenario("diurnal", workload.diurnal(rates, num_steps)),
        Scenario("bursty", workload.bursty(rates, num_steps, k_bursty)),
        Scenario("correlated", workload.correlated(rates, num_steps, k_corr)),
    )


def fleet_scenario_library(rate_vectors, n_max: int, num_steps: int = 100, seed: int = 0):
    """Each rate vector's library at its own size, zero-padded to ``n_max``
    agents: ``(scenario_names, arrivals (F, W, S, n_max))`` on the host."""
    names, blocks = None, []
    for rates in rate_vectors:
        lib = scenario_library(rates, num_steps, seed)
        lib_names = tuple(s.name for s in lib)
        if names is None:
            names = lib_names
        elif names != lib_names:
            raise ValueError("scenario libraries diverged across fleets")
        stacked = torch.stack([s.arrivals for s in lib])
        pad = n_max - stacked.shape[-1]
        if pad < 0:
            raise ValueError(f"rate vector wider ({stacked.shape[-1]}) than n_max={n_max}")
        blocks.append(torch.nn.functional.pad(stacked, (0, pad)))
    return names, torch.stack(blocks)


@dataclasses.dataclass(frozen=True)
class SweepSummary:
    """Flat Table-II-style rows, one per ([lead,] policy, scenario) cell."""

    columns: tuple[str, ...]
    rows: tuple[tuple, ...]

    def to_csv_lines(self) -> list[str]:
        out = [",".join(self.columns)]
        for row in self.rows:
            out.append(",".join(f"{v:.4f}" if isinstance(v, float) else str(v) for v in row))
        return out

    def best(self, metric: str = "avg_latency", minimize: bool = True) -> dict[str, str]:
        """Winning policy per scenario (per lead row and scenario when the
        table has a leading axis) under one metric.  Comparisons are strict,
        so an exact tie keeps the first row in table order (= registry
        order), minimizing or maximizing."""
        mi = self.columns.index(metric)
        si = self.columns.index("scenario")
        pi = self.columns.index("policy")
        fi = next((self.columns.index(c) for c in ("fleet", "workflow", "capacity", "failure")
                   if c in self.columns), None)
        winners: dict[str, tuple[str, float]] = {}
        for row in self.rows:
            key = row[si] if fi is None else f"{row[fi]}/{row[si]}"
            val = row[mi]
            if key not in winners:
                winners[key] = (row[pi], val)
                continue
            better = val < winners[key][1] if minimize else val > winners[key][1]
            if better:
                winners[key] = (row[pi], val)
        return {key: pol for key, (pol, _) in winners.items()}


@dataclasses.dataclass(frozen=True)
class SweepResult:
    """Grids from one sweep, on the host; axes ([lead,] policy, scenario[,
    agent]), the lead axis one of fleet, workflow, capacity or failure (at
    most one is set)."""

    policy_names: tuple[str, ...]
    scenario_names: tuple[str, ...]
    metrics: np.ndarray               # ([L,] P, W, len(METRIC_NAMES)) float32
    per_agent_latency: np.ndarray     # ([L,] P, W, N)
    per_agent_throughput: np.ndarray  # ([L,] P, W, N)
    config: SimConfig
    traces: SimTrace | None = None    # leaves ([L,] P, W, S, N) when kept
    fleet_names: tuple[str, ...] | None = None
    workflow_names: tuple[str, ...] | None = None
    capacity_names: tuple[str, ...] | None = None
    per_agent_queue: np.ndarray | None = None
    failure_names: tuple[str, ...] | None = None

    def _leading_axis(self):
        for axis in ("fleet", "workflow", "capacity", "failure"):
            names = getattr(self, f"{axis}_names")
            if names is not None:
                return axis, names
        return None

    def metric(self, name: str) -> np.ndarray:
        return self.metrics[..., METRIC_NAMES.index(name)]

    def _cell_index(self, policy, scenario, fleet=None, workflow=None, capacity=None,
                    failure=None):
        p = self.policy_names.index(policy)
        w = self.scenario_names.index(scenario)
        lead = self._leading_axis()
        picked = {"fleet": fleet, "workflow": workflow, "capacity": capacity, "failure": failure}
        if lead is None:
            bad = [k for k, v in picked.items() if v is not None]
            if bad:
                raise ValueError(f"this sweep has no {bad[0]} axis")
            return (p, w)
        axis, names = lead
        if picked[axis] is None:
            raise ValueError(f"{axis} axis present; pick one of {names}")
        for other in picked:
            if other != axis and picked[other] is not None:
                raise ValueError(f"this sweep has no {other} axis")
        return (names.index(picked[axis]), p, w)

    def summary(self, policy: str, scenario: str, fleet: str | None = None,
                workflow: str | None = None, capacity: str | None = None,
                failure: str | None = None) -> SimSummary:
        """One cell as a ``SimSummary``, the fields of ``run_policy``."""
        idx = self._cell_index(policy, scenario, fleet, workflow, capacity, failure)
        m = dict(zip(METRIC_NAMES, (float(x) for x in self.metrics[idx])))
        per_queue = () if self.per_agent_queue is None else self.per_agent_queue[idx]
        return SimSummary.from_metrics(policy, m, self.per_agent_latency[idx],
                                       self.per_agent_throughput[idx], per_queue)

    def table(self) -> SweepSummary:
        base = ("policy", "scenario") + METRIC_NAMES
        lead = self._leading_axis()
        lead_names = (None,) if lead is None else lead[1]
        rows = []
        for f, fl in enumerate(lead_names):
            grid = self.metrics if lead is None else self.metrics[f]
            for p, pol in enumerate(self.policy_names):
                for w, scen in enumerate(self.scenario_names):
                    prefix = (pol, scen) if lead is None else (fl, pol, scen)
                    rows.append(prefix + tuple(float(x) for x in grid[p, w]))
        columns = base if lead is None else ((lead[0],) + base)
        return SweepSummary(columns=columns, rows=tuple(rows))


def synth_gen_groups(wspec) -> tuple | None:
    """The scenario axis of a stacked spec partitioned by generator:
    ``((gen_name, (idx, ...)), ...)``, or None without a spec or when a
    fleet-batched stack changes generator along a scenario column.  The
    stream's ``workload.Synth`` runs each group as one batched call."""
    if wspec is None:
        return None
    gids = np.asarray(wspec.gen_id)
    if gids.ndim == 2:
        if not (gids == gids[0]).all():
            return None
        gids = gids[0]
    return workload.gen_groups(gids)


def _streamed(keep_traces: bool, stream: bool | None) -> bool:
    return (not keep_traces) if stream is None else bool(stream)


def _prepare_scenarios(scenarios, synthesize: bool | None, streamed: bool):
    """One call's workload column: ``(names, arrivals (W, S, N) | None,
    stacked spec | None)``.  Specs run in the loop when synthesis is on (the
    default for specs), the call streams and ``REPRO_SWEEP_SYNTH`` is not
    0; otherwise they are materialized on the host."""
    scenarios = list(scenarios)
    if not scenarios:
        raise ValueError("need at least one scenario")
    spec_like = [isinstance(s, workload.WorkloadSpec) for s in scenarios]
    names = tuple(s.name for s in scenarios)
    if any(spec_like):
        if not all(spec_like):
            raise ValueError("scenarios must be all Scenario or all WorkloadSpec, not a mix")
        synth = True if synthesize is None else bool(synthesize)
        if synth and streamed and workload.synth_env_enabled():
            return names, None, workload.stack_specs(scenarios)
        return names, torch.stack([workload.materialize(s) for s in scenarios]), None
    if synthesize:
        raise ValueError(
            "synthesize=True needs WorkloadSpec scenarios (e.g. workload.scenario_specs); "
            "got materialized Scenario tensors"
        )
    return names, torch.stack([torch.as_tensor(s.arrivals, dtype=torch.float32)
                               for s in scenarios]), None


def _resolve_failure_axis(failures, allow_batch: bool):
    """``(spec, None)`` for one spec (or None), ``(list of specs, names)``
    for a failure axis (plain ``sweep`` only).  ``REPRO_FAILURES=0`` applies
    first."""
    if isinstance(failures, fail_mod.FailureSpec) or failures is None:
        failures = fail_mod.resolve_failures(failures)
        if failures is None:
            return None, None
        if failures.batched:
            raise ValueError(
                "pass a sequence of FailureSpec rows (not a pre-stacked spec) "
                "to put failures on the sweep axis"
            )
        fail_mod.check_failures(failures)
        return failures, None
    specs = list(failures)
    if not allow_batch:
        raise ValueError(
            "only the plain sweep() supports a failure axis; sweep_fleets/"
            "sweep_workflows/sweep_capacity already batch their own axis — "
            "pass a single FailureSpec"
        )
    if not specs:
        raise ValueError("need at least one failure scenario")
    for s in specs:
        fail_mod.check_failures(s)
    if not fail_mod.failures_env_enabled():
        return None, None
    fail_mod.stack_failures(specs)  # names unique
    return specs, tuple(s.name for s in specs)


# ---------------------------------------------------------------------------
# The two kernels: the stream (default) and the trace oracle.
# ---------------------------------------------------------------------------

def _lead_view(x: torch.Tensor) -> torch.Tensor:
    """A stacked leaf (L, *rest) as (L, 1, *rest): the scenario cell axis
    after the lead axis."""
    return x.unsqueeze(1)


def _stream_cells(batch_axis, fleet, workflow, capacity, fspec, dev):
    """The layers shaped for the stream's ``(P, [L,] W, N)`` state: the
    batch axis's list stacked, each leaf (L, 1, ...)."""
    if batch_axis == "fleet":
        st = stack_fleets(fleet)
        fleet = dataclasses.replace(st, **{f: _lead_view(getattr(st, f)) for f in (
            "model_size_mb", "base_throughput", "min_gpu", "priority", "active")})
    if batch_axis == "workflow":
        st = stack_workflows(workflow)
        workflow = dataclasses.replace(st, **{
            f: _lead_view(getattr(st, f)) for f in ("route", "source", "sink", "fan_out")})
    if batch_axis == "capacity":
        capacity = stack_capacities(capacity).map(_lead_view)
    if batch_axis == "failure":
        # Scalar knobs (B, 1); the deadline, used per agent, (B, 1, 1 or N).
        st = fail_mod.stack_failures(fspec)
        deadline = st.deadline_s.reshape(st.deadline_s.shape[:1] + (1,)
                                          + (tuple(st.deadline_s.shape[1:]) or (1,)))
        fspec = dataclasses.replace(st.map(_lead_view), deadline_s=deadline,
                                    key_data=st.key_data.reshape(-1, 1, 2))
    fleet = fleet.to(dev)
    workflow = None if workflow is None else workflow.to(dev)
    capacity = None if capacity is None else capacity.to(dev)
    if fspec is not None:  # the keys as int64 words on the device, before the loop
        fspec = dataclasses.replace(fspec.to(dev), key_data=prng.key_t(fspec.key_data, dev))
    return fleet, workflow, capacity, fspec


def _stream_grid(names, arrivals, wspec, fleet, workflow, capacity, fspec, config,
                 batch_axis, dev, block_size):
    fleet, workflow, capacity, fspec = _stream_cells(batch_axis, fleet, workflow, capacity,
                                                     fspec, dev)
    synth = None if wspec is None else workload.Synth(wspec, dev)
    arr = None if arrivals is None else arrivals.to(dev)
    out = simulate_stream_core(arr, fleet, config, names, workflow, capacity,
                               workload_spec=synth, block_size=block_size, failures=fspec)
    lead = 0 if batch_axis is None else 1
    # (*cells, P, ·) with cells ([L,] W): the policy axis before the scenarios.
    return tuple(x.movedim(lead + 1, lead) for x in out)


def _trace_grid(names, arrivals, fleet, workflow, capacity, fspec, config, batch_axis, dev,
                keep_traces):
    """The oracle: ``simulate_core`` and ``trace_metrics`` per cell."""
    rows = {None: [None], "fleet": fleet, "workflow": workflow, "capacity": capacity,
            "failure": fspec}[batch_axis]
    n_max = max(f.num_agents for f in fleet) if batch_axis == "fleet" else None
    cells = []  # (metrics, per-agent latency, throughput, queue, trace), ([L,] P, W) order
    for li in range(len(rows)):
        fl = pad_fleet(fleet[li], n_max) if batch_axis == "fleet" else fleet
        wf = workflow[li] if batch_axis == "workflow" else workflow
        cp = capacity[li] if batch_axis == "capacity" else capacity
        fs = fspec[li] if batch_axis == "failure" else fspec
        arr = arrivals[li] if batch_axis == "fleet" else arrivals
        for pol in names:
            for w in range(arr.shape[0]):
                args = simulate_inputs(pol, arr[w], fl, config, wf, cp, fs, device=dev)
                trace = simulate_core(**args)
                cells.append(trace_metrics(trace, args["fleet"].active, args["workflow"],
                                           config=config) + (trace,))
    shape = (() if batch_axis is None else (len(rows),)) + (len(names), arrivals.shape[-3])
    stack = lambda xs: torch.stack(xs).reshape(shape + xs[0].shape)
    out = [stack([c[k] for c in cells]) for k in range(4)]
    if keep_traces:
        out.append(SimTrace(**{f: stack([c[4].fields()[f] for c in cells])
                               for f in cells[0][4].fields()}))
    return tuple(out)


def _run_grid(names, arrivals, wspec, fleet, workflow, capacity, fspec, config, batch_axis,
              keep_traces, stream, device, block_size):
    """Pick the kernel: the stream by default, the trace oracle when traces
    are kept or ``stream=False``.  ``fleet``/``workflow``/``capacity``/
    ``fspec`` is a list of rows for the batch axis, else one object.
    Returns the device tensors (metrics, per-agent latency, throughput,
    queue[, traces])."""
    streamed = _streamed(keep_traces, stream)
    if streamed and keep_traces:
        raise ValueError(
            "streaming mode keeps running sums and never materializes traces; "
            "use keep_traces=True with stream=False (or leave stream unset)"
        )
    if wspec is not None and not streamed:
        raise ValueError("in-loop synthesis runs in the stream; materialize the specs "
                         "for the trace oracle")
    dev = resolve_device(device)
    if streamed:
        return _stream_grid(names, arrivals, wspec, fleet, workflow, capacity, fspec, config,
                            batch_axis, dev, resolve_block_size(block_size))
    return _trace_grid(names, arrivals, fleet, workflow, capacity, fspec, config, batch_axis,
                       dev, keep_traces)


def _result(out, names, scen_names, config, keep_traces, **axis_names) -> SweepResult:
    metrics, per_lat, per_tput, per_q = (x.cpu().numpy() for x in out[:4])
    return SweepResult(
        policy_names=names, scenario_names=scen_names, metrics=metrics,
        per_agent_latency=per_lat, per_agent_throughput=per_tput, config=config,
        traces=out[4] if keep_traces else None, per_agent_queue=per_q, **axis_names,
    )


def _policy_names(policies) -> tuple[str, ...]:
    names = alloc.policy_names() if policies is None else tuple(policies)
    for n in names:
        alloc.get_policy(n)
    return names


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def sweep(
    fleet: Fleet,
    scenarios: Sequence,
    config: SimConfig = SimConfig(),
    policies: Sequence[str] | None = None,
    keep_traces: bool = False,
    capacity: CapacityConfig | None = None,
    stream: bool | None = None,
    return_arrays: bool = False,
    shard: bool | None = None,
    synthesize: bool | None = None,
    block_size: int | None = None,
    failures=None,
    device="cuda",
) -> SweepResult | tuple:
    """Evaluate ``policies`` (default: the whole registry) × ``scenarios``
    on ``device``.

    All scenarios share one (S, N) shape.  An optional ``capacity``
    autoscaler applies to every cell.  ``failures`` is one ``FailureSpec``
    for every cell, or a sequence of them (e.g.
    ``failure_scenario_library()``): a leading chaos axis, and the result
    carries ``failure_names``.  ``scenarios`` may be ``WorkloadSpec`` rows,
    synthesized on the device inside the loop (``synthesize``).
    ``shard`` is accepted for the reference's signature; one device runs
    every grid.
    """
    fleet.validate()
    if capacity is not None:
        check_capacity(capacity, config.g_total, config.num_gpus)
    fspec, failure_names = _resolve_failure_axis(failures, allow_batch=True)
    batch_axis = None if failure_names is None else "failure"
    names = _policy_names(policies)
    scen_names, arrivals, wspec = _prepare_scenarios(
        scenarios, synthesize, _streamed(keep_traces, stream))
    out = _run_grid(names, arrivals, wspec, fleet, None, capacity, fspec, config, batch_axis,
                    keep_traces, stream, device, block_size)
    if return_arrays:
        return out
    return _result(out, names, scen_names, config, keep_traces, failure_names=failure_names)


def sweep_fleets(
    fleets: Sequence[Fleet],
    rate_vectors=None,
    num_steps: int = 100,
    seed: int = 0,
    config: SimConfig = SimConfig(),
    policies: Sequence[str] | None = None,
    fleet_names: Sequence[str] | None = None,
    keep_traces: bool = False,
    shard: bool | None = True,
    stream: bool | None = None,
    return_arrays: bool = False,
    synthesize: bool | None = None,
    block_size: int | None = None,
    failures=None,
    device="cuda",
) -> SweepResult | tuple:
    """One (fleet × policy × scenario) grid over heterogeneous fleets,
    padded to the widest and stacked; each fleet gets the scenario library
    at its true size from its own rate vector (default:
    ``workload.synthetic_rates(n, seed=seed + i)``, the paper's aggregate
    load).

    ``synthesize``: None keeps the materialized ``fleet_scenario_library``
    tensors; True synthesizes ``workload.fleet_scenario_specs`` in the loop
    (no (F, W, S, N) slab exists: the long-horizon mode); False
    materializes those specs on the host.
    """
    fleets = list(fleets)
    if not fleets:
        raise ValueError("sweep_fleets needs at least one fleet")
    for f in fleets:
        f.validate()
    if rate_vectors is None:
        rate_vectors = [workload.synthetic_rates(f.num_agents, seed=seed + i)
                        for i, f in enumerate(fleets)]
    if len(rate_vectors) != len(fleets):
        raise ValueError("need one rate vector per fleet")
    for i, (f, r) in enumerate(zip(fleets, rate_vectors)):
        width = np.asarray(r).shape[-1]
        if width != f.num_agents:
            raise ValueError(
                f"rate vector {i} has {width} agents but fleet {i} has {f.num_agents}; "
                "a mismatch would silently zero real demand"
            )
    fleet_names = (tuple(f"fleet{i}_n{f.num_agents}" for i, f in enumerate(fleets))
                   if fleet_names is None else tuple(fleet_names))
    n_max = max(f.num_agents for f in fleets)
    wspec = None
    if synthesize is None:
        scen_names, arrivals = fleet_scenario_library(rate_vectors, n_max, num_steps, seed)
    else:
        scen_names, spec_rows = workload.fleet_scenario_specs(rate_vectors, n_max, num_steps,
                                                              seed)
        if synthesize and _streamed(keep_traces, stream) and workload.synth_env_enabled():
            arrivals = None
            wspec = workload.stack_specs(
                [workload.stack_specs(row, name=f"fleet{i}") for i, row in enumerate(spec_rows)],
                name="fleet_grid")
        else:
            arrivals = torch.stack([torch.stack([workload.materialize(s) for s in row])
                                    for row in spec_rows])
    fspec, _ = _resolve_failure_axis(failures, allow_batch=False)
    names = _policy_names(policies)
    out = _run_grid(names, arrivals, wspec, fleets, None, None, fspec, config, "fleet",
                    keep_traces, stream, device, block_size)
    if return_arrays:
        return out
    return _result(out, names, scen_names, config, keep_traces, fleet_names=fleet_names)


def workflow_scenario_library(num_agents: int, seed: int = 0,
                              fan_out: float = 1.0) -> tuple[Workflow, ...]:
    """The canonical topologies for one fleet width: independent,
    coordinator_star, pipeline_chain, hierarchical (when the width allows
    it) and a reproducible random DAG."""
    wfs = [routing.independent(num_agents)]
    if num_agents >= 2:
        wfs.append(routing.coordinator_star(num_agents, fan_out=fan_out))
        wfs.append(routing.pipeline_chain(num_agents))
    if num_agents >= 3:
        wfs.append(routing.hierarchical(num_agents, fan_out=fan_out))
    wfs.append(routing.synthetic_workflow(num_agents, seed=seed))
    return tuple(wfs)


def _default_scenarios(scenarios, n, num_steps, seed, synthesize):
    if scenarios is not None:
        return scenarios
    rates = workload.synthetic_rates(n, seed=seed)
    return (workload.scenario_specs(rates, num_steps, seed) if synthesize
            else scenario_library(rates, num_steps, seed))


def sweep_workflows(
    fleet: Fleet,
    workflows: Sequence[Workflow] | None = None,
    scenarios: Sequence | None = None,
    num_steps: int = 100,
    seed: int = 0,
    config: SimConfig = SimConfig(),
    policies: Sequence[str] | None = None,
    keep_traces: bool = False,
    stream: bool | None = None,
    return_arrays: bool = False,
    shard: bool | None = None,
    synthesize: bool | None = None,
    block_size: int | None = None,
    failures=None,
    device="cuda",
) -> SweepResult | tuple:
    """One (workflow × policy × scenario) grid over one fleet.  Every
    workflow spans the fleet's width; the same scenario block feeds every
    topology, gated by each one's sources.  Defaults: the canonical
    topologies and the scenario library over ``synthetic_rates``."""
    fleet.validate()
    n = fleet.num_agents
    workflows = list(workflow_scenario_library(n, seed=seed) if workflows is None else workflows)
    if not workflows:
        raise ValueError("sweep_workflows needs at least one workflow")
    for wf in workflows:
        routing.check_workflow(wf, n)
    workflow_names = tuple(w.name for w in workflows)
    if len(set(workflow_names)) != len(workflow_names):
        raise ValueError(f"workflow names must be unique: {workflow_names}")
    scen_names, arrivals, wspec = _prepare_scenarios(
        _default_scenarios(scenarios, n, num_steps, seed, synthesize), synthesize,
        _streamed(keep_traces, stream))
    fspec, _ = _resolve_failure_axis(failures, allow_batch=False)
    names = _policy_names(policies)
    out = _run_grid(names, arrivals, wspec, fleet, workflows, None, fspec, config, "workflow",
                    keep_traces, stream, device, block_size)
    if return_arrays:
        return out
    return _result(out, names, scen_names, config, keep_traces, workflow_names=workflow_names)


def capacity_scenario_library(cold_start_s: float = 5.0, keep_alive_s: float = 10.0,
                              target_rate_per_instance: float = 60.0,
                              backlog_per_instance: float = 50.0) -> tuple[CapacityConfig, ...]:
    """The canonical capacity policies: ``fixed``, ``reactive`` with free
    scale-up, ``reactive_cold`` paying ``cold_start_s`` per new instance,
    and ``scale_to_zero`` with a cold start and a keep-alive window."""
    knobs = dict(target_rate_per_instance=target_rate_per_instance,
                 backlog_per_instance=backlog_per_instance)
    return (
        capacity_config("fixed"),
        capacity_config("reactive", min_instances=1.0, **knobs),
        capacity_config("reactive", cold_start_s=cold_start_s, min_instances=1.0,
                        name="reactive_cold", **knobs),
        capacity_config("scale_to_zero", cold_start_s=cold_start_s, keep_alive_s=keep_alive_s,
                        **knobs),
    )


def sweep_capacity(
    fleet: Fleet,
    capacities: Sequence[CapacityConfig] | None = None,
    scenarios: Sequence | None = None,
    num_steps: int = 100,
    seed: int = 0,
    config: SimConfig = SimConfig(),
    policies: Sequence[str] | None = None,
    keep_traces: bool = False,
    stream: bool | None = None,
    return_arrays: bool = False,
    shard: bool | None = None,
    synthesize: bool | None = None,
    block_size: int | None = None,
    failures=None,
    device="cuda",
) -> SweepResult | tuple:
    """One (capacity × policy × scenario) grid over one fleet: every
    allocation policy under every elasticity regime, cost billed per cell
    on warm-instance-seconds.  Defaults: the canonical capacity library
    and the scenario library over ``synthetic_rates``."""
    fleet.validate()
    capacities = list(capacity_scenario_library() if capacities is None else capacities)
    if not capacities:
        raise ValueError("sweep_capacity needs at least one capacity config")
    for cp in capacities:
        check_capacity(cp, config.g_total, config.num_gpus)
    capacity_names = tuple(c.name for c in capacities)
    if len(set(capacity_names)) != len(capacity_names):
        raise ValueError(f"capacity names must be unique: {capacity_names}")
    scen_names, arrivals, wspec = _prepare_scenarios(
        _default_scenarios(scenarios, fleet.num_agents, num_steps, seed, synthesize),
        synthesize, _streamed(keep_traces, stream))
    fspec, _ = _resolve_failure_axis(failures, allow_batch=False)
    names = _policy_names(policies)
    out = _run_grid(names, arrivals, wspec, fleet, None, capacities, fspec, config, "capacity",
                    keep_traces, stream, device, block_size)
    if return_arrays:
        return out
    return _result(out, names, scen_names, config, keep_traces, capacity_names=capacity_names)
