"""Paper core: adaptive GPU allocation and fleet simulation (PyTorch).

Re-exports the names ``repro/core/__init__.py`` re-exports, where the port
has them.  As in the reference, ``sweep`` here is the function; import the
module as ``repro_torch.core.sweep`` through ``importlib`` or ``from
repro_torch.core.sweep import ...``.
"""
from repro_torch.core.agents import (
    AgentSpec,
    Fleet,
    PAPER_ARRIVAL_RATES,
    T4_PRICE_PER_HOUR,
    pad_fleet,
    paper_fleet,
    scale_fleet,
    stack_fleets,
    synthetic_fleet,
)
from repro_torch.core.allocator import (
    adaptive_allocation,
    dispatch,
    get_policy,
    policy_id,
    policy_names,
    policy_stack,
    policy_switch,
    predictive_adaptive,
    register_policy,
    round_robin,
    static_equal,
    throughput_greedy,
    water_filling,
)
from repro_torch.core import capacity
from repro_torch.core import routing
from repro_torch.core import workload
from repro_torch.core.capacity import (
    CapacityConfig,
    CapacityState,
    billing_cost,
    capacity_config,
    capacity_policy_id,
    capacity_policy_names,
    check_capacity,
    register_capacity_policy,
    stack_capacities,
)
from repro_torch.core.objective import ObjectiveWeights, step_objective
from repro_torch.core.routing import (
    Workflow,
    coordinator_star,
    hierarchical,
    independent_workflow,
    pad_workflow,
    pipeline_chain,
    stack_workflows,
    synthetic_workflow,
)
from repro_torch.core.simulator import (
    METRIC_NAMES,
    MetricAccum,
    SimConfig,
    SimSummary,
    SimTrace,
    accumulate_metrics,
    finalize_metrics,
    init_metric_accum,
    run_policy,
    simulate,
    simulate_core,
    simulate_stream_core,
    summarize,
    trace_metrics,
)
from repro_torch.core.sweep import (
    Scenario,
    SweepResult,
    SweepSummary,
    capacity_scenario_library,
    fleet_scenario_library,
    scenario_library,
    sweep,
    sweep_capacity,
    sweep_fleets,
    sweep_workflows,
    workflow_scenario_library,
)

__all__ = [
    "AgentSpec", "Fleet", "PAPER_ARRIVAL_RATES", "T4_PRICE_PER_HOUR",
    "paper_fleet", "pad_fleet", "scale_fleet", "stack_fleets", "synthetic_fleet",
    "POLICY_NAMES", "adaptive_allocation", "predictive_adaptive",
    "round_robin", "static_equal", "throughput_greedy", "water_filling",
    "register_policy", "policy_names", "policy_id", "get_policy", "dispatch",
    "policy_stack", "policy_switch", "ObjectiveWeights", "step_objective",
    "POLICY_IDS",
    "SimConfig", "SimSummary", "SimTrace", "run_policy", "simulate",
    "simulate_core", "simulate_stream_core", "summarize", "trace_metrics",
    "MetricAccum", "accumulate_metrics", "finalize_metrics",
    "init_metric_accum", "workload", "METRIC_NAMES",
    "Scenario", "SweepResult", "SweepSummary", "fleet_scenario_library",
    "scenario_library", "sweep", "sweep_fleets",
    "routing", "Workflow", "coordinator_star", "hierarchical",
    "independent_workflow", "pad_workflow", "pipeline_chain",
    "stack_workflows", "synthetic_workflow", "sweep_workflows",
    "workflow_scenario_library",
    "capacity", "CapacityConfig", "CapacityState", "billing_cost",
    "capacity_config", "capacity_policy_id", "capacity_policy_names",
    "check_capacity", "register_capacity_policy", "stack_capacities",
    "sweep_capacity", "capacity_scenario_library",
]


def __getattr__(attr: str):
    # Live views over the registry, as in the reference.
    if attr == "POLICY_NAMES":
        return policy_names()
    if attr == "POLICY_IDS":
        return {name: i for i, name in enumerate(policy_names())}
    raise AttributeError(f"module {__name__!r} has no attribute {attr!r}")
