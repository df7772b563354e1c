"""Paper Eq. (2): min over allocations of  alpha·L + beta·C − gamma·H (port
of ``repro/core/objective.py``)."""
from __future__ import annotations

import dataclasses

import torch

_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class ObjectiveWeights:
    alpha: float = 1.0   # latency weight
    beta: float = 1.0    # cost weight
    gamma: float = 1.0   # throughput weight (negated: reward)


def step_objective(
    g: torch.Tensor,
    queue: torch.Tensor,
    lam: torch.Tensor,
    base_throughput: torch.Tensor,
    weights: ObjectiveWeights = ObjectiveWeights(),
    price_per_second: float = 0.0002,
    latency_cap: float = 1000.0,
    warm_instances: torch.Tensor | float = 1.0,
) -> torch.Tensor:
    """One-step value of Eq. (2) for allocation g at state (queue, lam).

    ``warm_instances`` prices the step's warm-pool size into the cost term
    (warm-instance-seconds billing); the default of 1.0 is the paper's
    provisioned single device, where the cost term is the same for every
    allocation.
    """
    capacity = g * base_throughput
    served = torch.minimum(capacity, queue + lam)
    new_queue = queue + lam - served
    latency = torch.clamp(new_queue / torch.clamp(capacity, min=_EPS), max=latency_cap)
    l_term = latency.mean()
    c_term = price_per_second * warm_instances
    h_term = served.sum()
    return weights.alpha * l_term + weights.beta * c_term - weights.gamma * h_term
