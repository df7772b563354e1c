"""Billing and the instance ceiling (port of part of ``repro/core/capacity.py``).

Only ``billing_cost`` and ``check_budget_ceiling`` are ported so far: the
serving engine with ``capacity=None`` needs nothing else.  The warm-pool
autoscaler (``capacity_step`` and the capacity-policy registry) comes with
ROADMAP A2.
"""
from __future__ import annotations


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
