"""Spatial partitioning: the integer-device analogue of Algorithm 1 (the
port's own copy of ``repro/distributed/partition.py``, numpy only).

The port's primary reading of fractional GPU allocation is the engine's
time-multiplexed token budgets (``serving/engine.py``).  This planner is the
alternative: carve a pool of whole devices (the reference's chips of a pod's
``model`` axis) into per-agent groups with the same demand →
max(min, proportional) → renormalize structure, rounded to integers by
largest remainder (Hamilton's method), so Σ chips == total exactly and
every busy agent keeps its minimum.

Re-partitioning moves weights (seconds, not the paper's milliseconds), so
``should_repartition`` takes a new plan only if it raises the projected
throughput by more than ``stability_gain``.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    chips: tuple[int, ...]           # per-agent chip counts, sums to total
    fractions: tuple[float, ...]     # continuous allocation it rounds
    total_chips: int


def plan_partition(
    lam: np.ndarray,
    min_gpu: np.ndarray,
    priority: np.ndarray,
    total_chips: int,
) -> PartitionPlan:
    """Algorithm 1 + largest-remainder integer rounding over chips."""
    lam = np.asarray(lam, np.float64)
    min_gpu = np.asarray(min_gpu, np.float64)
    priority = np.asarray(priority, np.float64)
    busy_in = lam > 0
    demand = np.where(busy_in, np.maximum(lam * min_gpu / priority, 1e-300), 0.0)
    d_total = demand.sum()
    if d_total <= 0:
        return PartitionPlan((0,) * len(lam), (0.0,) * len(lam), total_chips)
    g = np.maximum(min_gpu, demand / d_total)
    g = np.where(lam > 0, g, np.minimum(g, min_gpu))
    if g.sum() > 1.0:
        g = g / g.sum()

    busy = lam > 0
    if int(busy.sum()) > total_chips:
        # Degenerate: more busy agents than chips — one chip each to the
        # highest-demand agents; the rest wait (time-multiplexed instead).
        chips = np.zeros(len(lam), int)
        order = np.argsort(-demand)
        chips[order[:total_chips]] = 1
        return PartitionPlan(tuple(int(c) for c in chips),
                             tuple(float(x) for x in g), total_chips)

    raw = g * total_chips
    floor = np.floor(raw).astype(int)
    # Guarantee >=1 chip for any busy agent before distributing remainders.
    floor = np.where(busy & (floor == 0), 1, floor)
    deficit = total_chips - floor.sum()
    if deficit < 0:  # minimum-guarantee overshoot: take from largest
        order = np.argsort(-floor)
        for i in order:
            while deficit < 0 and floor[i] > 1:
                floor[i] -= 1
                deficit += 1
    rema = raw - np.floor(raw)
    order = np.argsort(-rema)
    for i in order:
        if deficit == 0:
            break
        floor[i] += 1
        deficit -= 1
    return PartitionPlan(tuple(int(c) for c in floor), tuple(float(x) for x in g),
                         total_chips)


def should_repartition(
    current: PartitionPlan,
    proposed: PartitionPlan,
    base_throughput: np.ndarray,
    stability_gain: float = 0.10,
) -> bool:
    """Reshard only if projected capacity improves by > stability_gain."""
    t = np.asarray(base_throughput, np.float64)
    cur = (np.asarray(current.chips) / current.total_chips * t).sum()
    new = (np.asarray(proposed.chips) / proposed.total_chips * t).sum()
    if cur <= 0:
        return new > 0
    return (new - cur) / cur > stability_gain
