"""Agent fleet specifications (paper §III-A, Table I) as a tensor dataclass.

Port of ``repro/core/agents.py``.  An agent is characterized by
(M_i, T_i, R_i, P_i): model size (MB), base throughput at full GPU
(requests/s), minimum GPU fraction, and priority (1 = high, 2 = medium,
3 = low).  The fleet is stored struct-of-arrays as float32 tensors so the
allocator is vectorized over agents.

Every fleet carries ``active`` ∈ {0,1}^N: real agents are 1, padding is 0.
``pad_fleet`` grows a fleet to ``n_max`` slots with inert padding (T=1,
R=0, P=1, active=0); every registered policy gives padded slots exactly
g = 0 (see ``core/allocator.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AgentSpec:
    """One agent's static profile (paper Table I row)."""

    name: str
    model_size_mb: float   # M_i
    base_throughput: float  # T_i, requests/s at g=1.0
    min_gpu: float          # R_i, fraction of total capacity
    priority: int           # P_i: 1=high, 2=medium, 3=low


def _f32(values) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, np.float32))


@dataclasses.dataclass(frozen=True)
class Fleet:
    """Struct-of-arrays view of N agent slots.

    ``active`` is the agent-validity mask: 1.0 for real agents, 0.0 for
    padding slots introduced by ``pad_fleet``.  It defaults to all-ones.
    """

    names: tuple[str, ...]
    model_size_mb: torch.Tensor    # (N,)
    base_throughput: torch.Tensor  # (N,)
    min_gpu: torch.Tensor          # (N,)
    priority: torch.Tensor         # (N,) float for division
    active: torch.Tensor = None    # (N,) validity mask, defaults to ones

    def __post_init__(self):
        if self.active is None:
            object.__setattr__(
                self, "active",
                torch.ones(len(self.names), dtype=torch.float32,
                           device=self.min_gpu.device),
            )

    @property
    def num_agents(self) -> int:
        """Slot count N (padded width; ``num_active`` counts real agents)."""
        return len(self.names)

    @property
    def num_active(self) -> torch.Tensor:
        return self.active.sum()

    @staticmethod
    def from_specs(specs: Sequence[AgentSpec]) -> "Fleet":
        return Fleet(
            names=tuple(s.name for s in specs),
            model_size_mb=_f32([s.model_size_mb for s in specs]),
            base_throughput=_f32([s.base_throughput for s in specs]),
            min_gpu=_f32([s.min_gpu for s in specs]),
            priority=_f32([s.priority for s in specs]),
        )

    def validate(self) -> None:
        """Static sanity constraints."""
        mins = self.min_gpu.cpu().numpy()
        pris = self.priority.cpu().numpy()
        mask = self.active.cpu().numpy()
        if (mins < 0).any() or (mins > 1).any():
            raise ValueError(f"min_gpu out of [0,1]: {mins}")
        if (pris < 1).any():
            raise ValueError(f"priority must be >= 1: {pris}")
        if (self.base_throughput.cpu().numpy() <= 0).any():
            raise ValueError("base_throughput must be positive")
        if not np.isin(mask, (0.0, 1.0)).all():
            raise ValueError(f"active mask must be 0/1: {mask}")


def paper_fleet() -> Fleet:
    """The paper's 4-agent system, exactly Table I."""
    return Fleet.from_specs([
        AgentSpec("coordinator", 500.0, 100.0, 0.10, 1),
        AgentSpec("specialist_nlp", 2000.0, 50.0, 0.30, 2),
        AgentSpec("specialist_vision", 1500.0, 60.0, 0.25, 2),
        AgentSpec("specialist_reasoning", 3000.0, 30.0, 0.35, 1),
    ])


def pad_fleet(fleet: Fleet, n_max: int) -> Fleet:
    """Pad ``fleet`` to ``n_max`` slots with inert, masked-out agents.

    Padding slots carry T=1 (keeps every division finite), R=0, P=1 and
    ``active=0``; every registered policy hands them exactly g = 0.
    """
    n = fleet.num_agents
    if n_max < n:
        raise ValueError(f"cannot pad fleet of {n} agents down to {n_max}")
    if n_max == n:
        return fleet
    pad = n_max - n

    def ext(a, fill):
        a = a.to(torch.float32)
        return torch.cat([a, torch.full((pad,), fill, dtype=torch.float32, device=a.device)])

    return Fleet(
        names=fleet.names + tuple(f"_pad_{i}" for i in range(pad)),
        model_size_mb=ext(fleet.model_size_mb, 0.0),
        base_throughput=ext(fleet.base_throughput, 1.0),
        min_gpu=ext(fleet.min_gpu, 0.0),
        priority=ext(fleet.priority, 1.0),
        active=ext(fleet.active, 0.0),
    )


# Paper platform model: NVIDIA T4, $0.72/hour.
T4_PRICE_PER_HOUR = 0.72
