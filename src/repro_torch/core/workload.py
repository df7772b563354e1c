"""Arrival processes (part of ``repro/core/workload.py``).

Only what Table II needs is ported so far: the paper's constant workload.
The other registered generators (poisson, spike, diurnal, bursty,
correlated), their specs and in-loop synthesis come with ROADMAP A4.
"""
from __future__ import annotations

import numpy as np
import torch

# The paper's aggregate arrival rate (Table II's workload), req/s.
PAPER_TOTAL_RATE = 190.0


def constant(rates, num_steps: int) -> torch.Tensor:
    """lam_i(t) = rates_i for all t (reproduces the paper's Table II):
    (num_steps, N) float32 on the host."""
    rates = torch.as_tensor(np.asarray(rates, np.float32))
    return rates.expand(num_steps, rates.shape[0]).contiguous()
