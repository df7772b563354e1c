"""AdamW + cosine schedule + global-norm clipping (port of
``repro/training/optimizer.py``).

The optimizer state keeps m and v in float32 on each parameter's device,
whatever the parameter's dtype, and the step as an int32 tensor.  The
update follows the reference's rounding points: the gradient widened to
float32 and scaled by the clip factor, the moments and the step in float32,
the new parameter cast back to the parameter's dtype once.  Every scalar of
the step (the global norm, the clip factor, the learning rate, the bias
corrections) stays a device tensor: the update never waits for the host.

Unlike the reference, which returns new trees, ``adamw_update`` writes the
new parameters, m and v into the given tensors (as ``torch.optim`` does),
so that a step holds one copy of them; the step counter is a new tensor.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.models.params import abstract_dtensor, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(step: torch.Tensor, cfg: OptimizerConfig) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_frac * lr (float32)."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    frac = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    frac = torch.clamp(frac, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params) -> dict:
    """m and v as float32 zeros beside each parameter, step 0 (int32); for
    DTensor parameters m and v take each parameter's placements and the
    step is replicated."""
    leaves = tree_leaves(params)
    if leaves and isinstance(leaves[0], DTensor):
        from torch.distributed.tensor import distribute_tensor

        mesh = leaves[0].device_mesh
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        step = distribute_tensor(torch.zeros((), dtype=torch.int32, device=leaves[0].device),
                                 mesh, (Replicate(),) * mesh.ndim)
    else:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
        step = torch.zeros((), dtype=torch.int32, device=leaves[0].device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params), "step": step}


def abstract_opt_state(abstract_params) -> dict:
    """``init_opt_state``'s tree as ``meta`` tensors: float32 m and v of
    each parameter's shape, an int32 step.  For DTensor parameters m and v
    take each parameter's placements and the step is replicated (the
    reference's ``opt_sh``, ``repro/launch/dryrun.py:113-117``)."""
    leaves = tree_leaves(abstract_params)
    if leaves and isinstance(leaves[0], DTensor):
        mesh = leaves[0].device_mesh
        f32 = lambda p: abstract_dtensor(mesh, p.placements, p.shape, torch.float32)  # noqa: E731
        step = abstract_dtensor(mesh, (Replicate(),) * mesh.ndim, (), torch.int32)
    else:
        f32 = lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta")  # noqa: E731
        step = torch.empty((), dtype=torch.int32, device="meta")
    return {"m": tree_map(f32, abstract_params), "v": tree_map(f32, abstract_params),
            "step": step}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares."""
    return torch.sqrt(sum(torch.sum(leaf.float() ** 2) for leaf in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(grads, opt_state: dict, params, cfg: OptimizerConfig):
    """One AdamW step with global-norm clipping, written into ``params`` and
    ``opt_state``'s m and v; returns (params, opt_state, {"grad_norm", "lr"})."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.full((), cfg.grad_clip, dtype=torch.float32, device=gnorm.device)
    scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(step, cfg)
    b1c = 1.0 - torch.pow(cfg.b1, step.float())
    b2c = 1.0 - torch.pow(cfg.b2, step.float())
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(opt_state["m"]),
                          tree_leaves(opt_state["v"]), tree_leaves(params), strict=True):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    return params, {"m": opt_state["m"], "v": opt_state["v"], "step": step}, {
        "grad_norm": gnorm, "lr": lr}
