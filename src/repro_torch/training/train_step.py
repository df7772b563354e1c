"""The training step: loss -> grad -> clip -> AdamW (port of
``repro/training/train_step.py``)."""
from __future__ import annotations

from typing import Callable

import torch
from torch.profiler import record_function

from repro_torch.models.model import ModelApi
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.training.optimizer import OptimizerConfig, adamw_update


def loss_and_grads(api: ModelApi, params, batch, impl=None):
    """(loss, metrics, grads): ``api.train_loss`` at ``params`` and
    ``torch.autograd.grad`` of the loss over the parameter leaves, in
    ``tree_leaves`` order, inside the profiler range ``train_step.forward``
    for the forward."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    tracked = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        with record_function("train_step.forward"):
            loss, metrics = api.train_loss(tracked, batch, impl=impl)
        grads = torch.autograd.grad(loss, leaves)
    return loss, metrics, grads


def build_train_step(api: ModelApi, opt_cfg: OptimizerConfig, impl=None) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    The gradients are ``torch.autograd.grad`` of ``api.train_loss`` over the
    parameter leaves (on the card through flash attention's and the SSD
    scan's backward kernels).
    ``metrics`` holds loss, ce, aux, grad_norm and lr as device tensors: the
    step never waits for the host.  ``params`` and ``opt_state`` are updated
    in place (``adamw_update``).  The forward and the optimizer run inside
    the profiler ranges ``train_step.forward`` and ``train_step.optimizer``
    (the backward runs on autograd's own thread).
    """

    def train_step(params, opt_state, batch):
        loss, metrics, grads = loss_and_grads(api, params, batch, impl)
        with record_function("train_step.optimizer"):
            params, opt_state, stats = adamw_update(list(grads), opt_state, params, opt_cfg)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, {"loss": loss.detach(), **metrics, **stats}

    return train_step
