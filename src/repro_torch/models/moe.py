"""Mixture-of-Experts FFN with top-k routing (Mixtral / Granite-MoE); port of
``repro/models/moe.py``.

The reference's capacity rule is kept bit for bit: tokens are routed to
``experts_per_token`` experts; each expert takes at most ``capacity(S)``
tokens per example, filled in the order of the flattened (S, K) routing
slots (token major, slot minor); a routing slot past its expert's capacity
is dropped and its token keeps only the residual path (and its other
slots).

Dispatch and combine are computed by indices, never by the reference's
one-hot ``(B, S, E, C)`` products: at mixtral-8x7b's widths and an 8192-token
prompt (C = 2560) each one-hot float32 tensor takes 671 MB and its products
B·S·E·C·D multiply-adds, all by zeros and ones.  Those products are exact,
so the index form gives the one-hot form's values up to the order in which
a token's K weighted expert outputs are summed in float32.  The reference's
two forms (``moe_ffn``, the one-hot GShard dispatch, and
``moe_ffn_grouped``, its scatter/gather variant) are therefore one
computation here, and ``cfg.moe_impl`` selects nothing.

The router runs in float32 (``x.float() @ router.float()``); on the card that
holds only while TF32 is off for matmuls, which the port never turns on.
Router load balancing follows Switch Transformer: aux = E · Σ_e f_e·p_e.

Under a mesh (DTensor operands) the FFN runs batch-local (``_sharded``):
the capacity is per example, so each device routes its own rows and drops
what the whole batch would.  Its expert weights may be sharded on the
experts (``*_ep`` rules) or on the FFN dim over the other axes; each device
then sums its own experts' or FFN columns' share, a pending sum the block's
residual reduces.  f_e and p_e are averaged over the batch shards before
the aux loss is formed.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.placement_types import Partial, Replicate, Shard

from repro_torch.models.config import ModelConfig
from repro_torch.models.params import decl


def moe_decls(cfg: ModelConfig):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": decl((d, e), ("embed", "experts")),
        "w_gate": decl((e, d, f), ("experts", "embed", "ffn")),
        "w_up": decl((e, d, f), ("experts", "embed", "ffn")),
        "w_down": decl((e, f, d), ("experts", "ffn", "embed")),
    }


def capacity(tokens_per_example: int, cfg: ModelConfig, factor: float = 1.25) -> int:
    """Slots per expert and example: ceil(S·k/E·factor), padded to a multiple
    of 8 and at least 8, in the reference's Python float arithmetic."""
    cap = math.ceil(tokens_per_example * cfg.experts_per_token / cfg.num_experts * factor)
    return max(8, -(-cap // 8) * 8)


def _router(x, p, cfg: ModelConfig):
    """Top-k routing probabilities; returns (weights, expert_ids, aux_loss).

    Among equal probabilities the lower expert index comes first, as in
    ``jax.lax.top_k``: a stable descending sort, then the first k.
    """
    top_p, top_ids, frac_routed, frac_prob = _route(x, p, cfg)
    return top_p, top_ids, cfg.num_experts * torch.sum(frac_routed * frac_prob)


def _route(x, p, cfg: ModelConfig):
    """``_router``'s weights and ids, and the aux loss's f_e and p_e."""
    logits = x.float() @ p["router"].float()
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)                   # (B,S,E)
    top_p, top_ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    top_p, top_ids = top_p[..., :k], top_ids[..., :k]                 # (B,S,K)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss.
    frac_routed = F.one_hot(top_ids, cfg.num_experts).float().sum(2).mean((0, 1))  # f_e
    frac_prob = probs.mean((0, 1))                                    # p_e
    return top_p, top_ids, frac_routed, frac_prob


def _expert_ffn(inp, p, cfg: ModelConfig):
    """inp: (E, T, D) -> (E, T, D); SwiGLU batched over the experts."""
    gate = F.silu(torch.bmm(inp, p["w_gate"]))
    up = torch.bmm(inp, p["w_up"])
    return torch.bmm(gate * up, p["w_down"])


def moe_ffn(x: torch.Tensor, p, cfg: ModelConfig, *, capacity_factor: float = 1.25):
    """x: (B, S, D) -> (out, aux_loss).  The GShard capacity dispatch."""
    if isinstance(x, DTensor):
        return _sharded(x, p, cfg, capacity_factor)
    weights, ids, aux = _router(x, p, cfg)                            # (B,S,K)
    return _dispatch(x, weights, ids, p, cfg, capacity_factor), aux


def _dispatch(x, weights, ids, p, cfg: ModelConfig, capacity_factor: float,
              experts: tuple[int, int] | None = None):
    """The routed slots of x through the experts and back, weighted: (B, S,
    D).  With ``experts`` = [lo, hi) only those experts' slots (the local
    experts of an expert shard, whose weights ``p`` holds); the others
    contribute nothing here."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    c = capacity(s, cfg, capacity_factor)

    # Slot of each (token, k) in its expert's buffer: the number of earlier
    # routing slots, over the flattened (S, K) order, sent to that expert.
    flat = ids.reshape(b, s * k)
    onehot = F.one_hot(flat, e)                                       # (B,S*K,E)
    pos = (torch.cumsum(onehot, dim=1) - onehot).gather(2, flat[..., None])[..., 0]
    keep = pos < c
    if experts is not None:  # another shard's experts: dropped here
        keep = keep & (flat >= experts[0]) & (flat < experts[1])
        flat, e = torch.clamp(flat - experts[0], 0, experts[1] - experts[0] - 1), \
            experts[1] - experts[0]
    slot = torch.where(keep, pos, c)  # slot c of every expert takes the drops

    # Scatter the tokens into (B, E, C+1, D) buffers in the model's dtype:
    # each slot below C is written once, so nothing accumulates.
    bidx = torch.arange(b, device=x.device)[:, None].expand(b, s * k)
    src = x[:, :, None, :].expand(b, s, k, d).reshape(b, s * k, d)
    buf = x.new_zeros((b, e, c + 1, d))
    buf[bidx, flat, slot] = src
    expert_in = buf[:, :, :c].transpose(0, 1).reshape(e, b * c, d)
    expert_out = _expert_ffn(expert_in, p, cfg).reshape(e, b, c, d).transpose(0, 1)

    # Gather each routing slot's output back and weight it (a drop weighs 0).
    gathered = expert_out[bidx, flat, torch.clamp(slot, max=c - 1)].float()
    combine = (weights * keep.reshape(b, s, k)).reshape(b, s * k, 1)
    out = (gathered * combine).reshape(b, s, k, d).sum(2)
    return out.to(x.dtype)


def _sharded(x, p, cfg: ModelConfig, capacity_factor: float):
    """The DTensor route: x batch-sharded (any other shard or pending sum of
    x gathered or reduced first), the router replicated, each expert weight
    sharded on its experts or its FFN dim on the mesh dims that do not
    shard the batch (gathered there otherwise).  Returns out with a pending
    sum over the weight-sharded dims, and the aux loss."""
    from repro_torch.kernels._common import partial_on, shard_index, sharded_call

    mesh = x.device_mesh
    batch = [i for i, q in enumerate(x.placements) if isinstance(q, Shard) and q.dim == 0]
    x_pl = tuple(Shard(0) if i in batch else Replicate() for i in range(mesh.ndim))
    if tuple(x.placements) != x_pl:
        x = x.redistribute(mesh, x_pl)
    ffn_dim = {"w_gate": 2, "w_up": 2, "w_down": 1}
    names = ("w_gate", "w_up", "w_down")
    w_pl, expert_dims, ffn_dims = {}, set(), set()
    for name in names:
        pl = []
        for i, q in enumerate(p[name].placements):
            keep = isinstance(q, Shard) and i not in batch and q.dim in (0, ffn_dim[name])
            pl.append(q if keep else Replicate())
            if keep:
                (expert_dims if q.dim == 0 else ffn_dims).add(i)
        w_pl[name] = tuple(pl)
    if expert_dims & ffn_dims:
        raise ValueError(f"moe: experts and FFN dims sharded on one mesh dim: "
                         f"{[p[n].placements for n in names]}")
    for name in names:
        want = tuple(Shard(0) if i in expert_dims else
                     (Shard(ffn_dim[name]) if i in ffn_dims else Replicate())
                     for i in range(mesh.ndim))
        if w_pl[name] != want:
            raise ValueError(f"moe: {name} {p[name].placements}; the experts share one layout "
                             f"{want}")
    experts = None
    if expert_dims:
        n, r = shard_index(mesh, sorted(expert_dims))
        per = cfg.num_experts // n
        experts = (r * per, (r + 1) * per)
    router = p["router"]
    r_pl = (Replicate(),) * mesh.ndim
    if tuple(router.placements) != r_pl:
        router = router.redistribute(mesh, r_pl)
    weights = {name: p[name] if tuple(p[name].placements) == w_pl[name]
               else p[name].redistribute(mesh, w_pl[name]) for name in names}

    summed = expert_dims | ffn_dims
    out_pl = tuple(Shard(0) if i in batch else (Partial() if i in summed else Replicate())
                   for i in range(mesh.ndim))
    mean_pl = tuple(Partial("avg") if i in batch else Replicate() for i in range(mesh.ndim))

    # Route every local row (the gradients of x and the router are partial
    # over the dims that split the weights, the router's over the batch too),
    # form the aux loss from the batch means, then dispatch to the local
    # experts or FFN columns (the weights' gradients partial over the batch).
    top_p, ids, frac_routed, frac_prob = sharded_call(
        lambda xl, rl: _route(xl, {"router": rl}, cfg), (x, router), (x_pl, r_pl),
        [x_pl, x_pl, mean_pl, mean_pl],
        (partial_on(x_pl, summed), partial_on(r_pl, summed | set(batch))))
    aux = cfg.num_experts * torch.sum(frac_routed * frac_prob)
    del frac_routed, frac_prob  # freed before the dispatch, as in ``_router``

    def local(xl, top_pl, idl, wg, wu, wd):
        return _dispatch(xl, top_pl, idl, {"w_gate": wg, "w_up": wu, "w_down": wd}, cfg,
                         capacity_factor, experts)

    out = sharded_call(
        local, (x, top_p, ids, *(weights[n] for n in names)),
        (x_pl, x_pl, x_pl, *(w_pl[n] for n in names)), [out_pl],
        (partial_on(x_pl, summed), partial_on(x_pl, summed), x_pl,
         *(partial_on(w_pl[n], batch) for n in names)))
    return out, aux


# The reference's scatter/gather variant is the same computation (see the
# module docstring).
moe_ffn_grouped = moe_ffn
