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
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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
    logits = x.float() @ p["router"].float()
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)                   # (B,S,E)
    top_p, top_ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    top_p, top_ids = top_p[..., :k], top_ids[..., :k]                 # (B,S,K)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss.
    e = cfg.num_experts
    frac_routed = F.one_hot(top_ids, e).float().sum(2).mean((0, 1))  # f_e
    frac_prob = probs.mean((0, 1))                                    # p_e
    aux = e * torch.sum(frac_routed * frac_prob)
    return top_p, top_ids, aux


def _expert_ffn(inp, p, cfg: ModelConfig):
    """inp: (E, T, D) -> (E, T, D); SwiGLU batched over the experts."""
    gate = F.silu(torch.bmm(inp, p["w_gate"]))
    up = torch.bmm(inp, p["w_up"])
    return torch.bmm(gate * up, p["w_down"])


def moe_ffn(x: torch.Tensor, p, cfg: ModelConfig, *, capacity_factor: float = 1.25):
    """x: (B, S, D) -> (out, aux_loss).  The GShard capacity dispatch."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    c = capacity(s, cfg, capacity_factor)
    weights, ids, aux = _router(x, p, cfg)                            # (B,S,K)

    # Slot of each (token, k) in its expert's buffer: the number of earlier
    # routing slots, over the flattened (S, K) order, sent to that expert.
    flat = ids.reshape(b, s * k)
    onehot = F.one_hot(flat, e)                                       # (B,S*K,E)
    pos = (torch.cumsum(onehot, dim=1) - onehot).gather(2, flat[..., None])[..., 0]
    keep = pos < c
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
    return out.to(x.dtype), aux


# The reference's scatter/gather variant is the same computation (see the
# module docstring).
moe_ffn_grouped = moe_ffn
