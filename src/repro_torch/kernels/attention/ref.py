"""Plain PyTorch versions of the attention kernels (port of ``repro/kernels/attention/ref.py``).

Shapes (GQA throughout):
  q:      (B, S_q, H, D)
  k, v:   (B, S_kv, KV, D)   with H % KV == 0
Decode:
  q:      (B, H, D)          one new token
  cache:  (B, S_max, KV, D)

``window > 0`` = sliding-window causal attention.  ``causal=False,
window=0`` = bidirectional (encoder) or cross attention.  GQA is a grouped
einsum (q reshaped to (B,S,KV,G,D)); K/V are never repeated.  The rounding
points follow the reference: logits in the inputs' common type, softmax in
float32, probabilities cast to v's type before the value product.
"""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30


def softmax_scale(d: int) -> float:
    """1/√d rounded as the reference rounds it (float32 sqrt, float32 divide)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def attention_mask(s_q: int, s_kv: int, *, causal: bool, window: int = 0,
                   q_offset: int = 0, device=None) -> torch.Tensor:
    """(S_q, S_kv) boolean mask; True = attend."""
    q_pos = torch.arange(s_q, device=device)[:, None] + q_offset
    k_pos = torch.arange(s_kv, device=device)[None, :]
    mask = torch.ones((s_q, s_kv), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    return mask


def _softmax_f32(logits: torch.Tensor) -> torch.Tensor:
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return probs / probs.sum(dim=-1, keepdim=True)


def mha(q, k, v, *, causal: bool = True, window: int = 0, q_offset: int = 0) -> torch.Tensor:
    """Reference multi-head (GQA) attention, float32 softmax."""
    b, s_q, h, d = q.shape
    s_kv, kv = k.shape[1], k.shape[2]
    g = h // kv
    ct = torch.promote_types(q.dtype, k.dtype)
    qg = q.reshape(b, s_q, kv, g, d).to(ct)
    logits = torch.einsum("bqngd,bknd->bngqk", qg, k.to(ct)).float() * softmax_scale(d)
    mask = attention_mask(s_q, s_kv, causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    logits = torch.where(mask[None, None, None], logits, torch.full_like(logits, NEG_INF))
    probs = _softmax_f32(logits)
    out = torch.einsum("bngqk,bknd->bqngd", probs.to(v.dtype), v)
    return out.reshape(b, s_q, h, d).to(q.dtype)


def decode_gqa(q, k_cache, v_cache, cache_len, *, window: int = 0) -> torch.Tensor:
    """One-token decode attention against a (possibly rolling) KV cache.

    q: (B, H, D); caches: (B, S_max, KV, D); cache_len: int, () or (B,)
    number of valid entries.  Masking uses entry validity only — relative
    order is irrelevant to softmax(QKᵀ)V.
    """
    b, h, d = q.shape
    s_max, kv = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    ct = torch.promote_types(q.dtype, k_cache.dtype)
    qg = q.reshape(b, kv, g, d).to(ct)
    logits = torch.einsum("bngd,bknd->bngk", qg, k_cache.to(ct)).float() * softmax_scale(d)
    if isinstance(cache_len, int):  # a fill on the device, no host-to-device copy
        cache_len = torch.full((b,), cache_len, device=q.device)
    else:
        cache_len = torch.as_tensor(cache_len, device=q.device)
        if cache_len.ndim == 0:
            cache_len = cache_len.expand(b)
    pos = torch.arange(s_max, device=q.device)[None, :]
    valid = pos < cache_len[:, None]
    if window > 0:
        valid &= pos >= (cache_len[:, None] - window)
    logits = torch.where(valid[:, None, None, :], logits, torch.full_like(logits, NEG_INF))
    probs = _softmax_f32(logits)
    out = torch.einsum("bngk,bknd->bngd", probs.to(v_cache.dtype), v_cache)
    return out.reshape(b, h, d).to(q.dtype)
