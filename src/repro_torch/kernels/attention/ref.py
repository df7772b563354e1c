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
float32, probabilities cast to v's type before the value product.  Where
autograd records nothing (serving), the float32 logits are masked and
normalized in place (the values are the reference's): at a long prompt they
are the largest tensor, 8.6 GB for mixtral-8x7b's 32 heads at 8192 tokens.
Where it records (training), the softmax makes new tensors, with the same
values, so that its backward finds what it saved.

``flash_plain`` is the plain route of ``ops.flash_attention``: the banded
form where the reference's dispatch picks it, ``mha`` elsewhere.
``flash_lse``/``flash_plain_lse`` and ``flash_bwd_plain`` are the plain
versions of what the flash kernels add for training: the forward's
log-sum-exp and the backward from it (tests and ``chip_smoke.py`` only).
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


def _masked_softmax_(logits: torch.Tensor, mask: torch.Tensor, *, record: bool) -> torch.Tensor:
    """The reference's float32 softmax, exp(x - max) / sum, of ``logits``
    where ``mask`` holds and NEG_INF where it does not.  Computed in the
    float32 ``logits`` tensor itself unless autograd ``record``s the call:
    ``amax`` and ``exp`` keep what the in-place steps would overwrite, so
    then every step makes a new tensor.  The two forms run the same
    operations and give the same bits."""
    if record:
        x = logits.masked_fill(~mask, NEG_INF)
        e = (x - x.amax(dim=-1, keepdim=True)).exp()
        return e / e.sum(dim=-1, keepdim=True)
    logits.masked_fill_(~mask, NEG_INF)
    logits.sub_(logits.amax(dim=-1, keepdim=True)).exp_()
    return logits.div_(logits.sum(dim=-1, keepdim=True))


def records(*tensors) -> bool:
    """Whether autograd records an operation on ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _logits_f32(eq: str, q, k, d: int) -> torch.Tensor:
    """Scaled float32 logits of ``einsum(eq, q, k)`` in the inputs' common type."""
    ct = torch.promote_types(q.dtype, k.dtype)
    return torch.einsum(eq, q.to(ct), k.to(ct)).float().mul_(softmax_scale(d))


def mha(q, k, v, *, causal: bool = True, window: int = 0, q_offset: int = 0) -> torch.Tensor:
    """Reference multi-head (GQA) attention, float32 softmax."""
    b, s_q, h, d = q.shape
    s_kv, kv = k.shape[1], k.shape[2]
    g = h // kv
    logits = _logits_f32("bqngd,bknd->bngqk", q.reshape(b, s_q, kv, g, d), k, d)
    mask = attention_mask(s_q, s_kv, causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    probs = _masked_softmax_(logits, mask, record=records(q, k, v))
    out = torch.einsum("bngqk,bknd->bqngd", probs.to(v.dtype), v)
    return out.reshape(b, s_q, h, d).to(q.dtype)


def mha_banded(q, k, v, *, window: int) -> torch.Tensor:
    """Sliding-window causal attention computed banded (port of the
    reference's ``mha_banded``): with blocks of ``window`` queries, block c
    attends only to kv blocks c-1 and c, so the work is 2·W keys per query
    instead of S.  Equal to ``mha(causal=True, window=W)`` when S % W == 0;
    block 0's previous block is fully masked.

    The logits of a query block's two kv blocks are one product over 2·W
    keys (the previous block's first; each logit is the same dot product as
    in the reference's two), normalized together; the output is, as in the
    reference, one product per kv block, each rounded to v's type, added.
    """
    b, s, h, d = q.shape
    kv = k.shape[2]
    g, w = h // kv, window
    if w <= 0 or s % w:
        raise ValueError(f"mha_banded: S={s} is not a positive multiple of window={w}")
    nb = s // w

    def prev_and_cur(x):  # (B, S, KV, D) -> the blocks (B, NB, W, KV, D), c-1 and c
        xb = x.reshape(b, nb, w, kv, d)
        return torch.cat([torch.zeros_like(xb[:, :1]), xb[:, :-1]], dim=1), xb

    logits = _logits_f32("bcqngd,bcknd->bcngqk", q.reshape(b, nb, w, kv, g, d),
                         torch.cat(prev_and_cur(k), dim=2), d)  # (B,NB,KV,G,W,2W)
    qi = torch.arange(w, device=q.device)[:, None]
    kj = torch.arange(w, device=q.device)[None, :]
    # previous block: k_pos = kj + (c-1)w, q_pos = qi + cw -> k > q - w <=> kj > qi;
    # current block: causal (k > q - w holds within a block)
    mask = torch.cat([kj > qi, kj <= qi], dim=1)[None].repeat(nb, 1, 1)
    mask[0, :, :w] = False
    probs = _masked_softmax_(logits, mask[None, :, None, None], record=records(q, k, v))
    p_prev, p_cur = probs.to(v.dtype).split(w, -1)
    v_prev, v_cur = prev_and_cur(v)
    out = torch.einsum("bcngqk,bcknd->bcqngd", p_cur, v_cur)
    out = out + torch.einsum("bcngqk,bcknd->bcqngd", p_prev, v_prev)
    return out.reshape(b, s, h, d).to(q.dtype)


def uses_banded(s_q: int, s_kv: int, *, causal: bool, window: int, q_offset: int) -> bool:
    """Where the plain route computes ``mha_banded``: the reference's rule
    (``repro/kernels/attention/ops.py:29``)."""
    return (causal and window > 0 and q_offset == 0 and s_q == s_kv
            and s_q % window == 0 and s_q >= 2 * window)


def flash_plain(q, k, v, *, causal: bool = True, window: int = 0,
                q_offset: int = 0) -> torch.Tensor:
    """The plain version of flash attention: banded where ``uses_banded``
    holds (2·W work per query instead of S), else ``mha``."""
    if uses_banded(q.shape[1], k.shape[1], causal=causal, window=window, q_offset=q_offset):
        return mha_banded(q, k, v, window=window)
    return mha(q, k, v, causal=causal, window=window, q_offset=q_offset)


def flash_lse(q, k, *, causal: bool = True, window: int = 0, q_offset: int = 0) -> torch.Tensor:
    """The float32 log-sum-exp of each query row's visible scaled logits,
    (B, H, S_q), natural log; -inf for a row that sees no key."""
    b, s_q, h, d = q.shape
    s_kv, kv = k.shape[1], k.shape[2]
    logits = _logits_f32("bqngd,bknd->bngqk", q.reshape(b, s_q, kv, h // kv, d), k, d)
    mask = attention_mask(s_q, s_kv, causal=causal, window=window, q_offset=q_offset,
                          device=q.device)
    return torch.logsumexp(logits.masked_fill_(~mask, -torch.inf), dim=-1).reshape(b, h, s_q)


def flash_plain_lse(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """``flash_plain``'s output and ``flash_lse``: what the kernel's forward
    returns for its backward."""
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    return flash_plain(q, k, v, **kw), flash_lse(q, k, **kw)


def flash_bwd_plain(q, k, v, out, lse, dout, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq, dk, dv of attention from the forward's output and log-sum-exp
    (``flash_lse``), computed tile-free in float32 and returned in the
    inputs' dtypes: P = exp(S·scale − lse), dV = Pᵀ·dO, dP = dO·Vᵀ,
    Δ = rowsum(dO ∘ O), dS = P ∘ (dP − Δ), dQ = dS·K·scale, dK = dSᵀ·Q·scale.
    The backward kernel computes the same, tile by tile."""
    b, s_q, h, d = q.shape
    s_kv, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = softmax_scale(d)
    qf, kf, vf = q.float().reshape(b, s_q, kv, g, d), k.float(), v.float()
    dof = dout.float().reshape(b, s_q, kv, g, d)
    mask = attention_mask(s_q, s_kv, causal=causal, window=window, q_offset=q_offset,
                          device=q.device)
    s = torch.einsum("bqngd,bknd->bngqk", qf, kf).mul_(scale)
    # A row with no visible key (lse = -inf) gets P = 0, as masked entries do.
    lse_f = lse.float().reshape(b, kv, g, s_q, 1)
    p = s.sub_(lse_f.masked_fill(torch.isinf(lse_f), 0.0)).exp_().masked_fill_(~mask, 0.0)
    dv = torch.einsum("bngqk,bqngd->bknd", p, dof)
    delta = (dout.float() * out.float()).sum(-1).reshape(b, s_q, kv, g).permute(0, 2, 3, 1)
    ds = torch.einsum("bqngd,bknd->bngqk", dof, vf).sub_(delta[..., None]).mul_(p)
    dq = torch.einsum("bngqk,bknd->bqngd", ds, kf).mul_(scale).reshape(b, s_q, h, d)
    dk = torch.einsum("bngqk,bqngd->bknd", ds, qf).mul_(scale)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def decode_gqa(q, k_cache, v_cache, cache_len, *, window: int = 0, slot_offset: int = 0,
               return_lse: bool = False):
    """One-token decode attention against a (possibly rolling) KV cache.

    q: (B, H, D); caches: (B, S_max, KV, D); cache_len: int, () or (B,)
    number of valid entries.  Masking uses entry validity only — relative
    order is irrelevant to softmax(QKᵀ)V.  ``slot_offset`` is the global
    slot of the cache's entry 0 (a shard of a sequence-sharded cache): an
    entry is valid by its global slot.  With ``return_lse`` also the
    float32 log-sum-exp of each row's valid logits, (B, H), -inf for a row
    with no valid entry (whose output is then not defined).
    """
    b, h, d = q.shape
    s_max, kv = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    logits = _logits_f32("bngd,bknd->bngk", q.reshape(b, kv, g, d), k_cache, d)
    if isinstance(cache_len, int):  # a fill on the device, no host-to-device copy
        cache_len = torch.full((b,), cache_len, device=q.device)
    else:
        cache_len = torch.as_tensor(cache_len, device=q.device)
        if cache_len.ndim == 0:
            cache_len = cache_len.expand(b)
    pos = torch.arange(s_max, device=q.device)[None, :]
    if slot_offset:
        pos = pos + slot_offset
    valid = pos < cache_len[:, None]
    if window > 0:
        valid &= pos >= (cache_len[:, None] - window)
    mask = valid[:, None, None, :]
    lse = (torch.logsumexp(logits.masked_fill(~mask, -torch.inf), dim=-1).reshape(b, h)
           if return_lse else None)
    probs = _masked_softmax_(logits, mask, record=records(q, k_cache, v_cache))
    out = torch.einsum("bngk,bknd->bngd", probs.to(v_cache.dtype), v_cache)
    out = out.reshape(b, h, d).to(q.dtype)
    return (out, lse) if return_lse else out


def merge_decode_shards(out, lse, all_reduce):
    """Flash-decoding merge of the partial decodes of one cache's slot
    shards: ``out`` (B, H, D) and ``lse`` (B, H) of this shard,
    ``all_reduce(t, op)`` reducing over the shards (``"max"``, ``"sum"``).
    One all-reduce of the max, then one of the rescaled sum and output
    together: B·H·(D + 2)·4 bytes.  Returns the whole cache's (out in
    ``out``'s dtype, lse), a row with no valid entry anywhere as zeros."""
    d = out.shape[-1]
    m = all_reduce(lse, "max")
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    w = torch.exp(lse - m)
    packed = torch.cat([out.float() * w[..., None], w[..., None]], dim=-1)
    packed = all_reduce(packed, "sum")
    num, den = packed[..., :d], packed[..., d]
    merged = (num / den.clamp_min(1e-30)[..., None]).to(out.dtype)
    return merged, m + torch.log(den)
