"""GQA attention block: projections + RoPE + kernel-dispatched core.

Port of ``repro/models/attention.py``: self-attention (train / prefill),
the enc-dec model's cross attention against K/V projected once from the
encoder's output, and one-token decode against a fixed-size or rolling KV
cache.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.placement_types import Replicate, Shard

from repro_torch.distributed.sharding import split_last
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import decl


def attention_decls(cfg: ModelConfig):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "w_q": decl((d, h * hd), ("embed", "heads")),
        "w_k": decl((d, kv * hd), ("embed", "kv")),
        "w_v": decl((d, kv * hd), ("embed", "kv")),
        "w_o": decl((h * hd, d), ("heads", "embed")),
    }


def _project_qkv(x, p, cfg: ModelConfig):
    b, s, _ = x.shape
    q = split_last(x @ p["w_q"], b, s, cfg.num_heads, cfg.head_dim)
    k = split_last(x @ p["w_k"], b, s, cfg.num_kv_heads, cfg.head_dim)
    v = split_last(x @ p["w_v"], b, s, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def _rope(x, positions, cfg: ModelConfig):
    if cfg.mrope:
        return layers.apply_mrope(x, positions, cfg.rope_theta)
    return layers.apply_rope(x, positions, cfg.rope_theta)


def self_attention(x, p, cfg: ModelConfig, positions, *, causal: bool = True,
                   window: int = 0, use_rope: bool = True, impl=None):
    """Full-sequence self-attention (train / prefill).

    Returns (out, (k, v)) so prefill can seed the decode cache.
    """
    q, k, v = _project_qkv(x, p, cfg)
    if use_rope:
        q = _rope(q, positions, cfg)
        k = _rope(k, positions, cfg)
    out = attn_ops.flash_attention(q, k, v, causal=causal, window=window, impl=impl)
    b, s, _, _ = q.shape
    out = out.reshape(b, s, cfg.num_heads * cfg.head_dim) @ p["w_o"]
    return out, (k, v)


def cross_attention(x, enc_kv, p, cfg: ModelConfig, impl=None):
    """Decoder-to-encoder attention, every query over every encoder frame;
    ``enc_kv`` = (k, v) from ``cross_kv``, computed once per request."""
    b, s, _ = x.shape
    q = split_last(x @ p["w_q"], b, s, cfg.num_heads, cfg.head_dim)
    k, v = enc_kv
    out = attn_ops.flash_attention(q, k, v, causal=False, impl=impl)
    return out.reshape(b, s, cfg.num_heads * cfg.head_dim) @ p["w_o"]


def cross_kv(enc_out, p, cfg: ModelConfig):
    b, s, _ = enc_out.shape
    k = split_last(enc_out @ p["w_k"], b, s, cfg.num_kv_heads, cfg.head_dim)
    v = split_last(enc_out @ p["w_v"], b, s, cfg.num_kv_heads, cfg.head_dim)
    return k, v


# ---------------------------------------------------------------------------
# Decode (one new token, KV cache)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KVCacheSpec:
    """Fixed-size cache; rolling when window > 0 (slot = pos % size)."""
    size: int
    window: int = 0


def kv_cache_decls(cfg: ModelConfig, batch: int, spec: KVCacheSpec):
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    axes = ("cache_batch", "kv_seq", "kv_heads", None)
    return {
        "k": decl((batch, spec.size, kv, hd), axes, init="zeros"),
        "v": decl((batch, spec.size, kv, hd), axes, init="zeros"),
    }


def decode_self_attention(x, cache, p, cfg: ModelConfig, pos: int, spec: KVCacheSpec, *,
                          use_rope: bool = True, positions3=None, impl=None):
    """One new token per row: x (B, 1, D), cache {"k","v"}: (B, S_cache, KV, Dh).

    ``pos`` is ONE position for every row, as in the reference: each row's
    new K/V is written at that slot and each row attends to ``pos + 1``
    entries.  The cache tensors are updated in place (the returned dict
    holds the same tensors).
    """
    b = x.shape[0]
    q, k, v = _project_qkv(x, p, cfg)
    if use_rope:
        if cfg.mrope:
            p3 = positions3 if positions3 is not None else torch.full(
                (b, 1, 3), pos, dtype=torch.int64, device=x.device)
            q = layers.apply_mrope(q, p3, cfg.rope_theta)
            k = layers.apply_mrope(k, p3, cfg.rope_theta)
        else:
            pos_b = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
            q = layers.apply_rope(q, pos_b, cfg.rope_theta)
            k = layers.apply_rope(k, pos_b, cfg.rope_theta)
    slot = pos % spec.size if spec.window > 0 else pos
    _update_cache(cache["k"], k[:, 0], slot)
    _update_cache(cache["v"], v[:, 0], slot)
    cache_len = min(pos + 1, spec.size)
    out = attn_ops.decode_attention(
        q[:, 0], cache["k"], cache["v"], cache_len,
        window=0 if spec.window == 0 else min(spec.window, spec.size), impl=impl,
    )
    out = out.reshape(b, 1, cfg.num_heads * cfg.head_dim) @ p["w_o"]
    return out, cache


def _update_cache(cache: torch.Tensor, new: torch.Tensor, slot: int) -> torch.Tensor:
    """cache (B,S,KV,Dh) <- new (B,KV,Dh) at position ``slot``, in place.

    Like ``lax.dynamic_update_slice``, a slot past the end is clamped to the
    last entry.  A DTensor cache is written shard by shard
    (``_update_sharded_cache``).
    """
    slot = min(max(int(slot), 0), cache.shape[1] - 1)
    if isinstance(cache, DTensor):
        return _update_sharded_cache(cache, new, slot)
    cache[:, slot].copy_(new)
    return cache


def _update_sharded_cache(cache: DTensor, new: DTensor, slot: int) -> DTensor:
    """The DTensor form of ``_update_cache``: ``new`` is laid out as the
    cache's row (batch and kv-head shards kept, replicated over the mesh
    dims that shard the slots), and each rank writes the slot into its own
    shard where the slot lies in it.  The cache is never gathered."""
    want = []
    for i, p in enumerate(cache.placements):
        if isinstance(p, Shard) and p.dim in (0, 2):
            want.append(Shard(0 if p.dim == 0 else 1))
        elif isinstance(p, Replicate) or (isinstance(p, Shard) and p.dim == 1):
            want.append(Replicate())
        else:
            raise ValueError(f"_update_cache: cache placement {p} on mesh dim {i}")
    if new.placements != tuple(want):
        new = new.redistribute(cache.device_mesh, want)
    mesh = cache.device_mesh
    coord = mesh.get_coordinate()
    local = cache.to_local()
    lo = 0
    for i, p in enumerate(cache.placements):  # the shard's first slot, row-major over dims
        if isinstance(p, Shard) and p.dim == 1:
            lo = lo * mesh.size(i) + coord[i]
    lo *= local.shape[1]
    if lo <= slot < lo + local.shape[1]:
        local[:, slot - lo].copy_(new.to_local())
    return cache
