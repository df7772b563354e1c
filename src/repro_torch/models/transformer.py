"""Decoder-only dense transformer (port of the ``attn_mlp`` path of
``repro/models/transformer.py``).

Where the reference stacks the layers on a leading axis and scans over it,
the port keeps one parameter dict per layer in a list and loops in Python.
Two entry points:
  prefill(params, batch, ...)               -> (logits_last, caches)
  decode_step(params, caches, token, pos)   -> (logits, caches)
``impl`` is passed to the attention dispatch (``kernels/attention/ops.py``):
``None`` on the main path, ``"ref"`` to run the plain attention for a
comparison.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models.attention import KVCacheSpec
from repro_torch.models.config import ModelConfig


def _block_decls(cfg: ModelConfig) -> dict:
    return {
        "ln1": layers.rmsnorm_decls(cfg.d_model),
        "attn": attn.attention_decls(cfg),
        "ln2": layers.rmsnorm_decls(cfg.d_model),
        "mlp": layers.ffn_decls(cfg.d_model, cfg.d_ff, cfg.ffn_type),
    }


def model_decls(cfg: ModelConfig) -> dict:
    return {
        "embed": layers.embed_decls(cfg.padded_vocab, cfg.d_model, cfg.tie_embeddings),
        "final_norm": layers.rmsnorm_decls(cfg.d_model),
        "blocks": [_block_decls(cfg) for _ in range(cfg.num_layers)],
    }


def _block_fwd(x, p, cfg: ModelConfig, positions, impl):
    """Full-sequence forward of one ``attn_mlp`` block.  Returns (x, (k, v))."""
    h, kv = attn.self_attention(
        layers.rms_norm(x, p["ln1"], cfg.norm_eps), p["attn"], cfg, positions,
        causal=True, window=cfg.sliding_window, impl=impl,
    )
    x = x + h
    y = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + layers.ffn(y, p["mlp"], cfg.ffn_type), kv


# ---------------------------------------------------------------------------
# Frontend (VLM stub): precomputed patch embeddings overwrite the first
# `frontend_tokens` positions of the token embedding sequence.
# ---------------------------------------------------------------------------

def _apply_frontend(x, batch):
    fe = batch.get("frontend_embeds")
    if fe is None:
        return x
    return torch.cat([fe.to(x.dtype), x[:, fe.shape[1]:]], dim=1)


def _positions(batch, cfg: ModelConfig, b: int, s: int, device):
    if cfg.mrope:
        p3 = batch.get("positions3")
        if p3 is None:
            base = torch.arange(s, dtype=torch.int64, device=device)[None, :, None]
            p3 = base.expand(b, s, 3)
        return p3
    return torch.arange(s, dtype=torch.int64, device=device)[None].expand(b, s)


# -- caches ------------------------------------------------------------------

def cache_spec(cfg: ModelConfig, max_len: int) -> KVCacheSpec:
    window = cfg.sliding_window or (cfg.attention_window if cfg.arch_type == "hybrid" else 0)
    if window:
        return KVCacheSpec(size=min(window, max_len), window=window)
    return KVCacheSpec(size=max_len, window=0)


def cache_decls(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    spec = cache_spec(cfg, max_len)
    return {"blocks": [attn.kv_cache_decls(cfg, batch, spec) for _ in range(cfg.num_layers)]}


def _seed_to_cache(seed, spec: KVCacheSpec, s: int) -> dict:
    """Convert a full-sequence (k, v) into the decode cache layout."""

    def to_cache(x):  # (B, S, KV, Dh)
        if s >= spec.size:
            x = x[:, s - spec.size:s]
            if spec.window > 0:  # rolling layout: token t lives at t % size
                x = torch.roll(x, s % spec.size, dims=1)
            return x.contiguous()
        pad = x.new_zeros((x.shape[0], spec.size - s, *x.shape[2:]))
        return torch.cat([x, pad], dim=1)

    k, v = seed
    return {"k": to_cache(k), "v": to_cache(v)}


# -- entry points ------------------------------------------------------------

def prefill(params, batch, cfg: ModelConfig, max_len: int, impl=None):
    """Full-sequence forward that also builds decode caches.

    Returns (logits_last (B, V), caches).
    """
    tokens = batch["tokens"]
    b, s = tokens.shape
    spec = cache_spec(cfg, max_len)
    x = layers.embed(tokens, params["embed"])
    x = _apply_frontend(x, batch)
    positions = _positions(batch, cfg, b, s, x.device)
    seeds = []
    for p in params["blocks"]:
        x, kv = _block_fwd(x, p, cfg, positions, impl)
        seeds.append(_seed_to_cache(kv, spec, s))
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = layers.unembed(x[:, -1:], params["embed"])[:, 0]
    return logits, {"blocks": seeds}


def decode_step(params, caches, token, pos: int, cfg: ModelConfig, max_len: int, impl=None):
    """token (B,) int; pos: one position for every row -> (logits (B,V), caches).

    The caches are updated in place.
    """
    spec = cache_spec(cfg, max_len)
    x = layers.embed(token[:, None], params["embed"])
    for p, cache in zip(params["blocks"], caches["blocks"]):
        h, _ = attn.decode_self_attention(
            layers.rms_norm(x, p["ln1"], cfg.norm_eps), cache, p["attn"], cfg, pos, spec,
            impl=impl,
        )
        x = x + h
        x = x + layers.ffn(layers.rms_norm(x, p["ln2"], cfg.norm_eps), p["mlp"], cfg.ffn_type)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = layers.unembed(x, params["embed"])
    return logits[:, 0], caches
