"""Decoder-only language model over the reference's block patterns (port of
``repro/models/transformer.py``; the ``attn_mlp`` and ``ssm`` blocks so far).

Where the reference groups the layers into superblocks stacked on a leading
axis and scans over them, the port keeps one parameter dict per layer in a
list, in the order the reference executes them: superblock 0's sub-blocks in
pattern order, then superblock 1, ..., then the tail.  Layer i is of kind
``layer_kinds(cfg)[i]``, and the cache list follows the same order.
Two entry points:
  prefill(params, batch, ...)               -> (logits_last, caches)
  decode_step(params, caches, token, pos)   -> (logits, caches)
``impl`` is passed to the kernel dispatch (``kernels/*/ops.py``): ``None``
on the main path, ``"ref"`` to run the plain versions for a comparison.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import layers, ssm
from repro_torch.models.attention import KVCacheSpec
from repro_torch.models.config import ModelConfig

_NOT_PORTED = {
    "attn_moe": "ROADMAP A5 (MoE and sliding windows)",
    "rglru_mlp": "ROADMAP A7 (hybrid and enc-dec families)",
}


# ---------------------------------------------------------------------------
# Block pattern handling
# ---------------------------------------------------------------------------

def block_pattern(cfg: ModelConfig) -> tuple[str, ...]:
    if cfg.arch_type == "dense":
        return ("attn_mlp",)
    if cfg.arch_type == "moe":
        return ("attn_moe",)
    if cfg.arch_type == "ssm":
        return ("ssm",)
    if cfg.arch_type == "hybrid":
        return tuple("attn_mlp" if b == "attn" else "rglru_mlp" for b in cfg.block_pattern)
    raise ValueError(cfg.arch_type)


def super_counts(cfg: ModelConfig) -> tuple[int, int]:
    """(full superblocks, remainder sub-blocks)."""
    p = len(block_pattern(cfg))
    return cfg.num_layers // p, cfg.num_layers % p


def layer_kinds(cfg: ModelConfig) -> list[str]:
    """The kind of every layer in execution order: the full superblocks, then
    the tail, whose i-th block is the pattern's i-th."""
    pat = block_pattern(cfg)
    n_super, rem = super_counts(cfg)
    return list(pat) * n_super + list(pat[:rem])


def _check_ported(kind: str) -> None:
    if kind in _NOT_PORTED:
        raise NotImplementedError(f"{kind!r} blocks are not ported yet; see {_NOT_PORTED[kind]}")


def _block_decls(kind: str, cfg: ModelConfig) -> dict:
    _check_ported(kind)
    if kind == "attn_mlp":
        return {
            "ln1": layers.rmsnorm_decls(cfg.d_model),
            "attn": attn.attention_decls(cfg),
            "ln2": layers.rmsnorm_decls(cfg.d_model),
            "mlp": layers.ffn_decls(cfg.d_model, cfg.d_ff, cfg.ffn_type),
        }
    if kind == "ssm":
        return {"ln1": layers.rmsnorm_decls(cfg.d_model), "ssm": ssm.ssm_decls(cfg)}
    raise ValueError(kind)


def model_decls(cfg: ModelConfig) -> dict:
    return {
        "embed": layers.embed_decls(cfg.padded_vocab, cfg.d_model, cfg.tie_embeddings),
        "final_norm": layers.rmsnorm_decls(cfg.d_model),
        "blocks": [_block_decls(kind, cfg) for kind in layer_kinds(cfg)],
    }


def _block_fwd(kind: str, x, p, cfg: ModelConfig, positions, impl):
    """Full-sequence forward of one block.  Returns (x, cache_seed): (k, v)
    for ``attn_mlp``, (conv_tail, final_state) for ``ssm``."""
    if kind == "attn_mlp":
        h, kv = attn.self_attention(
            layers.rms_norm(x, p["ln1"], cfg.norm_eps), p["attn"], cfg, positions,
            causal=True, window=cfg.sliding_window, impl=impl,
        )
        x = x + h
        y = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + layers.ffn(y, p["mlp"], cfg.ffn_type), kv
    if kind == "ssm":
        h, state = ssm.ssm_block(layers.rms_norm(x, p["ln1"], cfg.norm_eps), p["ssm"], cfg,
                                 impl=impl)
        return x + h, state
    raise ValueError(kind)


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


def _block_cache_decls(kind: str, cfg: ModelConfig, batch: int, spec: KVCacheSpec):
    _check_ported(kind)
    if kind == "attn_mlp":
        return attn.kv_cache_decls(cfg, batch, spec)
    if kind == "ssm":
        return ssm.ssm_cache_decls(cfg, batch)
    raise ValueError(kind)


def cache_decls(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    spec = cache_spec(cfg, max_len)
    return {"blocks": [_block_cache_decls(kind, cfg, batch, spec) for kind in layer_kinds(cfg)]}


def _seed_to_cache(kind: str, seed, spec: KVCacheSpec, s: int) -> dict:
    """Convert a full-sequence cache seed into the decode cache layout."""
    if kind == "ssm":
        conv_tail, h = seed
        return {"conv": conv_tail, "h": h.float()}

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
    for kind, p in zip(layer_kinds(cfg), params["blocks"], strict=True):
        x, seed = _block_fwd(kind, x, p, cfg, positions, impl)
        seeds.append(_seed_to_cache(kind, seed, spec, s))
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = layers.unembed(x[:, -1:], params["embed"])[:, 0]
    return logits, {"blocks": seeds}


def _block_decode(kind: str, x, cache, p, cfg: ModelConfig, pos: int, spec: KVCacheSpec,
                  impl):
    """One token through one block.  Returns (x, cache): an attention cache is
    updated in place, an ssm cache is replaced."""
    if kind == "attn_mlp":
        h, cache = attn.decode_self_attention(
            layers.rms_norm(x, p["ln1"], cfg.norm_eps), cache, p["attn"], cfg, pos, spec,
            impl=impl,
        )
        x = x + h
        x = x + layers.ffn(layers.rms_norm(x, p["ln2"], cfg.norm_eps), p["mlp"], cfg.ffn_type)
        return x, cache
    if kind == "ssm":  # the state carries the position: pos is not used
        h, cache = ssm.ssm_decode_step(layers.rms_norm(x, p["ln1"], cfg.norm_eps), cache,
                                       p["ssm"], cfg)
        return x + h, cache
    raise ValueError(kind)


def decode_step(params, caches, token, pos: int, cfg: ModelConfig, max_len: int, impl=None):
    """token (B,) int; pos: one position for every row -> (logits (B,V), caches).

    Attention caches are updated in place; the returned tree holds them and
    the new ssm caches.
    """
    spec = cache_spec(cfg, max_len)
    x = layers.embed(token[:, None], params["embed"])
    blocks = []
    for kind, p, cache in zip(layer_kinds(cfg), params["blocks"], caches["blocks"],
                              strict=True):
        x, cache = _block_decode(kind, x, cache, p, cfg, pos, spec, impl)
        blocks.append(cache)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = layers.unembed(x, params["embed"])
    return logits[:, 0], {"blocks": blocks}
