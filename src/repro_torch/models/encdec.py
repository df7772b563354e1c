"""Encoder-decoder transformer (SeamlessM4T v2 text/speech backbone,
arXiv:2308.11596); port of ``repro/models/encdec.py``.

The audio frontend is a stub, as in the reference: the encoder consumes
precomputed frame embeddings (B, S_enc, d_model).  Encoder blocks are
bidirectional self-attention + FFN; decoder blocks add causal
self-attention with a KV cache plus cross attention against the encoder's
output, whose K/V are projected once per request and kept in the cache.
``forward_train`` is the training loss, each block recomputed in the
backward under ``cfg.remat`` as the reference's ``jax.checkpoint`` does.
Every attention goes through the kernel dispatch: the encoder and the
cross attention as flash attention with ``causal=False`` (at S_q = 1 in
decode), the decoder's self-attention as flash in the prompt and as the
decode kernel over its cache.

Where the reference stacks the layers on a leading axis and scans, the port
keeps one parameter dict per layer in ``enc_blocks`` and ``dec_blocks``, and
one cache entry per decoder layer in each of ``self``, ``cross_k`` and
``cross_v``.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import constrain, gather_weights
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models.attention import KVCacheSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import decl
from repro_torch.models.transformer import rematerialized


def _enc_block_decls(cfg: ModelConfig):
    return {
        "ln1": layers.rmsnorm_decls(cfg.d_model),
        "attn": attn.attention_decls(cfg),
        "ln2": layers.rmsnorm_decls(cfg.d_model),
        "mlp": layers.ffn_decls(cfg.d_model, cfg.d_ff, cfg.ffn_type),
    }


def _dec_block_decls(cfg: ModelConfig):
    return {
        "ln1": layers.rmsnorm_decls(cfg.d_model),
        "self_attn": attn.attention_decls(cfg),
        "ln_x": layers.rmsnorm_decls(cfg.d_model),
        "cross_attn": attn.attention_decls(cfg),
        "ln2": layers.rmsnorm_decls(cfg.d_model),
        "mlp": layers.ffn_decls(cfg.d_model, cfg.d_ff, cfg.ffn_type),
    }


def model_decls(cfg: ModelConfig) -> dict:
    return {
        "embed": layers.embed_decls(cfg.padded_vocab, cfg.d_model, cfg.tie_embeddings),
        "enc_blocks": [_enc_block_decls(cfg) for _ in range(cfg.encoder_layers)],
        "enc_norm": layers.rmsnorm_decls(cfg.d_model),
        "dec_blocks": [_dec_block_decls(cfg) for _ in range(cfg.num_layers)],
        "final_norm": layers.rmsnorm_decls(cfg.d_model),
    }


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int64, device=device)[None].expand(b, s)


def encode(params, frame_embeds: torch.Tensor, cfg: ModelConfig, impl=None) -> torch.Tensor:
    """frame_embeds (B, S_enc, D) -> encoder output (B, S_enc, D).  In a
    training forward each block is rematerialized under ``cfg.remat``."""
    b, s, _ = frame_embeds.shape
    positions = _positions(b, s, frame_embeds.device)

    def block(x, p):
        p = gather_weights(p)
        h, _ = attn.self_attention(layers.rms_norm(x, p["ln1"], cfg.norm_eps), p["attn"], cfg,
                                   positions, causal=False, impl=impl)
        x = constrain(x + h)
        return constrain(x + layers.ffn(layers.rms_norm(x, p["ln2"], cfg.norm_eps), p["mlp"],
                                        cfg.ffn_type))

    x = constrain(frame_embeds.to(params["enc_norm"]["scale"].dtype))
    for p in params["enc_blocks"]:
        x = rematerialized(block, cfg)(x, p)
    return layers.rms_norm(x, gather_weights(params["enc_norm"]), cfg.norm_eps)


def _dec_block(x, enc_out, p, cfg: ModelConfig, positions, impl):
    """One decoder block over the whole sequence: (x, (k, v), (cross k, v))."""
    p = gather_weights(p)
    h, kv = attn.self_attention(layers.rms_norm(x, p["ln1"], cfg.norm_eps), p["self_attn"],
                                cfg, positions, causal=True, impl=impl)
    x = constrain(x + h)
    ckv = attn.cross_kv(enc_out, p["cross_attn"], cfg)
    x = constrain(x + attn.cross_attention(layers.rms_norm(x, p["ln_x"], cfg.norm_eps), ckv,
                                           p["cross_attn"], cfg, impl=impl))
    x = x + layers.ffn(layers.rms_norm(x, p["ln2"], cfg.norm_eps), p["mlp"], cfg.ffn_type)
    return constrain(x), kv, ckv


def forward_train(params, batch, cfg: ModelConfig, aux_weight: float = 0.0, impl=None):
    """batch: frontend_embeds (B, S_enc, D), tokens (B, S_dec), labels ->
    (loss, {"ce", "aux"}); the family has no aux loss.  Each decoder block is
    rematerialized under ``cfg.remat``."""
    enc_out = encode(params, batch["frontend_embeds"], cfg, impl)
    tokens = batch["tokens"]
    b, s = tokens.shape
    emb = gather_weights(params["embed"])
    x = constrain(layers.embed(tokens, emb))
    positions = _positions(b, s, x.device)
    block = rematerialized(lambda xx, eo, p: _dec_block(xx, eo, p, cfg, positions, impl)[0],
                           cfg)
    for p in params["dec_blocks"]:
        x = block(x, enc_out, p)
    x = layers.rms_norm(x, gather_weights(params["final_norm"]), cfg.norm_eps)
    loss = layers.cross_entropy_loss(layers.unembed(x, emb), batch["labels"])
    return loss, {"ce": loss, "aux": torch.zeros((), dtype=torch.float32, device=x.device)}


def cache_decls(cfg: ModelConfig, batch: int, max_len: int, enc_len: int) -> dict:
    spec = KVCacheSpec(size=max_len)
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    axes = ("cache_batch", "kv_seq", "kv_heads", None)
    return {
        "self": [attn.kv_cache_decls(cfg, batch, spec) for _ in range(cfg.num_layers)],
        "cross_k": [decl((batch, enc_len, kv, hd), axes, init="zeros")
                    for _ in range(cfg.num_layers)],
        "cross_v": [decl((batch, enc_len, kv, hd), axes, init="zeros")
                    for _ in range(cfg.num_layers)],
    }


def _pad_to(x: torch.Tensor, size: int) -> torch.Tensor:
    """(B, S, KV, Dh) -> (B, size, KV, Dh), zeros after the S entries."""
    return torch.cat([x, x.new_zeros((x.shape[0], size - x.shape[1], *x.shape[2:]))], dim=1)


def prefill(params, batch, cfg: ModelConfig, max_len: int, impl=None):
    """Encoder pass + decoder prompt pass; returns (logits_last (B, V), caches)."""
    enc_out = encode(params, batch["frontend_embeds"], cfg, impl)
    tokens = batch["tokens"]
    b, s = tokens.shape
    emb = gather_weights(params["embed"])
    x = constrain(layers.embed(tokens, emb))
    positions = _positions(b, s, x.device)
    caches = {"self": [], "cross_k": [], "cross_v": []}
    for p in params["dec_blocks"]:
        x, (k, v), (ck, cv) = _dec_block(x, enc_out, p, cfg, positions, impl)
        caches["self"].append({"k": _pad_to(k, max_len), "v": _pad_to(v, max_len)})
        caches["cross_k"].append(ck)
        caches["cross_v"].append(cv)
    x = layers.rms_norm(x, gather_weights(params["final_norm"]), cfg.norm_eps)
    logits = layers.unembed(x[:, -1:], emb)[:, 0]
    return logits, caches


def decode_step(params, caches, token, pos: int, cfg: ModelConfig, max_len: int, impl=None):
    """token (B,) -> (logits (B, V), caches): the self caches are updated in
    place, the cross K/V are static."""
    spec = KVCacheSpec(size=max_len)
    emb = gather_weights(params["embed"])
    x = constrain(layers.embed(token[:, None], emb))
    for p, cache, ck, cv in zip(params["dec_blocks"], caches["self"], caches["cross_k"],
                                caches["cross_v"], strict=True):
        p = gather_weights(p)
        h, _ = attn.decode_self_attention(layers.rms_norm(x, p["ln1"], cfg.norm_eps), cache,
                                          p["self_attn"], cfg, pos, spec, impl=impl)
        x = constrain(x + h)
        x = constrain(x + attn.cross_attention(layers.rms_norm(x, p["ln_x"], cfg.norm_eps),
                                               (ck, cv), p["cross_attn"], cfg, impl=impl))
        x = constrain(x + layers.ffn(layers.rms_norm(x, p["ln2"], cfg.norm_eps), p["mlp"],
                                     cfg.ffn_type))
    x = layers.rms_norm(x, gather_weights(params["final_norm"]), cfg.norm_eps)
    logits = layers.unembed(x, emb)
    return logits[:, 0], caches
