"""Decoder-only language model over the reference's block patterns (port of
``repro/models/transformer.py``): ``attn_mlp``, ``attn_moe``, ``ssm`` and
the hybrid's ``rglru_mlp`` blocks.

Where the reference groups the layers into superblocks stacked on a leading
axis and scans over them, the port keeps one parameter dict per layer in a
list, in the order the reference executes them: superblock 0's sub-blocks in
pattern order, then superblock 1, ..., then the tail.  Layer i is of kind
``layer_kinds(cfg)[i]``, and the cache list follows the same order.
Three entry points:
  forward_train(params, batch)              -> (loss, {"ce", "aux"})
  prefill(params, batch, ...)               -> (logits_last, caches)
  decode_step(params, caches, token, pos)   -> (logits, caches)
``impl`` is passed to the kernel dispatch (``kernels/*/ops.py``): ``None``
on the main path, ``"ref"`` to run the plain versions for a comparison.

An ``attn_moe`` block's prefill routes with ``cfg.moe_capacity_factor`` and
its decode with a capacity factor of 2.0, as the reference's do
(``repro/models/transformer.py:315``).  Its Switch aux loss is summed over
the layers by ``forward_logits`` and weighted into the training loss;
``prefill`` returns (logits, caches), as the reference's ``ModelApi`` does.

Under a mesh (DTensor parameters, ``distributed/sharding.py``) the residual
stream is laid out by ``sharding.constrain`` after the embedding and after
every residual add, and each block's weights (and the embedding's) are gathered
over the batch axes where they are used (``sharding.gather_weights``, FSDP);
outside a mesh both return their argument.

With ``cfg.remat`` a training forward recomputes each superblock in the
backward (``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``
around its scan body); the tail blocks keep their activations, as there.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import constrain, gather_weights
from repro_torch.models import attention as attn
from repro_torch.models import griffin, layers, moe, ssm
from repro_torch.models.attention import KVCacheSpec
from repro_torch.models.config import ModelConfig

DECODE_CAPACITY_FACTOR = 2.0


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


def _block_decls(kind: str, cfg: ModelConfig) -> dict:
    if kind == "attn_mlp":
        return {
            "ln1": layers.rmsnorm_decls(cfg.d_model),
            "attn": attn.attention_decls(cfg),
            "ln2": layers.rmsnorm_decls(cfg.d_model),
            "mlp": layers.ffn_decls(cfg.d_model, cfg.d_ff, cfg.ffn_type),
        }
    if kind == "attn_moe":
        return {
            "ln1": layers.rmsnorm_decls(cfg.d_model),
            "attn": attn.attention_decls(cfg),
            "ln2": layers.rmsnorm_decls(cfg.d_model),
            "moe": moe.moe_decls(cfg),
        }
    if kind == "ssm":
        return {"ln1": layers.rmsnorm_decls(cfg.d_model), "ssm": ssm.ssm_decls(cfg)}
    if kind == "rglru_mlp":
        return {
            "ln1": layers.rmsnorm_decls(cfg.d_model),
            "rec": griffin.rglru_decls(cfg),
            "ln2": layers.rmsnorm_decls(cfg.d_model),
            "mlp": layers.ffn_decls(cfg.d_model, cfg.d_ff, cfg.ffn_type),
        }
    raise ValueError(kind)


def model_decls(cfg: ModelConfig) -> dict:
    return {
        "embed": layers.embed_decls(cfg.padded_vocab, cfg.d_model, cfg.tie_embeddings),
        "final_norm": layers.rmsnorm_decls(cfg.d_model),
        "blocks": [_block_decls(kind, cfg) for kind in layer_kinds(cfg)],
    }


def _window_for(cfg: ModelConfig) -> int:
    """The attention blocks' window: a hybrid's local attention attends over
    ``attention_window``, every other family over ``sliding_window``."""
    if cfg.arch_type == "hybrid":
        return cfg.attention_window
    return cfg.sliding_window


def _block_fwd(kind: str, x, p, cfg: ModelConfig, positions, impl):
    """Full-sequence forward of one block.  Returns (x, aux_loss, cache_seed):
    the Switch aux loss of an ``attn_moe`` block (0.0 for the others), and
    (k, v) for the attention blocks, (conv_tail, final_state) for ``ssm``
    and ``rglru_mlp``."""
    p = gather_weights(p)
    if kind in ("attn_mlp", "attn_moe"):
        h, kv = attn.self_attention(
            layers.rms_norm(x, p["ln1"], cfg.norm_eps), p["attn"], cfg, positions,
            causal=True, window=_window_for(cfg), impl=impl,
        )
        x = constrain(x + h)
        y = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
        if kind == "attn_mlp":
            return x + layers.ffn(y, p["mlp"], cfg.ffn_type), 0.0, kv
        mo, aux = moe.moe_ffn(y, p["moe"], cfg, capacity_factor=cfg.moe_capacity_factor)
        return x + mo, aux, kv
    if kind == "ssm":
        h, state = ssm.ssm_block(layers.rms_norm(x, p["ln1"], cfg.norm_eps), p["ssm"], cfg,
                                 impl=impl)
        return x + h, 0.0, state
    if kind == "rglru_mlp":
        h, state = griffin.recurrent_block(layers.rms_norm(x, p["ln1"], cfg.norm_eps),
                                           p["rec"], cfg)
        x = constrain(x + h)
        return x + layers.ffn(layers.rms_norm(x, p["ln2"], cfg.norm_eps), p["mlp"],
                              cfg.ffn_type), 0.0, state
    raise ValueError(kind)


def rematerialized(fn, cfg: ModelConfig):
    """``fn`` recomputed in the backward when ``cfg.remat`` and autograd
    records (``torch.utils.checkpoint``, non-reentrant); ``fn`` itself
    otherwise.  Its kernels then launch again in the backward."""
    def run(*args):
        if cfg.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
        return fn(*args)
    return run


def _run_stack(x, blocks, cfg: ModelConfig, positions, impl):
    """The training forward of the layer stack: each superblock (one repeat
    of ``block_pattern``) rematerialized under ``cfg.remat``, then the tail.
    Returns (x, the summed aux loss)."""
    kinds = layer_kinds(cfg)
    p = len(block_pattern(cfg))
    n_super, _ = super_counts(cfg)

    def superblock(xx, first: int):
        aux = torch.zeros((), dtype=torch.float32, device=xx.device)
        for i in range(p):
            xx, a, _ = _block_fwd(kinds[first + i], xx, blocks[first + i], cfg, positions, impl)
            xx = constrain(xx)
            aux = aux + a
        return xx, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for j in range(n_super):
        x, a = rematerialized(superblock, cfg)(x, j * p)
        aux = aux + a
    for i in range(n_super * p, len(kinds)):
        x, a, _ = _block_fwd(kinds[i], x, blocks[i], cfg, positions, impl)
        x = constrain(x)
        aux = aux + a
    return x, aux


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
    if kind in ("attn_mlp", "attn_moe"):
        return attn.kv_cache_decls(cfg, batch, spec)
    if kind == "ssm":
        return ssm.ssm_cache_decls(cfg, batch)
    if kind == "rglru_mlp":
        return griffin.rglru_cache_decls(cfg, batch)
    raise ValueError(kind)


def cache_decls(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    spec = cache_spec(cfg, max_len)
    return {"blocks": [_block_cache_decls(kind, cfg, batch, spec) for kind in layer_kinds(cfg)]}


def _roll(x, shift: int):
    """``torch.roll(x, shift, dims=1)`` as two slices concatenated, the same
    bits (torch 2.11's DTensor has no strategy for ``aten.roll``)."""
    n = x.shape[1]
    return torch.cat([x[:, n - shift:], x[:, :n - shift]], dim=1)


def _seed_to_cache(kind: str, seed, spec: KVCacheSpec, s: int) -> dict:
    """Convert a full-sequence cache seed into the decode cache layout."""
    if kind in ("ssm", "rglru_mlp"):
        conv_tail, h = seed
        return {"conv": conv_tail, "h": h.float()}

    def to_cache(x):  # (B, S, KV, Dh)
        if s >= spec.size:
            x = x[:, s - spec.size:s]
            if spec.window > 0:  # rolling layout: token t lives at t % size
                x = _roll(x, s % spec.size)
            return x.contiguous()
        pad = x.new_zeros((x.shape[0], spec.size - s, *x.shape[2:]))
        return torch.cat([x, pad], dim=1)

    k, v = seed
    return {"k": to_cache(k), "v": to_cache(v)}


# -- entry points ------------------------------------------------------------

def forward_logits(params, batch, cfg: ModelConfig, impl=None):
    """Full-sequence logits (B, S, V) and the summed MoE aux loss."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    emb = gather_weights(params["embed"])
    x = layers.embed(tokens, emb)
    x = constrain(_apply_frontend(x, batch))
    positions = _positions(batch, cfg, b, s, x.device)
    x, aux = _run_stack(x, params["blocks"], cfg, positions, impl)
    x = layers.rms_norm(x, gather_weights(params["final_norm"]), cfg.norm_eps)
    return layers.unembed(x, emb), aux


def forward_train(params, batch, cfg: ModelConfig, aux_weight: float = 0.01, impl=None):
    """(loss, {"ce", "aux"}): next-token CE on ``batch["labels"]`` plus
    ``aux_weight`` times the MoE aux loss."""
    logits, aux = forward_logits(params, batch, cfg, impl)
    loss = layers.cross_entropy_loss(logits, batch["labels"])
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}


def prefill(params, batch, cfg: ModelConfig, max_len: int, impl=None):
    """Full-sequence forward that also builds decode caches.

    Returns (logits_last (B, V), caches).
    """
    tokens = batch["tokens"]
    b, s = tokens.shape
    spec = cache_spec(cfg, max_len)
    emb = gather_weights(params["embed"])
    x = layers.embed(tokens, emb)
    x = constrain(_apply_frontend(x, batch))
    positions = _positions(batch, cfg, b, s, x.device)
    seeds = []
    for kind, p in zip(layer_kinds(cfg), params["blocks"], strict=True):
        x, _aux, seed = _block_fwd(kind, x, p, cfg, positions, impl)
        x = constrain(x)
        seeds.append(_seed_to_cache(kind, seed, spec, s))
    x = layers.rms_norm(x, gather_weights(params["final_norm"]), cfg.norm_eps)
    logits = layers.unembed(x[:, -1:], emb)[:, 0]
    return logits, {"blocks": seeds}


def _block_decode(kind: str, x, cache, p, cfg: ModelConfig, pos: int, spec: KVCacheSpec,
                  impl):
    """One token through one block.  Returns (x, cache): an attention cache is
    updated in place, an ssm or rglru cache is replaced."""
    p = gather_weights(p)
    if kind in ("attn_mlp", "attn_moe"):
        h, cache = attn.decode_self_attention(
            layers.rms_norm(x, p["ln1"], cfg.norm_eps), cache, p["attn"], cfg, pos, spec,
            impl=impl,
        )
        x = constrain(x + h)
        y = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
        if kind == "attn_mlp":
            return x + layers.ffn(y, p["mlp"], cfg.ffn_type), cache
        mo, _aux = moe.moe_ffn(y, p["moe"], cfg, capacity_factor=DECODE_CAPACITY_FACTOR)
        return x + mo, cache
    if kind == "ssm":  # the state carries the position: pos is not used
        h, cache = ssm.ssm_decode_step(layers.rms_norm(x, p["ln1"], cfg.norm_eps), cache,
                                       p["ssm"], cfg)
        return x + h, cache
    if kind == "rglru_mlp":
        h, cache = griffin.recurrent_decode_step(layers.rms_norm(x, p["ln1"], cfg.norm_eps),
                                                 cache, p["rec"], cfg)
        x = constrain(x + h)
        return x + layers.ffn(layers.rms_norm(x, p["ln2"], cfg.norm_eps), p["mlp"],
                              cfg.ffn_type), cache
    raise ValueError(kind)


def decode_step(params, caches, token, pos: int, cfg: ModelConfig, max_len: int, impl=None):
    """token (B,) int; pos: one position for every row -> (logits (B,V), caches).

    Attention caches are updated in place; the returned tree holds them and
    the new ssm and rglru caches.
    """
    spec = cache_spec(cfg, max_len)
    emb = gather_weights(params["embed"])
    x = constrain(layers.embed(token[:, None], emb))
    blocks = []
    for kind, p, cache in zip(layer_kinds(cfg), params["blocks"], caches["blocks"],
                              strict=True):
        x, cache = _block_decode(kind, x, cache, p, cfg, pos, spec, impl)
        x = constrain(x)
        blocks.append(cache)
    x = layers.rms_norm(x, gather_weights(params["final_norm"]), cfg.norm_eps)
    logits = layers.unembed(x, emb)
    return logits[:, 0], {"blocks": blocks}
