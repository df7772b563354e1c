"""Model configuration covering all assigned architecture families.

A copy of ``repro/models/config.py``: the port keeps its own so that it
imports nothing of the JAX package.  One frozen dataclass describes dense /
MoE / SSM / hybrid / enc-dec models (VLM and audio backbones are dense /
enc-dec configs with a stubbed modality frontend).  Every assigned
architecture in ``repro_torch/configs`` instantiates exactly the published
numbers and cites its source.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

ArchType = Literal["dense", "moe", "ssm", "hybrid", "encdec"]
Frontend = Literal["none", "vision", "audio"]


def pad_vocab(vocab_size: int, multiple: int = 256) -> int:
    """Round the embedding table up for even `model`-axis sharding."""
    return ((vocab_size + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: ArchType
    num_layers: int
    d_model: int
    vocab_size: int

    # Attention (unused for pure SSM).
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    rope_theta: float = 10_000.0
    mrope: bool = False                  # Qwen2-VL multimodal RoPE
    sliding_window: int = 0              # 0 = full causal attention

    # FFN.
    d_ff: int = 0
    ffn_type: Literal["swiglu", "gelu"] = "swiglu"

    # MoE.
    num_experts: int = 0
    experts_per_token: int = 0
    moe_impl: Literal["einsum", "grouped"] = "einsum"
    moe_capacity_factor: float = 1.25

    # SSM (Mamba-2 / SSD).
    ssm_state_dim: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk_size: int = 128

    # Hybrid (RecurrentGemma / Griffin).
    block_pattern: tuple[str, ...] = ()  # e.g. ("rglru", "rglru", "attn")
    attention_window: int = 0            # local-attention window (hybrid)
    lru_width: int = 0

    # Encoder-decoder.
    encoder_layers: int = 0

    # Modality frontend stub (precomputed embeddings consumed as-is).
    frontend: Frontend = "none"
    frontend_tokens: int = 0             # patches / audio frames per example

    # Numerics / training.
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    remat: bool = True

    source: str = ""                     # citation for the exact numbers

    def __post_init__(self):
        if self.arch_type != "ssm" and self.num_heads:
            if self.head_dim == 0:
                object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.arch_type == "moe" and not (self.num_experts and self.experts_per_token):
            raise ValueError(f"{self.name}: MoE config needs experts")
        if self.arch_type == "hybrid" and not self.block_pattern:
            raise ValueError(f"{self.name}: hybrid config needs block_pattern")

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab_size)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic state at decode: SSM / hybrid / sliding-window."""
        return (
            self.arch_type in ("ssm", "hybrid")
            or self.sliding_window > 0
        )

    @property
    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS)."""
        d, v = self.d_model, self.padded_vocab
        embed = v * d * (1 if self.tie_embeddings else 2)
        if self.arch_type == "ssm":
            di, ns = self.ssm_d_inner, self.ssm_state_dim
            nh = self.ssm_num_heads
            # in_proj (z,x,B,C,dt) + conv + out_proj + norms
            per_layer = d * (2 * di + 2 * ns + nh) + (di + 2 * ns) * self.ssm_conv_width
            per_layer += di * d + 2 * nh + di + d
            return embed + self.num_layers * per_layer
        attn = d * self.head_dim * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * self.head_dim * d
        if self.ffn_type == "swiglu":
            ffn = 3 * d * self.d_ff
        else:
            ffn = 2 * d * self.d_ff
        if self.arch_type == "moe":
            ffn = self.num_experts * ffn + d * self.num_experts
        per_layer = attn + ffn + 2 * d
        total = embed + self.num_layers * per_layer
        if self.arch_type == "hybrid":
            # Recompute: attention only on "attn" blocks, RG-LRU on the rest.
            n_attn = sum(
                1 for i in range(self.num_layers)
                if self.block_pattern[i % len(self.block_pattern)] == "attn"
            )
            n_rec = self.num_layers - n_attn
            w = self.lru_width or d
            rec = d * w * 2 + w * self.ssm_conv_width + w * d + 3 * w  # conv+gates+proj
            total = embed + n_attn * (attn + ffn + 2 * d) + n_rec * (rec + ffn + 2 * d)
        if self.arch_type == "encdec":
            # Encoder layers: self-attn + ffn; decoder adds cross-attn.
            enc = self.encoder_layers * (attn + ffn + 2 * d)
            dec = self.num_layers * (2 * attn + ffn + 3 * d)
            total = embed + enc + dec
        return total

    @property
    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts)."""
        if self.arch_type != "moe":
            return self.param_count
        d = self.d_model
        ffn_one = (3 if self.ffn_type == "swiglu" else 2) * d * self.d_ff
        inactive = self.num_layers * (self.num_experts - self.experts_per_token) * ffn_one
        return self.param_count - inactive


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """CPU-smoke-test variant: same family, 2 layers, tiny dims.

    Keeps head_dim/ratios structurally faithful (GQA grouping, MoE top-k,
    hybrid pattern) while fitting a laptop.
    """
    small: dict = dict(
        num_layers=2 if cfg.arch_type != "hybrid" else 3,
        d_model=min(cfg.d_model, 128),
        vocab_size=min(cfg.vocab_size, 512),
        frontend_tokens=min(cfg.frontend_tokens, 8),
    )
    if cfg.num_heads:
        heads = min(cfg.num_heads, 4)
        kv = max(1, min(cfg.num_kv_heads, heads))
        while heads % kv:
            kv -= 1
        small.update(num_heads=heads, num_kv_heads=kv, head_dim=32)
    if cfg.d_ff:
        small["d_ff"] = min(cfg.d_ff, 256)
    if cfg.arch_type == "moe":
        # Generous capacity so prefill==decode consistency holds exactly in
        # smoke tests (capacity drops only hit the prefill path: decode's
        # per-token dispatch never overflows — a real, documented asymmetry).
        small.update(num_experts=min(cfg.num_experts, 4),
                     experts_per_token=min(cfg.experts_per_token, 2),
                     moe_capacity_factor=4.0)
    if cfg.arch_type == "ssm":
        small.update(ssm_state_dim=min(cfg.ssm_state_dim, 16), ssm_head_dim=32,
                     ssm_chunk_size=16)
    if cfg.arch_type == "hybrid":
        small.update(lru_width=min(cfg.lru_width or cfg.d_model, 128),
                     attention_window=min(cfg.attention_window, 16))
    if cfg.sliding_window:
        small["sliding_window"] = min(cfg.sliding_window, 16)
    if cfg.encoder_layers:
        small["encoder_layers"] = 2
    small.update(overrides)
    small["name"] = cfg.name + "-reduced"
    return dataclasses.replace(cfg, **small)
