"""Mixtral 8x7B — MoE 8 experts top-2, sliding-window attention
[arXiv:2401.04088]."""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    arch_type="moe",
    num_layers=32,
    d_model=4_096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14_336,              # per-expert FFN width
    vocab_size=32_000,
    num_experts=8,
    experts_per_token=2,
    sliding_window=4_096,     # SWA -> sub-quadratic decode state (long_500k)
    rope_theta=1_000_000.0,
    source="arXiv:2401.04088 (Mixtral of Experts), §2",
)
REDUCED = reduced(CONFIG)
