"""RecurrentGemma 9B — Griffin hybrid: RG-LRU + local attention, 1 attention
per 2 recurrent blocks [arXiv:2402.19427]."""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    arch_type="hybrid",
    num_layers=38,
    d_model=4_096,
    num_heads=16,
    num_kv_heads=1,           # MQA on the local-attention blocks
    head_dim=256,
    d_ff=12_288,
    vocab_size=256_000,
    block_pattern=("rglru", "rglru", "attn"),
    attention_window=2_048,
    lru_width=4_096,
    ssm_conv_width=4,
    source="arXiv:2402.19427 (Griffin) + RecurrentGemma-9B model card",
)
REDUCED = reduced(CONFIG)
