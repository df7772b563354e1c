"""Granite 3.0 1B-A400M — MoE, 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    arch_type="moe",
    num_layers=24,
    d_model=1_024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,                 # per-expert FFN width
    vocab_size=49_155,
    num_experts=32,
    experts_per_token=8,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base config.json",
)
REDUCED = reduced(CONFIG)
