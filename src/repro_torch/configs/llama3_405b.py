"""Llama 3.1 405B — dense GQA decoder [arXiv:2407.21783]."""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="llama3-405b",
    arch_type="dense",
    num_layers=126,
    d_model=16_384,
    num_heads=128,
    num_kv_heads=8,
    d_ff=53_248,
    vocab_size=128_256,
    rope_theta=500_000.0,
    source="arXiv:2407.21783 (Llama 3 herd), Table 3",
)
REDUCED = reduced(CONFIG)
