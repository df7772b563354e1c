"""DeepSeek 67B — dense GQA, llama-architecture [arXiv:2401.02954]."""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="deepseek-67b",
    arch_type="dense",
    num_layers=95,
    d_model=8_192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22_016,
    vocab_size=102_400,
    rope_theta=10_000.0,
    source="arXiv:2401.02954 (DeepSeek LLM), Table 2",
)
REDUCED = reduced(CONFIG)
