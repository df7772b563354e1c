"""Granite 8B Code — dense GQA, llama-architecture [arXiv:2405.04324]."""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="granite-8b",
    arch_type="dense",
    num_layers=36,
    d_model=4_096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14_336,
    vocab_size=49_152,
    source="arXiv:2405.04324 (Granite Code Models), Table 1",
)
REDUCED = reduced(CONFIG)
