"""Minitron 4B — pruned Nemotron-4, dense GQA [arXiv:2407.14679]."""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="minitron-4b",
    arch_type="dense",
    num_layers=32,
    d_model=3_072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9_216,
    vocab_size=256_000,
    source="arXiv:2407.14679 (Minitron), Table 1",
)
REDUCED = reduced(CONFIG)
