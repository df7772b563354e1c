"""Mamba-2 370M — attention-free SSM with SSD [arXiv:2405.21060]."""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="mamba2-370m",
    arch_type="ssm",
    num_layers=48,
    d_model=1_024,
    vocab_size=50_280,
    ssm_state_dim=128,
    ssm_head_dim=64,          # d_inner 2048 -> 32 SSD heads
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk_size=128,
    source="arXiv:2405.21060 (Mamba-2 / SSD), Table 9",
)
REDUCED = reduced(CONFIG)
