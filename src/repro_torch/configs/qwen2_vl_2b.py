"""Qwen2-VL 2B — VLM decoder backbone with M-RoPE [arXiv:2409.12191].

The ViT vision encoder + projector are a STUB: ``input_specs`` supplies
precomputed patch embeddings (dynamic-resolution frontend output) which
overwrite the leading positions of the token embedding sequence; M-RoPE
(temporal/height/width rotary sections) runs in the backbone.
"""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    arch_type="dense",
    num_layers=28,
    d_model=1_536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8_960,
    vocab_size=151_936,
    mrope=True,
    frontend="vision",
    frontend_tokens=256,
    rope_theta=1_000_000.0,
    source="arXiv:2409.12191 (Qwen2-VL), §2 + model card",
)
REDUCED = reduced(CONFIG)
