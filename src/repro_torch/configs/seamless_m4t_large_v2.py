"""SeamlessM4T-Large v2 — multimodal encoder-decoder [arXiv:2308.11596].

The speech frontend (mel filterbank + w2v-BERT conformer stack) is a STUB:
the encoder consumes precomputed frame embeddings of shape
(batch, frames, d_model).  This config is the text/unit transformer
backbone: 24 encoder + 24 decoder layers, MHA (kv == heads).
"""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    arch_type="encdec",
    num_layers=24,
    encoder_layers=24,
    d_model=1_024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8_192,
    vocab_size=256_206,
    ffn_type="gelu",
    frontend="audio",
    source="arXiv:2308.11596 (SeamlessM4T), §5 + model card",
)
REDUCED = reduced(CONFIG)
