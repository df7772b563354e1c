"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427); port of
``repro/models/griffin.py``.

  recurrent: x -> [gelu gate branch | conv -> RG-LRU branch] -> merge -> proj
  RG-LRU:  r_t = σ(W_r x_t);  i_t = σ(W_i x_t)
           a_t = exp(-c · softplus(Λ) · r_t)          (c = 8)
           h_t = a_t h_{t-1} + sqrt(1 - a_t²) · (i_t ⊙ x_t)

The hybrid's local attention blocks are ``attn_mlp`` blocks of
``models/transformer.py`` with the config's ``attention_window``.

The rounding points are the reference's: the conv summed in float32 and cast
to the input's dtype; gates, ``log_a``, ``a`` and ``b`` in float32; ``h_seq``
cast to the conv output's dtype; the final state kept in float32; the decode
step's conv summed in float32, then cast.  ``jax.nn.gelu`` is the tanh form.

Prefill's linear recurrence has no Pallas kernel in the reference
(``jax.lax.associative_scan``).  ``rglru_scan`` is a log-depth scan in plain
PyTorch: ⌈log₂ S⌉ rounds of the combine (a_l·a_r, b_l·a_r + b_r), each a
few elementwise kernels over the whole sequence, never a loop over S.  Its
sums are taken in another order than ``associative_scan``'s tree, so the
two agree to float32 rounding, not bit for bit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import channelwise, reduce_partial
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import decl

_RGLRU_C = 8.0


def rglru_decls(cfg: ModelConfig):
    d = cfg.d_model
    w = cfg.lru_width or d
    return {
        "w_gate_branch": decl((d, w), ("embed", "ffn")),
        "w_x_branch": decl((d, w), ("embed", "ffn")),
        "conv_w": decl((cfg.ssm_conv_width, w), (None, "ffn"), scale=0.5),
        "conv_b": decl((w,), ("ffn",), init="zeros"),
        "w_input_gate": decl((w, w), ("ffn", None)),
        "b_input_gate": decl((w,), ("ffn",), init="zeros"),
        "w_rec_gate": decl((w, w), ("ffn", None)),
        "b_rec_gate": decl((w,), ("ffn",), init="zeros"),
        "lambda_param": decl((w,), ("ffn",), init="ones"),
        "w_out": decl((w, d), ("ffn", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, x (B,S,W), w (K,W): out_t = Σ_k w_k x_{t-K+1+k}."""
    if isinstance(x, DTensor):
        return channelwise(_causal_conv, x, w, b)
    width = w.shape[0]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    s = x.shape[1]
    for k in range(width):
        out = out + pad[:, k:k + s].float() * w[k].float()
    return (out + b.float()).to(x.dtype)


def _rglru_gates(xb: torch.Tensor, p) -> tuple[torch.Tensor, torch.Tensor]:
    """(a, b) of the linear recurrence h_t = a_t h + b_t, float32."""
    xf = xb.float()
    # Under a mesh each product's pending sum is reduced before its bias is
    # added (torch 2.11's DTensor cannot turn the bias's shard into one).
    r = torch.sigmoid(reduce_partial(xf @ p["w_rec_gate"].float()) + p["b_rec_gate"].float())
    i = torch.sigmoid(reduce_partial(xf @ p["w_input_gate"].float()) + p["b_input_gate"].float())
    log_a = -_RGLRU_C * F.softplus(p["lambda_param"].float()) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along axis 1 from h_{-1} = 0: the inclusive
    scan of the combine (a_l, b_l) ∘ (a_r, b_r) = (a_l·a_r, b_l·a_r + b_r),
    in ⌈log₂ S⌉ rounds (Hillis–Steele: round d combines each step with the
    one d before it).  DTensors run on their local shards."""
    if isinstance(a, DTensor):
        return channelwise(linear_scan, a, b)
    s = a.shape[1]
    d = 1
    while d < s:
        b_next = b.clone()
        b_next[:, d:].addcmul_(b[:, :-d], a[:, d:])
        if 2 * d < s:  # the last round needs no new a
            a_next = a.clone()
            a_next[:, d:].mul_(a[:, :-d])
            a = a_next
        b = b_next
        d *= 2
    return b


def rglru_scan(xb: torch.Tensor, p, h0: torch.Tensor | None = None):
    """xb (B,S,W) -> (h_seq (B,S,W) in xb's dtype, h_final (B,W) float32)."""
    a, b = _rglru_gates(xb, p)
    if h0 is not None:
        # Fold the carried state into the first step's additive term.
        b[:, 0] += a[:, 0] * h0.float()
    h_seq = linear_scan(a, b)
    return h_seq.to(xb.dtype), h_seq[:, -1]


def recurrent_block(x: torch.Tensor, p, cfg: ModelConfig, h0=None):
    """Griffin recurrent temporal block; x (B,S,D) -> (out, (conv_tail, h))."""
    gate = F.gelu(x @ p["w_gate_branch"], approximate="tanh")
    xb = x @ p["w_x_branch"]
    conv = _causal_conv(xb, p["conv_w"], p["conv_b"])
    h_seq, h_fin = rglru_scan(conv, p, h0)
    out = (h_seq * gate) @ p["w_out"]
    # The last K-1 pre-conv inputs for decode.  As in the reference, a prompt
    # shorter than ssm_conv_width - 1 leaves fewer rows than the cache holds.
    conv_tail = xb[:, -(cfg.ssm_conv_width - 1):]
    return out, (conv_tail, h_fin)


def rglru_cache_decls(cfg: ModelConfig, batch: int):
    w = cfg.lru_width or cfg.d_model
    return {
        "conv": decl((batch, cfg.ssm_conv_width - 1, w), ("cache_batch", None, "kv_heads"),
                     init="zeros"),
        "h": decl((batch, w), ("cache_batch", "kv_heads"), init="zeros", dtype=torch.float32),
    }


def recurrent_decode_step(x: torch.Tensor, cache, p, cfg: ModelConfig):
    """x (B,1,D) -> (out (B,1,D), new_cache); O(1) per token.

    The new cache is a new dict: its window has the type of the concatenation
    of the old window and the new row, as in the reference.
    """
    gate = F.gelu(x[:, 0] @ p["w_gate_branch"], approximate="tanh")
    xb = x[:, 0] @ p["w_x_branch"]
    window = torch.cat([cache["conv"], xb[:, None]], dim=1)
    conv = (window.float() * p["conv_w"].float()[None]).sum(1) + p["conv_b"].float()
    conv = conv.to(x.dtype)
    a, b = _rglru_gates(conv[:, None], p)
    h = a[:, 0] * cache["h"].float() + b[:, 0]
    out = ((h.to(x.dtype) * gate) @ p["w_out"])[:, None]
    return out, {"conv": window[:, 1:], "h": h}
