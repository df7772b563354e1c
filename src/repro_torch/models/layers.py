"""Shared model building blocks: norms, RoPE / M-RoPE, FFNs, embeddings.

Port of ``repro/models/layers.py``.  Functions are pure on tensors;
parameters come in as dicts declared by the matching ``*_decls`` helpers.
Norms, RoPE and softmax statistics are computed in float32 and cast back,
as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.params import decl


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_decls(d_model: int):
    return {"scale": decl((d_model,), ("embed",), init="ones")}


def rms_norm(x: torch.Tensor, p, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (standard + Qwen2-VL multimodal M-RoPE)
# ---------------------------------------------------------------------------

def _rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    # A python-float base keeps the power on the device: a tensor made from
    # ``theta`` would be a host-to-device copy, which waits for the stream.
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """angles (B,S,D/2) -> x (B,S,H,D) rotated in float32, cast back."""
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int."""
    freqs = _rope_freqs(x.shape[-1], theta, x.device)
    return _rotate(x, positions[..., None].float() * freqs)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections=(2, 1, 1)) -> torch.Tensor:
    """Qwen2-VL M-RoPE: positions (B, S, 3) = (temporal, height, width) ids.

    The D/2 rotary frequencies are split into three contiguous sections
    proportional to ``sections``; each section rotates by its own positional
    channel.  Text tokens carry equal ids, which makes M-RoPE plain RoPE.
    """
    d = x.shape[-1]
    half = d // 2
    total = sum(sections)
    sec_id = torch.zeros(half, dtype=torch.int64, device=x.device)
    start = 0
    for s in sections[:-1]:
        start += (half * s) // total
        sec_id += (torch.arange(half, device=x.device) >= start).to(torch.int64)
    freqs = _rope_freqs(d, theta, x.device)
    idx = sec_id[None, None, :].expand(*positions.shape[:2], half)
    pos_per_freq = torch.gather(positions.float(), -1, idx)     # (B,S,half)
    return _rotate(x, pos_per_freq * freqs)


# ---------------------------------------------------------------------------
# Feed-forward networks
# ---------------------------------------------------------------------------

def ffn_decls(d_model: int, d_ff: int, ffn_type: str):
    if ffn_type == "swiglu":
        return {
            "w_gate": decl((d_model, d_ff), ("embed", "ffn")),
            "w_up": decl((d_model, d_ff), ("embed", "ffn")),
            "w_down": decl((d_ff, d_model), ("ffn", "embed")),
        }
    return {
        "w_in": decl((d_model, d_ff), ("embed", "ffn")),
        "w_out": decl((d_ff, d_model), ("ffn", "embed")),
    }


def ffn(x: torch.Tensor, p, ffn_type: str) -> torch.Tensor:
    if ffn_type == "swiglu":
        gate = F.silu(x @ p["w_gate"])
        return (gate * (x @ p["w_up"])) @ p["w_down"]
    # jax.nn.gelu defaults to the tanh approximation.
    return F.gelu(x @ p["w_in"], approximate="tanh") @ p["w_out"]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_decls(padded_vocab: int, d_model: int, tie: bool):
    d = {"embedding": decl((padded_vocab, d_model), ("vocab", "embed"), scale=1.0)}
    if not tie:
        d["lm_head"] = decl((d_model, padded_vocab), ("embed", "vocab"))
    return d


def embed(tokens: torch.Tensor, p) -> torch.Tensor:
    return p["embedding"][tokens]


def unembed(x: torch.Tensor, p) -> torch.Tensor:
    w = p.get("lm_head")
    if w is None:
        w = p["embedding"].T
    return x @ w
