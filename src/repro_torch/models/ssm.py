"""Mamba-2 block (SSD — state-space duality, arXiv:2405.21060); port of
``repro/models/ssm.py``.

Block: in_proj -> (z | x | B | C | dt), causal depthwise conv over (x,B,C),
SiLU, softplus(dt), chunked SSD scan (the CUDA kernel on the card), gated
RMSNorm, out_proj.  Decode keeps a (conv window, SSD state) pair per layer,
O(1) in sequence length.  The rounding points are the reference's: the conv
in float32 cast back to x's dtype, SiLU, softplus(dt + dt_bias) and the
gated RMSNorm in float32, the SSD state in float32.  The projections and
the conv stay plain PyTorch, as the reference leaves them outside Pallas.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.distributed.sharding import channelwise
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import decl


def _dims(cfg: ModelConfig):
    di = cfg.ssm_d_inner
    n = cfg.ssm_state_dim
    nh = cfg.ssm_num_heads
    conv_ch = di + 2 * n
    return di, n, nh, conv_ch


def ssm_decls(cfg: ModelConfig):
    d = cfg.d_model
    di, n, nh, conv_ch = _dims(cfg)
    return {
        "w_in": decl((d, 2 * di + 2 * n + nh), ("embed", "ffn")),
        "conv_w": decl((cfg.ssm_conv_width, conv_ch), (None, "ffn"), scale=0.5),
        "conv_b": decl((conv_ch,), ("ffn",), init="zeros"),
        "A_log": decl((nh,), (None,), init="ones"),
        "dt_bias": decl((nh,), (None,), init="zeros"),
        "D": decl((nh,), (None,), init="ones"),
        "norm_scale": decl((di,), ("ffn",), init="ones"),
        "w_out": decl((di, d), ("ffn", "embed")),
    }


def _split(zxbcdt, cfg: ModelConfig):
    """(…, 2·di + 2·n + nh) -> z, x, B, C, dt (views)."""
    di, n, nh, _ = _dims(cfg)
    return torch.split(zxbcdt, [di, di, n, n, nh], dim=-1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, x (B,S,C), w (W,C): out_t = Σ_k w_k x_{t-W+1+k}."""
    if isinstance(x, DTensor):
        return channelwise(_causal_conv, x, w, b)
    width = w.shape[0]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    s = x.shape[1]
    for k in range(width):
        out = out + pad[:, k:k + s].float() * w[k].float()
    return (out + b.float()).to(x.dtype)


def _gated_rmsnorm(y, z, scale, eps):
    yf = (y * F.silu(z.float())).float()
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)


def ssm_block(x: torch.Tensor, p, cfg: ModelConfig, impl=None):
    """Prefill forward; x (B,S,D) -> (out, (conv_tail, final_state))."""
    b, s, _ = x.shape
    di, n, nh, conv_ch = _dims(cfg)
    z, xc, Bm, Cm, dt = _split(x @ p["w_in"], cfg)
    conv_in = torch.cat([xc, Bm, Cm], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, p["conv_w"], p["conv_b"]).float()).to(x.dtype)
    xc, Bm, Cm = torch.split(conv_out, [di, n, n], dim=-1)
    xh = xc.reshape(b, s, nh, cfg.ssm_head_dim)
    dtp = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    y, h = ssd_ops.ssd(xh, dtp, A, Bm, Cm, p["D"], chunk=cfg.ssm_chunk_size, impl=impl)
    y = _gated_rmsnorm(y.reshape(b, s, di), z, p["norm_scale"], cfg.norm_eps)
    # The decode continuation.  As in the reference, a prompt shorter than
    # ssm_conv_width - 1 leaves fewer rows than the cache holds.
    conv_tail = conv_in[:, -(cfg.ssm_conv_width - 1):]
    return y @ p["w_out"], (conv_tail, h)


# ---------------------------------------------------------------------------
# Decode (O(1) state)
# ---------------------------------------------------------------------------

def ssm_cache_decls(cfg: ModelConfig, batch: int):
    di, n, nh, conv_ch = _dims(cfg)
    return {
        "conv": decl(
            (batch, cfg.ssm_conv_width - 1, conv_ch),
            ("cache_batch", None, "kv_heads"), init="zeros",
        ),
        "h": decl(
            (batch, nh, cfg.ssm_head_dim, n),
            ("cache_batch", "kv_heads", None, None), init="zeros", dtype=torch.float32,
        ),
    }


def ssm_decode_step(x: torch.Tensor, cache, p, cfg: ModelConfig):
    """x (B,1,D) -> (out (B,1,D), new_cache).

    The new cache is a new dict: its window has the type of the concatenation
    of the old window and the new row, as in the reference (a bfloat16 cache
    under float32 weights becomes float32).
    """
    b = x.shape[0]
    di, n, nh, conv_ch = _dims(cfg)
    z, xc, Bm, Cm, dt = _split(x[:, 0] @ p["w_in"], cfg)
    conv_in = torch.cat([xc, Bm, Cm], dim=-1)                        # (B, C)
    window = torch.cat([cache["conv"], conv_in[:, None]], dim=1)
    w = p["conv_w"].float()
    conv_out = (window.float() * w[None]).sum(1) + p["conv_b"].float()
    conv_out = F.silu(conv_out).to(x.dtype)
    xc, Bm, Cm = torch.split(conv_out, [di, n, n], dim=-1)
    xh = xc.reshape(b, nh, cfg.ssm_head_dim)
    dtp = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    y, h = ssd_ops.ssd_decode_step(xh, dtp, A, Bm, Cm, p["D"], cache["h"])
    y = _gated_rmsnorm(y.reshape(b, di), z, p["norm_scale"], cfg.norm_eps)
    out = (y @ p["w_out"])[:, None]
    return out, {"conv": window[:, 1:], "h": h}
