"""Backend dispatch for attention (port of ``repro/kernels/attention/ops.py``).

``impl`` follows the rule of ``kernels/_common.py``: ``None`` on the main
path, ``"cuda"`` to insist on the kernel, ``"ref"`` for the plain version.

Sliding-window banded attention (the reference's ``mha_banded``, selected at
``ops.py:29``) comes with the MoE / sliding-window slice (ROADMAP A5); here a
window is handled by the mask.
"""
from __future__ import annotations

from repro_torch.kernels._common import use_kernel
from repro_torch.kernels.attention import decode_attention as _decode
from repro_torch.kernels.attention import flash_attention as _flash
from repro_torch.kernels.attention import ref


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0, impl=None):
    """(B,S_q,H,D) x (B,S_kv,KV,D)^2 -> (B,S_q,H,D)."""
    if use_kernel(q, impl):
        return _flash.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    return ref.mha(q, k, v, causal=causal, window=window, q_offset=q_offset)


def decode_attention(q, k_cache, v_cache, cache_len, *, window=0, impl=None):
    """(B,H,D) x (B,S_max,KV,D)^2 -> (B,H,D), masked to `cache_len` entries."""
    if use_kernel(q, impl):
        return _decode.decode_attention(q, k_cache, v_cache, cache_len, window=window)
    return ref.decode_gqa(q, k_cache, v_cache, cache_len, window=window)
