"""Backend dispatch for attention (port of ``repro/kernels/attention/ops.py``).

``impl=None`` (the main path) hands the call to the kernel wrapper: on a
CUDA tensor it launches the Hopper kernel or raises, on a CPU tensor it
computes the plain version.  ``impl="cuda"`` insists on the kernel and
raises for a CPU tensor instead of returning the plain result.
``impl="ref"`` runs the plain version wherever the tensors are; only
comparisons (``chip_smoke.py``, the tests) pass it.

Sliding-window banded attention (the reference's ``mha_banded``, selected at
``ops.py:29``) comes with the MoE / sliding-window slice (ROADMAP A5); here a
window is handled by the mask.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.attention import decode_attention as _decode
from repro_torch.kernels.attention import flash_attention as _flash
from repro_torch.kernels.attention import ref

IMPLS = (None, "cuda", "ref")


def _use_kernel(x: torch.Tensor, impl) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r}; expected one of {IMPLS}")
    if impl == "cuda" and x.device.type != "cuda":
        raise ValueError(
            f"impl='cuda' asks for the CUDA kernel, but the tensors are on {x.device}"
        )
    return impl != "ref"


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0, impl=None):
    """(B,S_q,H,D) x (B,S_kv,KV,D)^2 -> (B,S_q,H,D)."""
    if _use_kernel(q, impl):
        return _flash.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    return ref.mha(q, k, v, causal=causal, window=window, q_offset=q_offset)


def decode_attention(q, k_cache, v_cache, cache_len, *, window=0, impl=None):
    """(B,H,D) x (B,S_max,KV,D)^2 -> (B,H,D), masked to `cache_len` entries."""
    if _use_kernel(q, impl):
        return _decode.decode_attention(q, k_cache, v_cache, cache_len, window=window)
    return ref.decode_gqa(q, k_cache, v_cache, cache_len, window=window)
