"""Backend dispatch for attention (port of ``repro/kernels/attention/ops.py``).

``impl`` follows the rule of ``kernels/_common.py``: ``None`` on the main
path, ``"cuda"`` to insist on the kernel, ``"ref"`` for the plain version.

The plain version of flash attention is ``ref.flash_plain``: sliding-window
attention is computed banded (``ref.mha_banded``) exactly where the
reference's dispatch picks it (``repro/kernels/attention/ops.py:29``:
causal, no offset, S_q = S_kv a multiple of the window and at least two
windows), and masked (``ref.mha``) elsewhere.  The kernels take every window
the same way: they skip the key tiles outside it.
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
    return ref.flash_plain(q, k, v, causal=causal, window=window, q_offset=q_offset)


def decode_attention(q, k_cache, v_cache, cache_len, *, window=0, impl=None):
    """(B,H,D) x (B,S_max,KV,D)^2 -> (B,H,D), masked to `cache_len` entries."""
    if use_kernel(q, impl):
        return _decode.decode_attention(q, k_cache, v_cache, cache_len, window=window)
    return ref.decode_gqa(q, k_cache, v_cache, cache_len, window=window)
