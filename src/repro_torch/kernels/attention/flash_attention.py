"""Flash attention for prefill: wrapper of the CUDA kernel in
``csrc/flash_attention.cu`` (replaces the Pallas kernel
``repro/kernels/attention/flash_attention.py::flash_attention``).

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it computes the plain version, ``ref.mha``.  ``launches`` counts the kernel
launches this process made.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import DTYPE_CODES, raise_on_error, stream_handle
from repro_torch.kernels.attention import ref
from repro_torch.kernels.attention._common import check_operands

launches = 0
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.library().repro_flash_attention
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 12
            + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
        )
        _fn = fn
    return _fn


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """q (B,S_q,H,D), k/v (B,S_kv,KV,D) -> (B,S_q,H,D) in q's dtype."""
    if q.device.type == "cpu":
        return ref.mha(q, k, v, causal=causal, window=window, q_offset=q_offset)
    check_operands("flash_attention", {"q": q, "k": k, "v": v})
    b, s_q, h, d = q.shape
    s_kv, kv = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d or h % kv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not GQA-compatible")
    if s_q == 0 or s_kv == 0 or window < 0 or q_offset < 0:
        raise ValueError(f"flash_attention: S_q={s_q}, S_kv={s_kv}, window={window}, "
                         f"q_offset={q_offset}")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            DTYPE_CODES[q.dtype], b, s_q, s_kv, h, kv, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            int(causal), int(window), int(q_offset), ref.softmax_scale(d), stream_handle(q),
        )
    raise_on_error("flash_attention", err)
    global launches
    launches += 1
    return out
