"""One-token GQA decode attention: wrapper of the CUDA kernels in
``csrc/decode_attention.cu`` (replaces the Pallas kernel
``repro/kernels/attention/decode_attention.py::decode_attention``).

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it computes the plain version, ``ref.decode_gqa``.  ``launches`` counts the
kernel launches (one split pass plus its combine pass) this process made.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import DTYPE_CODES, raise_on_error, stream_handle
from repro_torch.kernels.attention import ref
from repro_torch.kernels.attention._common import check_operands

MAX_GROUP = 8          # query heads per kv head the kernel keeps in registers
TARGET_BLOCKS = 264    # two blocks per SM of an H100 (132 SMs)
CHUNK_ALIGN = 32

launches = 0
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.library().repro_decode_attention
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_float]
            + [ctypes.c_longlong] * 10 + [ctypes.c_void_p]
        )
        _fn = fn
    return _fn


def split_plan(b: int, kv: int, s_max: int) -> tuple[int, int]:
    """(chunk, n_split): cut the cache so that B·KV·n_split fills the card
    about twice, in chunks that are multiples of 32 entries."""
    want = max(1, math.ceil(TARGET_BLOCKS / (b * kv)))
    chunk = max(CHUNK_ALIGN, math.ceil(math.ceil(s_max / want) / CHUNK_ALIGN) * CHUNK_ALIGN)
    return chunk, math.ceil(s_max / chunk)


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0) -> torch.Tensor:
    """q (B,H,D) x caches (B,S_max,KV,D) -> (B,H,D), masked to ``cache_len``
    (int, () or (B,)) valid entries; ``window > 0`` also masks entries
    before ``cache_len - window``."""
    if q.device.type == "cpu":
        return ref.decode_gqa(q, k_cache, v_cache, cache_len, window=window)
    check_operands("decode_attention", {"q": q, "k_cache": k_cache, "v_cache": v_cache})
    b, h, d = q.shape
    s_max, kv = k_cache.shape[1], k_cache.shape[2]
    if (k_cache.shape != v_cache.shape or k_cache.shape[0] != b or k_cache.shape[3] != d
            or h % kv):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)} are not GQA-compatible")
    if h // kv > MAX_GROUP:
        raise ValueError(f"decode_attention: group {h // kv} > {MAX_GROUP}")
    if window < 0:
        raise ValueError(f"decode_attention: window={window}")
    if isinstance(cache_len, int):  # a fill on the card, no host-to-device copy
        lens = torch.full((b,), cache_len, dtype=torch.int32, device=q.device)
    else:
        lens = torch.as_tensor(cache_len, device=q.device).to(torch.int32)
        lens = lens.expand(b).contiguous() if lens.ndim == 0 else lens.contiguous()
    if lens.shape != (b,):
        raise ValueError(f"decode_attention: cache_len of shape {tuple(lens.shape)}, want ({b},)")
    chunk, n_split = split_plan(b, kv, s_max)
    g = h // kv
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    part_m = torch.empty((b, kv, n_split, g), dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b, kv, n_split, g, d), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
            out.data_ptr(), part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
            DTYPE_CODES[q.dtype], b, h, kv, d, s_max, chunk, n_split, int(window),
            ref.softmax_scale(d), *q.stride()[:2], *k_cache.stride()[:3], *v_cache.stride()[:3],
            *out.stride()[:2], stream_handle(q),
        )
    raise_on_error("decode_attention", err)
    global launches
    launches += 1
    return out
