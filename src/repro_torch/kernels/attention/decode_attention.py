"""One-token GQA decode attention: wrapper of the CUDA kernel in
``csrc/decode_attention.cu`` (replaces the Pallas kernel
``repro/kernels/attention/decode_attention.py::decode_attention``).

One launch per call, for float32 and bfloat16 alike: the chunks of the
cache that one (batch row, kv head) is split into form one thread-block
cluster and are merged inside it.  The kernel is chosen by dtype in the
C entry: bfloat16 runs both products on the tensor cores (``mma.sync``),
float32 on the FMA pipes (TF32 would miss float32's tolerance).  An int ``cache_len`` (the engine's case) goes
to the kernel as a scalar and only its valid range is split; a tensor
``cache_len`` of per-example lengths goes as a (B,) device tensor and
S_max is split.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it computes the plain version, ``ref.decode_gqa``.  ``launches`` counts the
kernel launches this process made.
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
# About one block per SM of an H100 (132 SMs): every cluster of chunks then
# runs in the first wave (at two per SM, clusters of 8 measured slower).
TARGET_BLOCKS = 128
CHUNK_ALIGN = 32       # the kernel's tile of cache entries
MAX_SPLIT = 8          # chunks per (batch row, kv head): the portable cluster size

launches = 0
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.library().repro_decode_attention
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p]
            + [ctypes.c_int] * 10 + [ctypes.c_float] + [ctypes.c_longlong] * 10
            + [ctypes.c_void_p]
        )
        _fn = fn
    return _fn


def valid_range(cache_len: int, s_max: int, window: int = 0) -> tuple[int, int]:
    """[begin, end) of the entries ``ref.decode_gqa`` attends to for one
    host-int length: below ``min(cache_len, s_max)`` and, with a window, at
    or after ``cache_len - window``."""
    end = min(cache_len, s_max)
    begin = max(cache_len - window, 0) if window > 0 else 0
    return begin, max(begin, end)


def split_plan(b: int, kv: int, length: int) -> tuple[int, int]:
    """(chunk, n_split): cut ``length`` entries into at most ``MAX_SPLIT``
    chunks that are multiples of 32 entries, with B·KV·n_split at most
    ``TARGET_BLOCKS`` where a split is possible; every chunk but the last
    is full and none is empty."""
    want = min(MAX_SPLIT, max(1, TARGET_BLOCKS // (b * kv)))
    chunk = max(CHUNK_ALIGN, math.ceil(math.ceil(length / want) / CHUNK_ALIGN) * CHUNK_ALIGN)
    return chunk, max(1, math.ceil(length / chunk))


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
    if isinstance(cache_len, int):  # a scalar argument: no device tensor, no copy
        lens, scalar_len = None, cache_len
        base, end = valid_range(cache_len, s_max, window)
        chunk, n_split = split_plan(b, kv, end - base)
    else:
        lens = torch.as_tensor(cache_len, device=q.device).to(torch.int32)
        lens = lens.expand(b).contiguous() if lens.ndim == 0 else lens.contiguous()
        if lens.shape != (b,):
            raise ValueError(f"decode_attention: cache_len of shape {tuple(lens.shape)}, "
                             f"want ({b},)")
        scalar_len, base = 0, 0
        chunk, n_split = split_plan(b, kv, s_max)
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            None if lens is None else lens.data_ptr(), scalar_len,
            out.data_ptr(),
            DTYPE_CODES[q.dtype], b, h, kv, d, s_max, base, chunk, n_split, int(window),
            ref.softmax_scale(d), *q.stride()[:2], *k_cache.stride()[:3],
            *v_cache.stride()[:3], *out.stride()[:2], stream_handle(q),
        )
    raise_on_error("decode_attention", err)
    global launches
    launches += 1
    return out
