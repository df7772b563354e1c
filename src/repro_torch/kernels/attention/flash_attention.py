"""Flash attention for prefill: wrapper of the CUDA kernels in
``csrc/flash_attention_sm90.cu`` and ``csrc/flash_attention.cu`` (they
replace the Pallas kernel
``repro/kernels/attention/flash_attention.py::flash_attention``).

The route is chosen by dtype before the launch (``route``): bfloat16 runs
on the tensor cores (``wgmma`` fed by TMA, ``flash_attention_sm90.cu``);
float32 runs on the FMA pipes (``flash_attention.cu``), since a TF32
product would miss float32's tolerance.  Each route launches its kernel or
raises; neither falls back to the other or to the plain version.

On a CPU tensor the wrapper computes the plain version, ``ref.flash_plain``.
On the card the kernel's output carries the plain version's gradient
(``_common.PlainGrad``), so training runs the kernel in every forward.
On ``meta`` tensors it checks the operands as for a launch, returns the
output's shape and counts ``cost`` (``_common.count_meta_call``); under
autograd the backward is again the plain version's, on meta.
``launches`` counts the kernel launches this process made, those of a
recomputed forward (``torch.utils.checkpoint``) too.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (Cost, PlainGrad, count_meta_call, raise_on_error,
                                         stream_handle)
from repro_torch.kernels.attention import ref
from repro_torch.kernels.attention._common import check_operands

ROUTES = {torch.bfloat16: "wgmma", torch.float32: "fma"}
_ENTRIES = {"wgmma": "repro_flash_attention_sm90", "fma": "repro_flash_attention"}

launches = 0
_fns: dict[str, object] = {}


def route(dtype: torch.dtype) -> str:
    """The kernel that computes ``dtype``: ``"wgmma"`` or ``"fma"``."""
    if dtype not in ROUTES:
        raise ValueError(f"flash_attention: dtype {dtype}; the kernels take {list(ROUTES)}")
    return ROUTES[dtype]


def _kernel(name: str):
    if name not in _fns:
        fn = getattr(_build.library(), _ENTRIES[name])
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
            + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
        )
        _fns[name] = fn
    return _fns[name]


def pairs(s_q: int, s_kv: int, *, causal: bool, window: int, q_offset: int) -> int:
    """The (query, key) pairs that ``ref.attention_mask`` lets through: the
    causal or window band's, all S_q·S_kv without either."""
    q_pos = np.arange(s_q, dtype=np.int64) + q_offset
    hi = np.minimum(q_pos, s_kv - 1) if causal else np.full(s_q, s_kv - 1)
    lo = np.maximum(q_pos - window + 1, 0) if window > 0 else np.zeros(s_q, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def cost(b: int, s_q: int, s_kv: int, h: int, kv: int, d: int, *, causal: bool, window: int,
         q_offset: int, dtype: torch.dtype) -> Cost:
    """One call's least work: the two products over the pairs inside the
    band, 4·B·H·D per pair, and q, k, v read and the output written once."""
    n = pairs(s_q, s_kv, causal=causal, window=window, q_offset=q_offset)
    return Cost({dtype: 4.0 * b * h * d * n},
                (2 * b * s_q * h + 2 * b * s_kv * kv) * d * dtype.itemsize)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """q (B,S_q,H,D), k/v (B,S_kv,KV,D) -> (B,S_q,H,D) in q's dtype.

    On the card the kernel computes the output and autograd differentiates
    it with the plain version's backward (``_common.PlainGrad``: recomputed
    from q, k and v; there is no backward kernel)."""
    kwargs = {"causal": causal, "window": window, "q_offset": q_offset}
    if q.device.type == "cpu":
        return ref.flash_plain(q, k, v, **kwargs)
    kernel = _meta if q.device.type == "meta" else _launch
    return PlainGrad.apply(kernel, ref.flash_plain, kwargs, q, k, v)


def _check(q, k, v, window: int, q_offset: int, device_type: str) -> None:
    check_operands("flash_attention", {"q": q, "k": k, "v": v}, device_type)
    b, s_q, h, d = q.shape
    s_kv, kv = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d or h % kv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not GQA-compatible")
    if s_q == 0 or s_kv == 0 or window < 0 or q_offset < 0:
        raise ValueError(f"flash_attention: S_q={s_q}, S_kv={s_kv}, window={window}, "
                         f"q_offset={q_offset}")


def _meta(q, k, v, *, causal: bool, window: int, q_offset: int) -> torch.Tensor:
    """The meta route: the output's shape, and the call's ``cost`` counted."""
    _check(q, k, v, window, q_offset, "meta")
    b, s_q, h, d = q.shape
    count_meta_call("flash_attention", cost(b, s_q, k.shape[1], h, k.shape[2], d, causal=causal,
                                            window=window, q_offset=q_offset, dtype=q.dtype))
    return torch.empty_like(q, memory_format=torch.contiguous_format)


def _launch(q, k, v, *, causal: bool, window: int, q_offset: int) -> torch.Tensor:
    """One launch of the kernel for ``route(q.dtype)``."""
    _check(q, k, v, window, q_offset, "cuda")
    b, s_q, h, d = q.shape
    s_kv, kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    with torch.cuda.device(q.device):
        err = _kernel(route(q.dtype))(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s_q, s_kv, h, kv, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            int(causal), int(window), int(q_offset), ref.softmax_scale(d), stream_handle(q),
        )
    raise_on_error("flash_attention", err)
    global launches
    launches += 1
    return out
