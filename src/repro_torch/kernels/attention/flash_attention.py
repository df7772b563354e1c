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
``launches`` counts the kernel launches this process made, those of a
recomputed forward (``torch.utils.checkpoint``) too.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import PlainGrad, raise_on_error, stream_handle
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


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """q (B,S_q,H,D), k/v (B,S_kv,KV,D) -> (B,S_q,H,D) in q's dtype.

    On the card the kernel computes the output and autograd differentiates
    it with the plain version's backward (``_common.PlainGrad``: recomputed
    from q, k and v; there is no backward kernel)."""
    kwargs = {"causal": causal, "window": window, "q_offset": q_offset}
    if q.device.type == "cpu":
        return ref.flash_plain(q, k, v, **kwargs)
    return PlainGrad.apply(_launch, ref.flash_plain, kwargs, q, k, v)


def _launch(q, k, v, *, causal: bool, window: int, q_offset: int) -> torch.Tensor:
    """One launch of the kernel for ``route(q.dtype)``."""
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
