"""Mamba-2 SSD chunked scan: wrapper of the CUDA kernel in
``csrc/ssd_scan.cu`` (replaces the Pallas kernel
``repro/kernels/ssd/ssd_scan.py::ssd``).

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it computes the plain version, ``ref.ssd_chunked``.  ``launches`` counts
the kernel launches (one chunk-state, state-passing and chunk-scan pass
each) this process made.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import DTYPE_CODES, raise_on_error, stream_handle
from repro_torch.kernels.ssd import ref

HEAD_DIMS = (16, 32, 64)   # P
MAX_STATE = 128            # N
MAX_CHUNK = 128
KERNEL_CHUNK = 64          # the kernel's own chunk; the function does not depend on it

launches = 0
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.library().repro_ssd_scan
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
            + [ctypes.c_void_p]
        )
        _fn = fn
    return _fn


def _check(x, dt, A, Bm, Cm, D, h0, chunk):
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    tensors = {"x": x, "dt": dt, "A": A, "Bm": Bm, "Cm": Cm, "D": D}
    if h0 is not None:
        tensors["h0"] = h0
    for arg, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"ssd: {arg} is on {t.device}, the kernel needs a CUDA tensor")
        if t.device != x.device:
            raise ValueError(f"ssd: {arg} is on {t.device}, not {x.device}")
    if x.dtype not in DTYPE_CODES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"ssd: x, Bm, Cm are {x.dtype}, {Bm.dtype}, {Cm.dtype}; the kernel "
                         f"takes one dtype of {list(DTYPE_CODES)} for the three")
    if (dt.shape != (b, s, h) or A.shape != (h,) or D.shape != (h,)
            or Bm.shape != (b, s, n) or Cm.shape != Bm.shape
            or (h0 is not None and h0.shape != (b, h, p, n))):
        raise ValueError(f"ssd: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)}, D "
                         f"{tuple(D.shape)}, h0 {None if h0 is None else tuple(h0.shape)} "
                         "do not agree")
    if p not in HEAD_DIMS:
        raise ValueError(f"ssd: head dim P={p} not in {HEAD_DIMS}")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"ssd: state dim N={n} outside 1..{MAX_STATE}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssd: chunk={chunk} outside 1..{MAX_CHUNK}")
    if s < 1 or b < 1 or h < 1:
        raise ValueError(f"ssd: empty input of shape {tuple(x.shape)}")
    for arg, t in (("x", x), ("dt", dt), ("Bm", Bm), ("Cm", Cm)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssd: {arg} with strides {t.stride()} has a strided last dim")
    for arg, t in (("A", A), ("D", D), ("h0", h0)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"ssd: {arg} with strides {t.stride()} is not contiguous")


def ssd(x, dt, A, Bm, Cm, D, h0=None, *, chunk: int = 64):
    """x (B,S,H,P), dt (B,S,H), A/D (H,), Bm/Cm (B,S,N) single group,
    optional h0 (B,H,P,N) -> (y (B,S,H,P) in x's dtype, h_final (B,H,P,N) f32)."""
    if x.device.type == "cpu":
        return ref.ssd_chunked(x, dt, A, Bm, Cm, D, h0=h0, chunk=chunk)
    # The reference kernel's casts (ssd_scan.py:128-131); h0 is float32 too.
    dt, A, D = dt.float(), A.float(), D.float()
    h0 = None if h0 is None else h0.float()
    _check(x, dt, A, Bm, Cm, D, h0, chunk)
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    nc = -(-s // KERNEL_CHUNK)
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    h_final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    states = torch.empty((b, h, nc, p, n), dtype=torch.float32, device=x.device)
    a_tot = torch.empty((b, h, nc), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernel()(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            D.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
            h_final.data_ptr(), states.data_ptr(), a_tot.data_ptr(),
            DTYPE_CODES[x.dtype], b, s, h, p, n, *x.stride()[:3], *dt.stride()[:2],
            *Bm.stride()[:2], *Cm.stride()[:2], stream_handle(x),
        )
    raise_on_error("ssd", err)
    global launches
    launches += 1
    return y, h_final
