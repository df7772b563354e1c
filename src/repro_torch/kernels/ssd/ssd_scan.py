"""Mamba-2 SSD chunked scan: wrapper of the CUDA kernels in
``csrc/ssd_scan_sm90.cu`` and ``csrc/ssd_scan.cu`` (they replace the Pallas
kernel ``repro/kernels/ssd/ssd_scan.py::ssd``).

The route is chosen by the dtype of x, B and C before the launch
(``plan``): bfloat16 runs on the tensor cores (``wgmma`` and ``mma.sync``)
in one launch with the state kept on chip (``ssd_scan_sm90.cu``, one block
per 16 of a head's P columns, B and C through TMA, so x, B and C need
16-byte aligned rows); float32 runs on the FMA pipes in three launches with
the chunk states in device memory (``ssd_scan.cu``), since a bf16 split of
float32 operands would not hold float32's tolerance.  Each route launches
its kernel or raises; neither falls back to the other or to the plain
version.

On a CPU tensor the wrapper computes the plain version, ``ref.ssd_chunked``.
``launches`` counts the calls that launched a kernel in this process (one
per call on either route).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import DTYPE_CODES, raise_on_error, stream_handle
from repro_torch.kernels.ssd import ref

HEAD_DIMS = (16, 32, 64)   # P
MAX_STATE = 128            # N
MAX_CHUNK = 128
KERNEL_CHUNK = 64          # both kernels' own chunk; the function does not depend on it
P_TILE = 16                # P columns per block of the tensor-core kernel

ROUTES = {torch.bfloat16: "mma", torch.float32: "fma"}
_ENTRIES = {"mma": "repro_ssd_scan_sm90", "fma": "repro_ssd_scan"}
_ARGTYPES = {
    "mma": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 9
           + [ctypes.c_void_p],
    "fma": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
           + [ctypes.c_void_p],
}

launches = 0
_fns: dict[str, object] = {}


@dataclass(frozen=True)
class Plan:
    """What one call on the card launches for x of shape (b, s, h, p)."""
    route: str                      # "mma" (bf16, tensor cores) or "fma" (float32)
    grid: tuple[int, int, int]      # blocks of the (first) launch, x-major
    kernels: int                    # device kernels per call
    scratch: tuple[tuple[int, ...], ...]  # float32 scratch the wrapper allocates


def route(dtype: torch.dtype) -> str:
    """The kernel that computes x, B and C of ``dtype``: ``"mma"`` or ``"fma"``."""
    if dtype not in ROUTES:
        raise ValueError(f"ssd: dtype {dtype}; the kernels take {list(ROUTES)}")
    return ROUTES[dtype]


def plan(b: int, s: int, h: int, p: int, n: int, dtype: torch.dtype) -> Plan:
    """The launch a call makes: on the bf16 route one block per (P tile of
    16, head, batch row) walking every chunk with its state slice on chip;
    on the float32 route one block per (chunk, head, batch row) in the first
    and last of three passes, with the chunk states in scratch."""
    r = route(dtype)
    if r == "mma":
        return Plan(r, (p // P_TILE, h, b), 1, ())
    nc = -(-s // KERNEL_CHUNK)
    return Plan(r, (nc, h, b), 3, ((b, h, nc, p, n), (b, h, nc)))


def _kernel(name: str):
    if name not in _fns:
        fn = getattr(_build.library(), _ENTRIES[name])
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
        _fns[name] = fn
    return _fns[name]


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
    if x.dtype not in ROUTES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"ssd: x, Bm, Cm are {x.dtype}, {Bm.dtype}, {Cm.dtype}; the kernel "
                         f"takes one dtype of {list(ROUTES)} for the three")
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
    if route(x.dtype) == "mma":
        # TMA and 16-byte copies: rows start 16-byte aligned.
        for arg, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
            strides = t.stride()[1:-1] + (t.stride(0),) * (b > 1)
            if t.data_ptr() % 16 or any(st % 8 for st in strides):
                raise ValueError(f"ssd: bf16 {arg} at offset {t.data_ptr() % 16} with strides "
                                 f"{t.stride()}: the kernel needs 16-byte aligned rows")


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
    pl = plan(b, s, h, p, n, x.dtype)
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    h_final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    scratch = [torch.empty(shape, dtype=torch.float32, device=x.device) for shape in pl.scratch]
    ptrs = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            D.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
            h_final.data_ptr())
    strides = (*x.stride()[:3], *dt.stride()[:2], *Bm.stride()[:2], *Cm.stride()[:2])
    with torch.cuda.device(x.device):
        if pl.route == "mma":
            err = _kernel("mma")(*ptrs, b, s, h, p, n, *pl.grid, *strides, stream_handle(x))
        else:
            err = _kernel("fma")(*ptrs, *(t.data_ptr() for t in scratch), DTYPE_CODES[x.dtype],
                                 b, s, h, p, n, *strides, stream_handle(x))
    raise_on_error("ssd", err)
    global launches
    launches += 1
    return y, h_final
