"""Mamba-2 SSD chunked scan: wrapper of the CUDA kernels in
``csrc/ssd_scan_sm90.cu`` and ``csrc/ssd_scan.cu`` (they replace the Pallas
kernel ``repro/kernels/ssd/ssd_scan.py::ssd``) and of its backward,
``csrc/ssd_scan_bwd.cu`` (the Pallas kernel has none: ``jax.grad``
differentiates the plain version, ``ref.ssd_chunked``).

The route is chosen by the dtype of x, B and C before the launch
(``plan``): bfloat16 runs on the tensor cores (``wgmma`` and ``mma.sync``)
in one launch with the state kept on chip (``ssd_scan_sm90.cu``, one block
per 16 of a head's P columns, B and C through TMA, so x, B and C need
16-byte aligned rows); float32 runs on the FMA pipes in three launches with
the chunk states in device memory (``ssd_scan.cu``), since a bf16 split of
float32 operands would not hold float32's tolerance.  The backward takes
routes by dtype too, in the four launches ``bwd_plan`` lays out: bf16 on
``wgmma`` and TMA with one block per (chunk, head group, batch row)
(``ssd_scan_bwd_sm90.cu``, which also needs dy's rows 16-byte aligned),
float32 on the FMA pipes (``ssd_scan_bwd.cu``).  Each route launches its
kernel or raises; neither falls back to the other or to the plain version.

On a CPU tensor the wrapper computes the plain version, ``ref.ssd_chunked``,
with native autograd.  On the card a call that autograd records goes
through ``SsdScanFn``: the forward kernel, and the backward kernel
(``ssd_scan_bwd``: dx, ddt, dA, dB, dC, dD and dh0 from the saved inputs
and the outputs' cotangents).  A call that autograd does not record
(serving) launches the forward alone.  On ``meta`` tensors it checks the
operands as for a launch, returns the outputs' shapes and counts ``cost``
(``_common.count_meta_call``), and under autograd ``cost_backward`` as one
``ssd_scan_bwd`` call.  ``launches`` counts the forward kernel's calls in
this process (one per call on either route), those of a recomputed forward
(``torch.utils.checkpoint``) too; ``bwd_launches`` the backward's.

On DTensor operands (``_sharded``) batch and head shards are local (A and
D follow x's heads); any other sharding of an operand raises.  The local
calls reach ``SsdScanFn`` as any other call does.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels import _build
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.placement_types import Replicate, Shard

from repro_torch.kernels._common import (DTYPE_CODES, Cost, count_meta_call, partial_on,
                                         raise_on_error, sharded_call, stream_handle,
                                         unit_dims_replicated)
from repro_torch.kernels.ssd import ref

HEAD_DIMS = (16, 32, 64)   # P
MAX_STATE = 128            # N
MAX_CHUNK = 128
KERNEL_CHUNK = 64          # both kernels' own chunk; the function does not depend on it
P_TILE = 16                # P columns per block of the tensor-core kernel

ROUTES = {torch.bfloat16: "mma", torch.float32: "fma"}
_ENTRIES = {"mma": "repro_ssd_scan_sm90", "fma": "repro_ssd_scan", "bwd": "repro_ssd_scan_bwd",
            "bwd_sm90": "repro_ssd_scan_bwd_sm90"}
_ARGTYPES = {
    "mma": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 9
           + [ctypes.c_void_p],
    "fma": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
           + [ctypes.c_void_p],
    "bwd": [ctypes.c_void_p] * 20 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
           + [ctypes.c_void_p],
    "bwd_sm90": [ctypes.c_void_p] * 20 + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 12
                + [ctypes.c_void_p],
}

launches = 0
bwd_launches = 0
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


def cost(b: int, s: int, h: int, p: int, n: int, *, chunk: int, h0: bool,
         dtype: torch.dtype) -> Cost:
    """One call's least work at the caller's ``chunk``: C·Bᵀ once per
    (batch row, chunk), since B and C are one group that all heads share;
    the gated products and the state's per head.  x read and y written in
    ``dtype``, dt (float32), B and C read, h0 read and the final state
    written in float32 once."""
    chunks = -(-s // chunk)
    flops = (2 * chunk * chunk * n * b * chunks
             + 2 * chunk * (chunk * p + 2 * n * p) * b * h * chunks)
    state = b * h * p * n * 4
    return Cost({dtype: float(flops)},
                2 * b * s * h * p * dtype.itemsize + b * s * h * 4
                + 2 * b * s * n * dtype.itemsize + (state if h0 else 0) + state)


def cost_backward(b: int, s: int, h: int, p: int, n: int, *, chunk: int, h0: bool,
                  dtype: torch.dtype, dh_final: bool = False) -> Cost:
    """One backward call's least work: twice the forward's products at the
    caller's ``chunk`` (one per operand of each, ``Cost.with_backward``),
    and x, dt, B, C and dy read, dx, ddt, dB and dC written once, with h0
    read and dh0 written where h0 is given and dh_final read where it is,
    all three in float32."""
    state = b * h * p * n * 4
    return Cost({dt: 2 * f for dt, f in cost(b, s, h, p, n, chunk=chunk, h0=h0,
                                               dtype=dtype).flops.items()},
                3 * b * s * h * p * dtype.itemsize + 2 * b * s * h * 4
                + 4 * b * s * n * dtype.itemsize + (2 * state if h0 else 0)
                + (state if dh_final else 0))


# The bf16 backward: a state slot is P x N padded to 64 x 128 (float32 part,
# or its bf16 hi + lo planes), the tile that its TMA copies and products
# take whatever P and N are; the passes over (chunk, head group, batch row)
# take the fewest groups that fill one wave of one block per SM, 132 being
# the SM count of the H100 SXM (there, at 4 x 4096, one group of 32 heads
# beat two of 16 by 7%; at 1 x 4096 three groups matched five).  The
# threads of a float32 pass's block and of the last pass's.
BWD_SLOT = 64 * 128
BWD_MIN_BLOCKS = 132
_BWD_THREADS = 256


@dataclass(frozen=True)
class BwdPlan:
    """One backward call's launches, as the C entries make them:
    ``kernels`` in launch order with their ``grids`` (x-major), the heads a
    block of the chunk-state and gradient passes takes (``group``; the
    float32 route's blocks take one) and the float32 ``scratch`` the
    wrapper allocates, in the C entry's order."""
    route: str
    b: int
    s: int
    h: int
    p: int
    n: int
    group: int
    kernels: tuple[str, ...]
    grids: tuple[tuple[int, int, int], ...]
    scratch: tuple[tuple[int, ...], ...]

    @property
    def groups(self) -> int:
        return -(-self.h // self.group)

    @property
    def scratch_bytes(self) -> int:
        return sum(4 * math.prod(shape) for shape in self.scratch)


def bwd_group(b: int, s: int, h: int) -> int:
    """The heads a bf16 backward block takes: as many as the fewest groups
    that give ``BWD_MIN_BLOCKS`` blocks of (chunk, group, batch row) allow
    (132, one block on each SM of an H100 SXM; one group per head where
    even that falls short).  Larger groups share
    more of each block's B, C and C·Bᵀ and need no group scratch; more
    blocks fill more of the card."""
    nc = -(-s // KERNEL_CHUNK)
    groups = min(h, -(-BWD_MIN_BLOCKS // (nc * b)))
    return -(-h // groups)


def bwd_plan(b: int, s: int, h: int, p: int, n: int, dtype: torch.dtype) -> BwdPlan:
    """The four launches of one ``ssd_scan_bwd`` call.  bf16: the chunk
    states' parts, one block per (chunk, head group, batch row); the walk
    over the chunks writing H[c] and G[c] as bf16 hi + lo planes, a thread
    per 8 values of a (head, batch row)'s 64 x 128 state; the gradients,
    one block per (chunk, head group, batch row); dA, dD and (several
    groups) the groups' dB and dC summed.  A block takes ``bwd_group``
    heads, the last group what is left.  float32: per (chunk, head, batch
    row) for the parts and the gradients, per 1024 (p, n) of a (head, batch
    row) for the walk, and dB, dC over the heads with dA, dD; its scratch
    holds each head's dB and dC."""
    r = route(dtype)
    nc = -(-s // KERNEL_CHUNK)
    bsn_blocks = -(-(b * s * n) // _BWD_THREADS)
    if r == "fma":
        return BwdPlan(r, b, s, h, p, n, 1,
                       ("ssd_bwd_states_kernel", "ssd_bwd_passing_kernel", "ssd_bwd_grads_kernel",
                        "ssd_bwd_reduce_kernel"),
                       ((nc, h, b), (-(-(p * n // 4) // _BWD_THREADS), h, b), (nc, h, b),
                        (bsn_blocks + 1, 1, 1)),
                       ((2, b, h, nc, p, n), (b, h, nc), (2, b, s, h, n), (2, b, nc, h)))
    g = bwd_group(b, s, h)
    groups = -(-h // g)
    scratch = ((2, b, h, nc, BWD_SLOT), (b, h, nc), (2, b, nc, h))
    if groups > 1:
        scratch += ((groups, 2, b, s, n),)
    return BwdPlan(r, b, s, h, p, n, g,
                   ("ssd_bwd_states_sm90_kernel", "ssd_bwd_passing_sm90_kernel",
                    "ssd_bwd_grads_sm90_kernel", "ssd_bwd_reduce_sm90_kernel"),
                   ((nc, groups, b), (BWD_SLOT // 8 // _BWD_THREADS, h, b), (nc, groups, b),
                    (bsn_blocks + 1 if groups > 1 else 1, 1, 1)),
                   scratch)


def grads_blocks(plan: BwdPlan) -> np.ndarray:
    """The (chunk, head, batch row) each block of the gradient pass takes,
    one row per pair, as the kernel decodes its block index: block (x, y,
    z) takes chunk x of batch row z and the heads y·group .. of its group,
    the last group what is left."""
    nc, groups, b = plan.grids[2]
    rows = [(c, hd, z) for z in range(b) for y in range(groups) for c in range(nc)
            for hd in range(y * plan.group, min(plan.h, (y + 1) * plan.group))]
    return np.array(rows, dtype=np.int64).reshape(-1, 3)


class SsdScanFn(torch.autograd.Function):
    """The SSD scan with its backward kernel.

    ``forward(ctx, fwd, bwd, kwargs, x, dt, A, Bm, Cm, D, h0)`` returns
    ``fwd(x, dt, A, Bm, Cm, D, h0, **kwargs)``, (y, the final state), and
    saves the inputs; ``backward`` returns ``bwd(x, dt, A, Bm, Cm, D, h0,
    dy, dh_final, **kwargs)``: the gradients of the seven inputs, each where
    its input needs one.  A cotangent that autograd does not need reaches
    ``bwd`` as None (in training the final state's always does).  On the
    card ``fwd`` and ``bwd`` are the kernels' wrappers (``meta``: their meta
    routes); a test injects ``ref.ssd_chunked`` and ``ref.ssd_bwd_plain``
    to hold the Function against native autograd on the CPU."""

    @staticmethod
    def forward(ctx, fwd, bwd, kwargs, x, dt, A, Bm, Cm, D, h0):
        ctx.bwd, ctx.kwargs = bwd, kwargs
        ctx.save_for_backward(x, dt, A, Bm, Cm, D, h0)
        ctx.set_materialize_grads(False)
        return fwd(x, dt, A, Bm, Cm, D, h0, **kwargs)

    @staticmethod
    def backward(ctx, dy, dh_final):
        needs = ctx.needs_input_grad[3:]
        inputs = ctx.saved_tensors
        grads = ctx.bwd(*inputs, None if dy is None else dy.contiguous(),
                        None if dh_final is None else dh_final.contiguous(),
                        **ctx.kwargs)
        return (None, None, None, *(g if need else None for g, need in zip(grads, needs)))


def _check(x, dt, A, Bm, Cm, D, h0, chunk, device_type: str = "cuda"):
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    tensors = {"x": x, "dt": dt, "A": A, "Bm": Bm, "Cm": Cm, "D": D}
    if h0 is not None:
        tensors["h0"] = h0
    for arg, t in tensors.items():
        if t.device.type != device_type:
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
    optional h0 (B,H,P,N) -> (y (B,S,H,P) in x's dtype, h_final (B,H,P,N) f32).

    On the card a call that autograd records goes through ``SsdScanFn``:
    the forward kernel, and the backward kernel for x, dt, A, Bm, Cm, D and
    h0.  Otherwise the forward kernel runs alone."""
    if isinstance(x, DTensor):
        return _sharded(x, dt, A, Bm, Cm, D, h0, chunk=chunk)
    if x.device.type == "cpu":
        return ref.ssd_chunked(x, dt, A, Bm, Cm, D, h0=h0, chunk=chunk)
    # The reference kernel's casts (ssd_scan.py:128-131); h0 is float32 too.
    dt, A, D = dt.float(), A.float(), D.float()
    h0 = None if h0 is None else h0.float()
    meta = x.device.type == "meta"
    fwd = _meta if meta else _launch
    inputs = (x, dt, A, Bm, Cm, D, h0)
    if not (torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs)):
        return fwd(*inputs, chunk=chunk)
    return SsdScanFn.apply(fwd, _meta_bwd if meta else ssd_scan_bwd, {"chunk": chunk}, *inputs)


def _sharded(x, dt, A, Bm, Cm, D, h0, *, chunk: int):
    """The DTensor route: on each mesh dim x is Shard(0) (batch: dt, Bm, Cm
    and h0 sharded with it), Shard(2) (heads: dt with it, A and D cut to the
    local heads, Bm and Cm replicated, h0 on its dim 1) or Replicate (all
    replicated).  Anything else raises."""
    args = {"x": x, "dt": dt, "A": A, "Bm": Bm, "Cm": Cm, "D": D}
    if h0 is not None:
        args["h0"] = h0
    for arg, t in args.items():
        if not isinstance(t, DTensor):
            raise ValueError(f"ssd: x is a DTensor and {arg} is not")
        args[arg] = unit_dims_replicated(t)
    x = args["x"]
    mesh = x.device_mesh
    want = {arg: [] for arg in args}
    y_pl, h_pl, head_dims, batch_dims = [], [], [], []
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == 0:
            dims = {"x": 0, "dt": 0, "Bm": 0, "Cm": 0, "h0": 0}
            batch_dims.append(i)
            y_pl.append(Shard(0))
            h_pl.append(Shard(0))
        elif isinstance(p, Shard) and p.dim == 2:
            dims = {"x": 2, "dt": 2, "A": 0, "D": 0, "h0": 1}
            head_dims.append(i)
            y_pl.append(Shard(2))
            h_pl.append(Shard(1))
        elif isinstance(p, Replicate):
            dims = {}
            y_pl.append(Replicate())
            h_pl.append(Replicate())
        else:
            raise ValueError(f"ssd: x has placement {p} on mesh dim {i}; the sharded route "
                             "takes Shard(0), Shard(2) or Replicate")
        for arg in args:
            want[arg].append(Shard(dims[arg]) if arg in dims else Replicate())
    for arg in ("A", "D"):  # replicated per-head vectors: the local heads' cut, no collective
        if args[arg].placements != tuple(want[arg]) and all(
                isinstance(p, Replicate) for p in args[arg].placements):
            args[arg] = args[arg].redistribute(mesh, want[arg])
    for arg, t in args.items():
        if t.placements != tuple(want[arg]):
            raise ValueError(f"ssd: {arg} has placements {t.placements} where x "
                             f"{x.placements} needs {tuple(want[arg])}")
    names = list(args)

    def local(*ts):
        kw = dict(zip(names, ts))
        return ssd(kw["x"], kw["dt"], kw["A"], kw["Bm"], kw["Cm"], kw["D"], kw.get("h0"),
                   chunk=chunk)

    in_pl = tuple(tuple(want[a]) for a in names)
    # Every head shard reads all of B and C, and every batch shard all of A
    # and D: their gradients are partial sums there.
    summed = {"Bm": head_dims, "Cm": head_dims, "A": batch_dims, "D": batch_dims}
    grad_pl = tuple(partial_on(pl, summed.get(a, [])) for a, pl in zip(names, in_pl))
    return sharded_call(local, tuple(args.values()), in_pl, [tuple(y_pl), tuple(h_pl)],
                        grad_pl)


def _meta(x, dt, A, Bm, Cm, D, h0, *, chunk: int):
    """The meta route: the outputs' shapes, and the call's ``cost`` counted."""
    _check(x, dt, A, Bm, Cm, D, h0, chunk, "meta")
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    count_meta_call("ssd", cost(b, s, h, p, n, chunk=chunk, h0=h0 is not None, dtype=x.dtype))
    return (torch.empty((b, s, h, p), dtype=x.dtype, device=x.device),
            torch.empty((b, h, p, n), dtype=torch.float32, device=x.device))


def _launch(x, dt, A, Bm, Cm, D, h0, *, chunk: int):
    """One call of the kernel for ``plan``'s route."""
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


def _check_bwd(x, dt, A, Bm, Cm, D, h0, dy, dh_final, chunk, device_type: str) -> None:
    _check(x, dt, A, Bm, Cm, D, h0, chunk, device_type)
    b, s, h, p = x.shape
    for arg, t in (("dt", dt), ("A", A), ("D", D), ("h0", h0), ("dh_final", dh_final)):
        if t is not None and t.dtype != torch.float32:
            raise ValueError(f"ssd_scan_bwd: {arg} is {t.dtype}; the kernel takes float32")
    if dy is not None and (dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device
                           or dy.stride(-1) != 1):
        raise ValueError(f"ssd_scan_bwd: dy {tuple(dy.shape)} {dy.dtype} on {dy.device} with "
                         f"strides {dy.stride()}; want x's shape {tuple(x.shape)} and dtype "
                         f"{x.dtype} on {x.device}, last dim contiguous")
    if dy is not None and route(x.dtype) == "mma":
        strides = dy.stride()[1:-1] + (dy.stride(0),) * (b > 1)
        if dy.data_ptr() % 16 or any(st % 8 for st in strides):
            raise ValueError(f"ssd_scan_bwd: bf16 dy at offset {dy.data_ptr() % 16} with strides "
                             f"{dy.stride()}: the kernel needs 16-byte aligned rows")
    if dh_final is not None and (dh_final.shape != (b, h, p, Bm.shape[-1])
                                 or dh_final.device != x.device
                                 or not dh_final.is_contiguous()):
        raise ValueError(f"ssd_scan_bwd: dh_final {tuple(dh_final.shape)} on "
                         f"{dh_final.device}; want a contiguous ({b}, {h}, {p}, "
                         f"{Bm.shape[-1]}) on {x.device}")


def _grads_like(x, dt, A, Bm, Cm, D, h0):
    """dx, ddt, dA, dBm, dCm, dD and dh0 (None without h0), each contiguous
    in its input's dtype."""
    return tuple(None if t is None else torch.empty(t.shape, dtype=t.dtype, device=t.device)
                 for t in (x, dt, A, Bm, Cm, D, h0))


def _plan_of(x, Bm) -> BwdPlan:
    b, s, h, p = x.shape
    return bwd_plan(b, s, h, p, Bm.shape[-1], x.dtype)


def _meta_bwd(x, dt, A, Bm, Cm, D, h0, dy, dh_final, *, chunk: int):
    """The backward's meta route: the gradients and the plan's scratch
    allocated, and ``cost_backward`` counted as one ``ssd_scan_bwd``
    call."""
    _check_bwd(x, dt, A, Bm, Cm, D, h0, dy, dh_final, chunk, "meta")
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    count_meta_call("ssd_scan_bwd", cost_backward(b, s, h, p, n, chunk=chunk, h0=h0 is not None,
                                                  dtype=x.dtype, dh_final=dh_final is not None))
    grads = _grads_like(x, dt, A, Bm, Cm, D, h0)
    # The scratch, live beside the gradients during the launch.
    scratch = [torch.empty(shape, dtype=torch.float32, device=x.device)
               for shape in _plan_of(x, Bm).scratch]
    del scratch
    return grads


def ssd_scan_bwd(x, dt, A, Bm, Cm, D, h0, dy, dh_final, *, chunk: int = 64):
    """(dx, ddt, dA, dBm, dCm, dD, dh0) of ``ssd(x, dt, A, Bm, Cm, D, h0)``
    from the cotangents of y (``dy``, x's dtype) and of the final state
    (``dh_final``, float32), either of which may be None (zero): one call of
    the backward kernel for ``route(x.dtype)``, its launches and scratch as
    ``bwd_plan`` lays them out.  dt, A, D and h0 are float32 (``ssd`` casts
    them).  Raises on what the kernel does not take."""
    _check_bwd(x, dt, A, Bm, Cm, D, h0, dy, dh_final, chunk, "cuda")
    b, s, h, p = x.shape
    pl = _plan_of(x, Bm)
    grads = _grads_like(x, dt, A, Bm, Cm, D, h0)
    scratch = [torch.empty(shape, dtype=torch.float32, device=x.device) for shape in pl.scratch]
    strides = (*x.stride()[:3], *dt.stride()[:2], *Bm.stride()[:2], *Cm.stride()[:2])
    with torch.cuda.device(x.device):
        if pl.route == "mma":
            if dy is None:  # a zero cotangent, for the tensor map
                dy = torch.zeros_like(x, memory_format=torch.contiguous_format)
            ptrs = [None if t is None else t.data_ptr()
                    for t in (x, dt, A, Bm, Cm, D, h0, dy, dh_final, *grads, *scratch)]
            ptrs += [None] * (20 - len(ptrs))  # no group scratch where one group covers H
            err = _kernel("bwd_sm90")(*ptrs, b, s, h, p, Bm.shape[-1], pl.group,
                                      math.prod(pl.grids[2]), pl.grids[3][0], *strides,
                                      *dy.stride()[:3], stream_handle(x))
        else:
            ptrs = [None if t is None else t.data_ptr()
                    for t in (x, dt, A, Bm, Cm, D, h0, dy, dh_final, *grads, *scratch)]
            dy_strides = (0, 0, 0) if dy is None else dy.stride()[:3]
            err = _kernel("bwd")(*ptrs, DTYPE_CODES[x.dtype], b, s, h, p, Bm.shape[-1], *strides,
                                 *dy_strides, stream_handle(x))
    raise_on_error("ssd_scan_bwd", err)
    global bwd_launches
    bwd_launches += 1
    return grads
