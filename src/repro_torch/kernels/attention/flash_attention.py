"""Flash attention for prefill and training: wrapper of the CUDA kernels in
``csrc/flash_attention_sm90.cu`` and ``csrc/flash_attention.cu`` (they
replace the Pallas kernel
``repro/kernels/attention/flash_attention.py::flash_attention``) and of its
backward, ``csrc/flash_attention_bwd.cu`` (the Pallas kernel has none:
``jax.grad`` differentiates the plain route).

The route is chosen by dtype before the launch (``route``): bfloat16 runs
on the tensor cores (``wgmma`` fed by TMA, ``flash_attention_sm90.cu``, and
so does the backward); float32 runs on the FMA pipes
(``flash_attention.cu`` and the backward's float32 kernels), since a TF32
product would miss float32's tolerance.  Each route launches its kernel or
raises; neither falls back to the other or to the plain version.

On a CPU tensor the wrapper computes the plain version, ``ref.flash_plain``,
with native autograd.  On the card a call that autograd records goes
through ``FlashAttentionFn``: the forward kernel also writes each row's
log-sum-exp, and the backward is ``flash_attention_bwd``, the backward
kernel (dq, dk, dv from q, k, v, the output, the log-sum-exp and the
output's cotangent; no S x S tensor).  A call that autograd does not record
(serving) launches the forward alone, without the log-sum-exp.  On ``meta``
tensors it checks the operands as for a launch, returns the outputs' shapes
and counts ``cost`` (``_common.count_meta_call``), and under autograd
``cost_backward`` as one ``flash_attention_bwd`` call.  ``launches`` counts
the forward kernel's launches this process made, those of a recomputed
forward (``torch.utils.checkpoint``) too; ``bwd_launches`` the backward's.

On DTensor operands (``_sharded``) batch and head shards are local.  Under
GQA each rank's query heads get exactly the kv heads they read: kv heads
sharded as the query heads are, or replicated K/V sliced to the local
heads' group.  A sequence-sharded q gathers K/V once along the sequence and
runs with its shard's ``q_offset``, so the causal band stays right.  The
local calls reach ``FlashAttentionFn`` as any other call does.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.kernels import _build
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.placement_types import Replicate, Shard

from repro_torch.kernels._common import (DTYPE_CODES, Cost, check_placements, count_meta_call,
                                         even_shards, partial_on, raise_on_error,
                                         replicate_dims, resolve_partial, shard_index,
                                         sharded_call, stream_handle, unit_dims_replicated)
from repro_torch.kernels.attention import ref
from repro_torch.kernels.attention._common import check_operands, kv_group_slice

ROUTES = {torch.bfloat16: "wgmma", torch.float32: "fma"}
_ENTRIES = {"wgmma": "repro_flash_attention_sm90", "fma": "repro_flash_attention",
            "bwd": "repro_flash_attention_bwd"}
_ARGTYPES = {
    "fwd": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
            + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]),
    "bwd": ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 24
            + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]),
}

launches = 0
bwd_launches = 0
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
        fn.argtypes = _ARGTYPES["bwd" if name == "bwd" else "fwd"]
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
         q_offset: int, dtype: torch.dtype, lse: bool = False) -> Cost:
    """One call's least work: the two products over the pairs inside the
    band, 4·B·H·D per pair, and q, k, v read and the output written once
    (with ``lse``, also the float32 log-sum-exp, B·H·S_q values)."""
    n = pairs(s_q, s_kv, causal=causal, window=window, q_offset=q_offset)
    return Cost({dtype: 4.0 * b * h * d * n},
                (2 * b * s_q * h + 2 * b * s_kv * kv) * d * dtype.itemsize
                + (4 * b * h * s_q if lse else 0))


def cost_backward(b: int, s_q: int, s_kv: int, h: int, kv: int, d: int, *, causal: bool,
                  window: int, q_offset: int, dtype: torch.dtype) -> Cost:
    """One backward call's least work: twice the forward's products (one
    per operand of each, ``Cost.with_backward``), and q, k, v, the output,
    its cotangent and the float32 log-sum-exp read, dq, dk and dv written
    once."""
    n = pairs(s_q, s_kv, causal=causal, window=window, q_offset=q_offset)
    return Cost({dtype: 8.0 * b * h * d * n},
                (4 * b * s_q * h + 4 * b * s_kv * kv) * d * dtype.itemsize + 4 * b * h * s_q)


# The backward's tiles (keys or query rows): on the bf16 route a block owns
# 128 rows (64 at D = 256) and streams tiles of 64; on the float32 route 32
# and 32.  The Δ pass's rows per block; the sum pass's threads.
BWD_STREAM_TILE = {"wgmma": 64, "fma": 32}
_DELTA_ROWS = 8
_SUM_THREADS = 256


def bwd_own_tile(route_: str, d: int) -> int:
    """Rows (keys of a dK/dV block, query rows of a dQ block) a backward
    block owns."""
    return 32 if route_ == "fma" else 64 if d == 256 else 128


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """One backward call's launches, as ``csrc/flash_attention_bwd.cu`` makes
    them: ``kernels`` in launch order with their ``grids`` (blocks, x-major:
    the bf16 passes are 1-D), and the float32 scratch the bf16 route's dK/dV
    pass writes each query head's dK and dV to where G > 1 (``None`` at G =
    1 and on the float32 route, whose dK/dV blocks loop over the group)."""
    route: str
    b: int
    s_q: int
    s_kv: int
    h: int
    kv: int
    d: int
    causal: bool
    window: int
    q_offset: int
    kernels: tuple[str, ...]
    grids: tuple[tuple[int, int, int], ...]
    scratch_shape: tuple[int, ...] | None

    @property
    def own_tile(self) -> int:
        return bwd_own_tile(self.route, self.d)

    @property
    def stream_tile(self) -> int:
        return BWD_STREAM_TILE[self.route]

    @property
    def dkdv_blocks(self) -> int:
        return math.prod(self.grids[1])

    @property
    def dq_blocks(self) -> int:
        return math.prod(self.grids[-1])

    @property
    def scratch_bytes(self) -> int:
        return 0 if self.scratch_shape is None else 4 * math.prod(self.scratch_shape)


def bwd_plan(b: int, s_q: int, s_kv: int, h: int, kv: int, d: int, *, causal: bool,
             window: int, q_offset: int, dtype: torch.dtype) -> BwdPlan:
    """The launches of one ``flash_attention_bwd`` call: the Δ pass; the
    dK/dV pass, on the bf16 route one block per (key tile, query head,
    batch row) and, where G = H / KV > 1, the pass that sums each group's G
    heads of its scratch in head order; the dQ pass, one block per (query
    tile, head, batch row), each tile ``bwd_own_tile`` rows.  On the
    float32 route the dK/dV pass has one block per (key tile, kv head,
    batch row)."""
    r = route(dtype)
    t = bwd_own_tile(r, d)
    n_k, n_q = -(-s_kv // t), -(-s_q // t)
    delta = (-(-b * h * s_q // _DELTA_ROWS), 1, 1)
    if r == "fma":
        kernels = ("delta_kernel", "dkdv_fma_kernel", "dq_fma_kernel")
        grids = (delta, (n_k, kv, b), (n_q, h, b))
        scratch = None
    else:
        grouped = h > kv
        sum_pass = ("dkdv_sum_kernel",) if grouped else ()
        kernels = ("delta_kernel", "dkdv_sm90_kernel", *sum_pass, "dq_sm90_kernel")
        sums = ((-(-b * s_kv * kv * d // 4 // _SUM_THREADS), 1, 1),) if grouped else ()
        grids = (delta, (n_k * b * h, 1, 1)) + sums + ((n_q * b * h, 1, 1),)
        scratch = (2, b, s_kv, h, d) if grouped else None
    return BwdPlan(r, b, s_q, s_kv, h, kv, d, causal, window, q_offset, kernels, grids, scratch)


def _streamed_tiles(plan: BwdPlan, own: np.ndarray, dq: bool) -> tuple[np.ndarray, np.ndarray]:
    """The first streamed tile and the number of them for blocks whose own
    tile is ``own``: the query tiles that see keys own·T .. own·T + T − 1
    (dK/dV) or the key tiles rows own·T .. see (dQ), T the own tile's rows,
    as the kernel's ``queries_seeing`` and ``keys_seen`` bound its loop."""
    t, off = plan.own_tile, plan.q_offset
    p0 = own * t
    if dq:
        q_last = np.minimum(p0 + t, plan.s_q) - 1 + off
        end = np.minimum(plan.s_kv, q_last + 1) if plan.causal else np.full_like(p0, plan.s_kv)
        begin = np.maximum(0, p0 + off - plan.window + 1) if plan.window > 0 else np.zeros_like(p0)
    else:
        k_last = np.minimum(p0 + t, plan.s_kv) - 1
        begin = np.maximum(0, p0 - off) if plan.causal else np.zeros_like(p0)
        end = np.full_like(p0, plan.s_q)
        if plan.window > 0:
            end = np.minimum(end, np.maximum(0, k_last + plan.window - off))
    u = plan.stream_tile
    first = begin // u
    return first, np.where(end > begin, -(-end // u) - first, 0)


def bwd_blocks(plan: BwdPlan, dq: bool) -> np.ndarray:
    """The bf16 route's blocks of the dK/dV pass (``dq`` False) or the dQ
    pass, in launch order: rows (own tile, query head, batch row, streamed
    tiles), decoded from the block index as the kernel decodes it (tile
    major, heads fastest; the tiles with the most streamed tiles first:
    under the causal mask the first key tiles and the last query tiles,
    else the other way round)."""
    if plan.route != "wgmma":
        raise ValueError("bwd_blocks: the float32 route's grids are 3-D (tile, head, batch)")
    n_own = -(-(plan.s_q if dq else plan.s_kv) // plan.own_tile)
    idx = np.arange(n_own * plan.b * plan.h, dtype=np.int64)
    per = plan.b * plan.h
    ord_, b, h = idx // per, (idx % per) // plan.h, idx % plan.h
    own = ord_ if plan.causal != dq else n_own - 1 - ord_
    _, steps = _streamed_tiles(plan, own, dq)
    return np.stack([own, h, b, steps], axis=1)


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with its backward kernel.

    ``forward(ctx, fwd, bwd, kwargs, q, k, v)`` returns the output of
    ``fwd(q, k, v, **kwargs)``, which returns (output, float32 log-sum-exp
    (B, H, S_q)), and saves q, k, v, the output and the log-sum-exp;
    ``backward`` returns ``bwd(q, k, v, out, lse, dout, **kwargs)``: dq, dk
    and dv.  On the card ``fwd`` and ``bwd`` are the kernels' wrappers
    (``meta``: their meta routes); a test injects ``ref.flash_plain_lse``
    and ``ref.flash_bwd_plain`` to hold the Function against native
    autograd on the CPU."""

    @staticmethod
    def forward(ctx, fwd, bwd, kwargs, q, k, v):
        out, lse = fwd(q, k, v, **kwargs)
        ctx.bwd, ctx.kwargs = bwd, kwargs
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ctx.bwd(q, k, v, out, lse, dout.contiguous(), **ctx.kwargs)
        return None, None, None, dq, dk, dv


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """q (B,S_q,H,D), k/v (B,S_kv,KV,D) -> (B,S_q,H,D) in q's dtype.

    On the card a call that autograd records goes through
    ``FlashAttentionFn``: the forward kernel with the log-sum-exp, and the
    backward kernel.  Otherwise the forward kernel runs alone."""
    kwargs = {"causal": causal, "window": window, "q_offset": q_offset}
    if isinstance(q, DTensor):
        return _sharded(q, k, v, **kwargs)
    if q.device.type == "cpu":
        return ref.flash_plain(q, k, v, **kwargs)
    meta = q.device.type == "meta"
    if not ref.records(q, k, v):
        return (_meta if meta else _launch)(q, k, v, **kwargs)
    if meta:
        return FlashAttentionFn.apply(functools.partial(_meta, lse=True), _meta_bwd, kwargs,
                                      q, k, v)
    return FlashAttentionFn.apply(functools.partial(_launch, lse=True), flash_attention_bwd,
                                  kwargs, q, k, v)


def _shards(t, dim: int) -> int:
    """The shards of ``t``'s dim ``dim`` over the mesh."""
    return math.prod(t.device_mesh.size(i) for i, p in enumerate(t.placements)
                     if isinstance(p, Shard) and p.dim == dim)


def _resolve_partials(q, k, v):
    """q, k and v with every pending sum reduced: on a mesh dim where one
    side is a batch or head ``Shard``, the other's to its counterpart
    (heads to kv heads where they divide, else replicated), q otherwise to
    a head shard where the heads divide; where both
    are pending, q to a head shard and K/V to a kv-head shard where the
    heads divide, else replicated."""
    mesh = q.device_mesh
    tq, tk = {}, {}
    # The heads (kv heads) left to shard: what the shards so far leave.
    h = q.shape[2] // _shards(q, 2)
    kv = k.shape[2] // _shards(k, 2)
    for i, (a, b) in enumerate(zip(q.placements, k.placements)):
        n = mesh.size(i)
        heads = Shard(2) if h % n == 0 else Replicate()
        kv_heads = Shard(2) if kv % n == 0 else Replicate()
        a_shard = a.dim if isinstance(a, Shard) else None
        b_shard = b.dim if isinstance(b, Shard) else None
        tq[i] = Shard(b_shard) if b_shard in (0, 2) else heads
        tk[i] = {0: Shard(0), 2: kv_heads}.get(a_shard, Replicate())
        if a.is_partial() and b.is_partial():
            tk[i] = kv_heads if isinstance(heads, Shard) else Replicate()
        if a.is_partial() and tq[i] == Shard(2):
            h //= n
        if b.is_partial() and tk[i] == Shard(2):
            kv //= n
    return (resolve_partial(q, tq), resolve_partial(k, tk), resolve_partial(v, tk))


def _sharded(q, k, v, *, causal: bool, window: int, q_offset: int):
    """The DTensor route.  Per mesh dim, (q, k/v) placements handled:
    (Shard(0), Shard(0)) batch; (Shard(2), Shard(2)) heads; (Shard(2),
    Replicate) heads over replicated K/V, sliced to the local heads' kv
    group; (Shard(1), Replicate) a sequence shard of q at its offset;
    (Replicate, Replicate).  K/V sharded on the sequence are gathered along
    it first; a pending sum is reduced first (``_resolve_partials``).
    Anything else raises."""
    name = "flash_attention"
    if not isinstance(k, DTensor) or not isinstance(v, DTensor):
        raise ValueError(f"{name}: q is a DTensor; k and v must be DTensors")
    q, k, v = (unit_dims_replicated(t) for t in (q, k, v))
    q, k, v = _resolve_partials(q, k, v)
    # K/V sharded on the sequence are gathered once along it (a q sequence
    # shard then runs at its offset; cross attention reads every frame).
    k, v = (replicate_dims(t, [i for i, p in enumerate(t.placements)
                               if isinstance(p, Shard) and p.dim == 1]) for t in (k, v))
    if k.placements != v.placements:
        raise ValueError(f"{name}: k {k.placements} and v {v.placements} differ")
    check_placements(name, "q", q, (0, 1, 2))
    check_placements(name, "k", k, (0, 2))
    for t in (q, k):
        even_shards(name, t)
    mesh = q.device_mesh
    heads, kv_heads, seq = [], [], []
    for i, (a, b) in enumerate(zip(q.placements, k.placements)):
        qd = a.dim if isinstance(a, Shard) else None
        kd = b.dim if isinstance(b, Shard) else None
        if qd == 1 and kd is None:
            seq.append(i)
        elif qd == 2 and kd in (2, None):
            heads.append(i)
            if kd == 2:
                kv_heads.append(i)
        elif qd != kd or qd not in (0, None):
            raise ValueError(f"{name}: q {q.placements} with k/v {k.placements} on mesh dim {i}")
    if kv_heads and kv_heads != heads:
        raise ValueError(f"{name}: kv heads sharded on mesh dims {kv_heads}, query heads on "
                         f"{heads}")
    h, kv = q.shape[2], k.shape[2]
    kv_slice = None
    if heads and not kv_heads:  # replicated K/V: the local heads' groups
        kv_slice = kv_group_slice(h, kv, *shard_index(mesh, heads))
    n_seq, r_seq = shard_index(mesh, seq)
    offset = q_offset + r_seq * (q.shape[1] // n_seq)

    def local(ql, kl, vl):
        if kv_slice is not None:
            kl, vl = kl[:, :, kv_slice[0]:kv_slice[1]], vl[:, :, kv_slice[0]:kv_slice[1]]
        return flash_attention(ql, kl, vl, causal=causal, window=window, q_offset=offset)

    read_in_part = seq + (heads if kv_slice is not None else [])
    kv_grad = partial_on(k.placements, read_in_part)
    return sharded_call(local, (q, k, v), (q.placements, k.placements, v.placements),
                        [q.placements], (q.placements, kv_grad, kv_grad))


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


def _lse_like(q) -> torch.Tensor:
    b, s_q, h, _ = q.shape
    return torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)


def _meta(q, k, v, *, causal: bool, window: int, q_offset: int, lse: bool = False):
    """The meta route: the output's shape (and the log-sum-exp's with
    ``lse``), and the call's ``cost`` counted."""
    _check(q, k, v, window, q_offset, "meta")
    b, s_q, h, d = q.shape
    count_meta_call("flash_attention", cost(b, s_q, k.shape[1], h, k.shape[2], d, causal=causal,
                                            window=window, q_offset=q_offset, dtype=q.dtype,
                                            lse=lse))
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    return (out, _lse_like(q)) if lse else out


def _launch(q, k, v, *, causal: bool, window: int, q_offset: int, lse: bool = False):
    """One launch of the kernel for ``route(q.dtype)``; with ``lse`` it also
    returns each row's float32 log-sum-exp, (B, H, S_q)."""
    _check(q, k, v, window, q_offset, "cuda")
    b, s_q, h, d = q.shape
    s_kv, kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse_t = _lse_like(q) if lse else None
    with torch.cuda.device(q.device):
        err = _kernel(route(q.dtype))(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s_q, s_kv, h, kv, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            int(causal), int(window), int(q_offset), ref.softmax_scale(d),
            None if lse_t is None else lse_t.data_ptr(), stream_handle(q),
        )
    raise_on_error("flash_attention", err)
    global launches
    launches += 1
    return (out, lse_t) if lse else out


def _check_bwd(q, k, v, out, lse, dout, window: int, q_offset: int, device_type: str) -> None:
    _check(q, k, v, window, q_offset, device_type)
    check_operands("flash_attention_bwd", {"q": q, "out": out, "dout": dout}, device_type)
    b, s_q, h, _ = q.shape
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)}, out {tuple(out.shape)}, "
                         f"dout {tuple(dout.shape)} differ")
    if (lse.shape != (b, h, s_q) or lse.dtype != torch.float32 or not lse.is_contiguous()
            or lse.device != q.device):
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} {lse.dtype} on "
                         f"{lse.device}; want a contiguous float32 ({b}, {h}, {s_q}) on "
                         f"{q.device}")


def _plan_of(q, k, *, causal: bool, window: int, q_offset: int) -> BwdPlan:
    b, s_q, h, d = q.shape
    return bwd_plan(b, s_q, k.shape[1], h, k.shape[2], d, causal=causal, window=window,
                    q_offset=q_offset, dtype=q.dtype)


def _scratch(plan: BwdPlan, lse) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The Δ scratch and the plan's dK/dV scratch, live beside the
    gradients during the launch."""
    acc = (None if plan.scratch_shape is None else
           torch.empty(plan.scratch_shape, dtype=torch.float32, device=lse.device))
    return torch.empty_like(lse), acc


def _meta_bwd(q, k, v, out, lse, dout, *, causal: bool, window: int, q_offset: int):
    """The backward's meta route: dq, dk, dv and the scratch allocated, and
    ``cost_backward`` counted as one ``flash_attention_bwd`` call."""
    _check_bwd(q, k, v, out, lse, dout, window, q_offset, "meta")
    b, s_q, h, d = q.shape
    count_meta_call("flash_attention_bwd", cost_backward(
        b, s_q, k.shape[1], h, k.shape[2], d, causal=causal, window=window, q_offset=q_offset,
        dtype=q.dtype))
    grads = tuple(torch.empty_like(t, memory_format=torch.contiguous_format) for t in (q, k, v))
    _scratch(_plan_of(q, k, causal=causal, window=window, q_offset=q_offset), lse)
    return grads


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq, dk, dv (in the inputs' dtype) of ``flash_attention(q, k, v)``
    from its output ``out``, its float32 log-sum-exp ``lse`` (B, H, S_q)
    and the output's cotangent ``dout``: one call of the backward kernel
    for ``route(q.dtype)``, its launches as ``bwd_plan`` lays them out (the
    Δ pass, the dK/dV pass, on the bf16 route at G > 1 the sum of its
    per-head scratch, the dQ pass).  Raises on what the kernel does not
    take."""
    _check_bwd(q, k, v, out, lse, dout, window, q_offset, "cuda")
    b, s_q, h, d = q.shape
    s_kv, kv = k.shape[1], k.shape[2]
    plan = _plan_of(q, k, causal=causal, window=window, q_offset=q_offset)
    grads = tuple(torch.empty_like(t, memory_format=torch.contiguous_format) for t in (q, k, v))
    delta, acc = _scratch(plan, lse)
    with torch.cuda.device(q.device):
        err = _kernel("bwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(g.data_ptr() for g in grads),
            DTYPE_CODES[q.dtype], b, s_q, s_kv, h, kv, d,
            *(st for t in (q, k, v, out, dout, *grads) for st in t.stride()[:3]),
            int(causal), int(window), int(q_offset), ref.softmax_scale(d),
            None if acc is None else acc.data_ptr(), plan.dkdv_blocks, plan.dq_blocks,
            stream_handle(q),
        )
    raise_on_error("flash_attention_bwd", err)
    global bwd_launches
    bwd_launches += 1
    return grads
