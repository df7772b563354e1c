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

On a CUDA tensor the wrapper launches the kernel or raises (also for a call
that asks for a gradient: the kernel has no backward); on a CPU tensor it
computes the plain version, ``ref.decode_gqa``; on ``meta`` tensors it
checks the operands as for a launch, returns the output's shape and counts
``cost`` (``_common.count_meta_call``).  ``launches`` counts the kernel
launches this process made.

On DTensor operands (``_sharded``) batch and head shards are local, as in
flash attention.  A cache sharded on its slots (the serve rules' ``kv_seq``)
is never gathered: each rank decodes its slot shard, given its slot offset,
with the log-sum-exp output on, and the shards are merged flash-decoding
style (``ref.merge_decode_shards``: an all-reduce of the max, one of the
rescaled sum and output).  A query sharded on heads over such a cache is
gathered first (B·H·D elements).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.placement_types import Replicate, Shard

from repro_torch.kernels._common import (DTYPE_CODES, Cost, check_placements, count_meta_call,
                                         even_shards, raise_on_error, resolve_partial,
                                         shard_index, sharded_call, stream_handle,
                                         unit_dims_replicated)
from repro_torch.kernels.attention import ref
from repro_torch.kernels.attention._common import check_operands, kv_group_slice

MAX_GROUP = 16         # query heads per kv head: one m16n8k16 A operand
# About one block per SM of an H100 (132 SMs): every cluster of chunks then
# runs in the first wave (at two per SM, clusters of 8 measured slower).
TARGET_BLOCKS = 128
CHUNK_ALIGN = 32       # the kernel's tile of cache entries
MAX_SPLIT = 8          # chunks per (batch row, kv head): the portable cluster size

launches = 0
_fn = None
_max_splits: dict[tuple, int] = {}


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.library().repro_decode_attention
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p]
            + [ctypes.c_int] * 10 + [ctypes.c_float] + [ctypes.c_longlong] * 10
            + [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
        )
        _fn = fn
    return _fn


def max_split(dtype: torch.dtype, d: int, group: int) -> int:
    """The most chunks per (batch row, kv head) the kernel takes for this
    dtype, head dim and group: ``MAX_SPLIT``, or fewer where the chunks'
    partials would not fit in shared memory beside the kernel's ring (the
    C entry ``repro_decode_max_split`` reads the kernel's sizes)."""
    key = (dtype, d, group)
    if key not in _max_splits:
        fn = _build.library().repro_decode_max_split
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 3
        n = fn(DTYPE_CODES[dtype], d, group)
        if n < 1:
            raise ValueError(f"decode_attention: no kernel takes {dtype}, head dim {d}, "
                             f"group {group}")
        _max_splits[key] = n
    return _max_splits[key]


def valid_range(cache_len: int, s_max: int, window: int = 0) -> tuple[int, int]:
    """[begin, end) of the entries ``ref.decode_gqa`` attends to for one
    host-int length: below ``min(cache_len, s_max)`` and, with a window, at
    or after ``cache_len - window``."""
    end = min(cache_len, s_max)
    begin = max(cache_len - window, 0) if window > 0 else 0
    return begin, max(begin, end)


def split_plan(b: int, kv: int, length: int, most: int = MAX_SPLIT) -> tuple[int, int]:
    """(chunk, n_split): cut ``length`` entries into at most ``most``
    chunks that are multiples of 32 entries, with B·KV·n_split at most
    ``TARGET_BLOCKS`` where a split is possible; every chunk but the last
    is full and none is empty."""
    want = min(most, max(1, TARGET_BLOCKS // (b * kv)))
    chunk = max(CHUNK_ALIGN, math.ceil(math.ceil(length / want) / CHUNK_ALIGN) * CHUNK_ALIGN)
    return chunk, max(1, math.ceil(length / chunk))


def cost(b: int, h: int, kv: int, d: int, s_max: int, cache_len: int, *, window: int,
         dtype: torch.dtype, lse: bool = False) -> Cost:
    """One call's least work over the ``valid_range`` entries (``cache_len``
    counted from the cache's entry 0: a slot shard's length less its slot
    offset): the two products, 4·B·H·D per entry; those entries of K and V,
    q, the output, the (B,) int32 lengths and the float32 log-sum-exp, where
    asked for, read or written once."""
    begin, end = valid_range(cache_len, s_max, window)
    n = end - begin
    return Cost({dtype: 4.0 * b * h * d * n},
                (2 * b * n * kv * d + 2 * b * h * d) * dtype.itemsize + 4 * b
                + (4 * b * h if lse else 0))


def _sharded(q, k_cache, v_cache, cache_len, *, window: int, return_lse: bool):
    """The DTensor route.  Per mesh dim, by the caches' placement: Shard(0)
    batch (q cut to the same rows); Shard(1) a slot shard of the cache (q
    gathered on its heads), merged across the dim; Shard(2) kv heads (q on
    the heads they serve); Replicate, with q replicated or on query heads,
    the cache then sliced to the local heads' kv group.  A pending sum of q
    is reduced first.  Anything else raises, as does a tensor
    ``cache_len``."""
    name = "decode_attention"
    if (not isinstance(k_cache, DTensor) or not isinstance(v_cache, DTensor)
            or k_cache.placements != v_cache.placements):
        raise ValueError(f"{name}: q is a DTensor; the caches must be DTensors of one placement")
    if not isinstance(cache_len, int):
        raise ValueError(f"{name}: the sharded route takes a host-int cache_len")
    q, k_cache, v_cache = (unit_dims_replicated(t) for t in (q, k_cache, v_cache))
    # A pending sum of q is reduced to the cache's counterpart layout.
    h = q.shape[1] // math.prod(q.device_mesh.size(i) for i, p in enumerate(q.placements)
                                if isinstance(p, Shard) and p.dim == 1)
    targets = {}
    for i, c in enumerate(k_cache.placements):
        cd = c.dim if isinstance(c, Shard) else None
        targets[i] = {0: Shard(0), 2: Shard(1)}.get(cd, Replicate())
        n = q.device_mesh.size(i)
        if cd is None and h % n == 0 and q.placements[i].is_partial():
            targets[i] = Shard(1)
            h //= n
    q = resolve_partial(q, targets)
    check_placements(name, "q", q, (0, 1))
    check_placements(name, "k_cache", k_cache, (0, 1, 2))
    # q laid out as the cache's rows: its batch shards, replicated over the
    # slot shards (every slot shard serves every query head), on the kv-head
    # shards' heads; a query head shard over a replicated cache stays.
    want = []
    for i, (a, c) in enumerate(zip(q.placements, k_cache.placements)):
        cd = c.dim if isinstance(c, Shard) else None
        if cd is None and isinstance(a, Shard) and a.dim == 0:
            raise ValueError(f"{name}: q {q.placements} with caches {k_cache.placements} on "
                             f"mesh dim {i}")
        want.append({0: Shard(0), 1: Replicate(), 2: Shard(1)}.get(cd, a))
    if tuple(want) != tuple(q.placements):
        q = q.redistribute(q.device_mesh, want)
    for t in (q, k_cache):
        even_shards(name, t)
    mesh = q.device_mesh
    seq = [i for i, c in enumerate(k_cache.placements) if isinstance(c, Shard) and c.dim == 1]
    heads = [i for i, a in enumerate(q.placements) if isinstance(a, Shard) and a.dim == 1]
    kv_heads = [i for i, c in enumerate(k_cache.placements) if isinstance(c, Shard) and c.dim == 2]
    if kv_heads and kv_heads != heads:
        raise ValueError(f"{name}: kv heads sharded on mesh dims {kv_heads}, query heads on "
                         f"{heads}")
    h, kv = q.shape[1], k_cache.shape[2]
    kv_slice = None
    if heads and not kv_heads:  # replicated K/V: the local heads' groups
        kv_slice = kv_group_slice(h, kv, *shard_index(mesh, heads))
    n_seq, r_seq = shard_index(mesh, seq)
    offset = r_seq * (k_cache.shape[1] // n_seq)
    groups = [mesh.get_group(i).group_name for i in seq]

    def all_reduce(t, op):
        for g in groups:
            t = torch.ops._c10d_functional.wait_tensor(
                torch.ops._c10d_functional.all_reduce(t, op, g))
        return t

    def local(ql, kl, vl):
        if kv_slice is not None:
            kl, vl = kl[:, :, kv_slice[0]:kv_slice[1]], vl[:, :, kv_slice[0]:kv_slice[1]]
        if n_seq == 1:
            return decode_attention(ql, kl, vl, cache_len, window=window, return_lse=return_lse)
        out, lse = decode_attention(ql, kl, vl, cache_len, window=window, slot_offset=offset,
                                    return_lse=True)
        out, lse = ref.merge_decode_shards(out, lse, all_reduce)
        return (out, lse) if return_lse else out

    out_pl = tuple(Replicate() if i in seq else p for i, p in enumerate(q.placements))
    return sharded_call(local, (q, k_cache, v_cache),
                        (q.placements, k_cache.placements, v_cache.placements),
                        [out_pl, out_pl] if return_lse else [out_pl])


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0, slot_offset: int = 0,
                     return_lse: bool = False):
    """q (B,H,D) x caches (B,S_max,KV,D) -> (B,H,D), masked to ``cache_len``
    (int, () or (B,)) valid entries; ``window > 0`` also masks entries
    before ``cache_len - window``.  ``slot_offset`` is the global slot of the
    caches' entry 0 (a slot shard of a sequence-sharded cache): lengths and
    window mask by global slot.  ``return_lse`` also returns each row's
    float32 log-sum-exp, (B, H), for ``ref.merge_decode_shards``.

    The kernel has no backward: on the card a call that autograd would
    record (grad mode on and an operand that requires grad) raises, rather
    than return a tensor cut off from the graph.  DTensor operands take the
    sharded route (``_sharded``)."""
    if isinstance(q, DTensor):
        return _sharded(q, k_cache, v_cache, cache_len, window=window, return_lse=return_lse)
    if q.device.type == "cpu":
        return ref.decode_gqa(q, k_cache, v_cache, cache_len, window=window,
                              slot_offset=slot_offset, return_lse=return_lse)
    if ref.records(q, k_cache, v_cache):
        raise RuntimeError("decode_attention: the kernel has no backward, and an operand "
                           "requires grad; decode under torch.no_grad()")
    meta = q.device.type == "meta"
    check_operands("decode_attention", {"q": q, "k_cache": k_cache, "v_cache": v_cache},
                   "meta" if meta else "cuda")
    b, h, d = q.shape
    s_max, kv = k_cache.shape[1], k_cache.shape[2]
    if (k_cache.shape != v_cache.shape or k_cache.shape[0] != b or k_cache.shape[3] != d
            or h % kv):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)} are not GQA-compatible")
    if h // kv > MAX_GROUP:
        raise ValueError(f"decode_attention: group {h // kv} > {MAX_GROUP}")
    if window < 0 or slot_offset < 0:
        raise ValueError(f"decode_attention: window={window}, slot_offset={slot_offset}")
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h), dtype=torch.float32, device=q.device) if return_lse else None
    result = (out, lse) if return_lse else out
    if meta:
        # Lengths given as a tensor have no values on meta: every entry counts.
        n = cache_len - slot_offset if isinstance(cache_len, int) else s_max
        count_meta_call("decode_attention", cost(b, h, kv, d, s_max, n, window=window,
                                                 dtype=q.dtype, lse=return_lse))
        return result
    if isinstance(cache_len, int):  # a scalar argument: no device tensor, no copy
        lens, scalar_len = None, cache_len
        base, end = valid_range(cache_len - slot_offset, s_max, window)
        if slot_offset and end == base:  # no entry of this slot shard is valid
            out.zero_()
            if return_lse:
                lse.fill_(-torch.inf)
            return result
        with torch.cuda.device(q.device):
            most = max_split(q.dtype, d, h // kv)
        chunk, n_split = split_plan(b, kv, end - base, most)
    else:
        lens = torch.as_tensor(cache_len, device=q.device).to(torch.int32)
        lens = lens.expand(b).contiguous() if lens.ndim == 0 else lens.contiguous()
        if lens.shape != (b,):
            raise ValueError(f"decode_attention: cache_len of shape {tuple(lens.shape)}, "
                             f"want ({b},)")
        scalar_len, base = 0, 0
        with torch.cuda.device(q.device):
            most = max_split(q.dtype, d, h // kv)
        chunk, n_split = split_plan(b, kv, s_max, most)
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            None if lens is None else lens.data_ptr(), scalar_len,
            out.data_ptr(),
            DTYPE_CODES[q.dtype], b, h, kv, d, s_max, base, chunk, n_split, int(window),
            ref.softmax_scale(d), *q.stride()[:2], *k_cache.stride()[:3],
            *v_cache.stride()[:3], *out.stride()[:2], slot_offset,
            None if lse is None else lse.data_ptr(), 0 if lse is None else lse.stride(0),
            stream_handle(q),
        )
    raise_on_error("decode_attention", err)
    global launches
    launches += 1
    return result
