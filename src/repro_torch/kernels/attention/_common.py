"""Argument checks shared by the attention kernel wrappers."""
from __future__ import annotations

import torch

from repro_torch.kernels._common import DTYPE_CODES

HEAD_DIMS = (32, 64, 128, 256)


def check_operands(name: str, tensors: dict[str, torch.Tensor], device_type: str = "cuda") -> None:
    """Raise unless every tensor is a ``device_type`` tensor (CUDA for a
    launch, ``meta`` for the meta route) of one supported dtype on one
    device, with a contiguous last dimension and 16-byte aligned rows (the
    kernels read rows with 16-byte vector loads)."""
    first = next(iter(tensors.values()))
    for arg, t in tensors.items():
        if t.device.type != device_type:
            raise ValueError(f"{name}: {arg} is on {t.device}, the kernel needs a CUDA tensor")
        if t.device != first.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, not {first.device}")
        if t.dtype != first.dtype or t.dtype not in DTYPE_CODES:
            raise ValueError(
                f"{name}: dtypes {[x.dtype for x in tensors.values()]}; the kernel "
                f"takes one dtype of {list(DTYPE_CODES)} for all operands"
            )
        if t.shape[-1] not in HEAD_DIMS:
            raise ValueError(f"{name}: head dim {t.shape[-1]} not in {HEAD_DIMS}")
        vec = 16 // t.element_size()
        if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:-1]) or t.data_ptr() % 16:
            raise ValueError(
                f"{name}: {arg} with strides {t.stride()} is not row-contiguous "
                "with 16-byte aligned rows"
            )



def kv_group_slice(h: int, kv: int, n: int, r: int) -> tuple[int, int]:
    """[begin, end) of the kv heads that shard ``r`` of ``n`` equal shards
    of ``h`` query heads reads under GQA (query head i reads kv head
    i // (h / kv)): whole groups, or the one group a shard of fewer heads
    lies in.  Raises where a shard's heads straddle two groups."""
    local, group = h // n, h // kv
    if h % n or h % kv:
        raise ValueError(f"{h} heads over {n} shards and {kv} kv heads")
    if local % group == 0:
        return r * local // group, (r + 1) * local // group
    if group % local == 0:
        return r * local // group, r * local // group + 1
    raise ValueError(f"{local} local query heads of {h} straddle kv groups of {group}")
