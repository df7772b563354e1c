"""Argument checks shared by the attention kernel wrappers."""
from __future__ import annotations

import torch

from repro_torch.kernels._common import DTYPE_CODES

HEAD_DIMS = (32, 64, 128)


def check_operands(name: str, tensors: dict[str, torch.Tensor]) -> None:
    """Raise unless every tensor is a CUDA tensor of one supported dtype on
    one device, with a contiguous last dimension and 16-byte aligned rows
    (the kernels read rows with 16-byte vector loads)."""
    first = next(iter(tensors.values()))
    for arg, t in tensors.items():
        if t.device.type != "cuda":
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

