"""What every kernel wrapper and dispatch shares: the dtype codes of the C
entries, the stream handle, the launch-error check and the ``impl`` rule.

``impl=None`` (the main path) hands a call to the kernel wrapper: on a CUDA
tensor it launches the Hopper kernel or raises, on a CPU tensor it computes
the plain version.  ``impl="cuda"`` insists on the kernel and raises for a
CPU tensor instead of returning the plain result.  ``impl="ref"`` runs the
plain version wherever the tensors are; only comparisons (``chip_smoke.py``,
the tests) pass it.
"""
from __future__ import annotations

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
IMPLS = (None, "cuda", "ref")


def use_kernel(x: torch.Tensor, impl) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r}; expected one of {IMPLS}")
    if impl == "cuda" and x.device.type != "cuda":
        raise ValueError(
            f"impl='cuda' asks for the CUDA kernel, but the tensors are on {x.device}"
        )
    return impl != "ref"


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# Codes the C entries return besides CUDA's own errors.
OWN_ERRORS = {
    -1: "the driver's cuTensorMapEncodeTiled is not available",
    -2: "the driver refused a TMA tensor map for these operands",
}


def raise_on_error(name: str, err: int) -> None:
    if err < 0:
        raise RuntimeError(f"{name}: {OWN_ERRORS.get(err, f'error {err}')}")
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
