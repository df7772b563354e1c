"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing CUDA when there is no CUDA device.

    Entry points default to ``"cuda"``; they never fall back to the CPU on
    their own.  Callers that want the host pass ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(dev)!r} needs a CUDA device and none is available; "
            "pass device='cpu' to run on the host"
        )
    return dev
