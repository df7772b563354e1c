"""The card the roofline is drawn for (port of ``repro/launch/mesh.py``).

The reference's ``HW`` describes one TPU v5e chip of a 256- or 512-chip
mesh.  The port runs on one GPU, so ``hw()`` describes that card: its name,
SM count and memory read from the device when one is present, its memory
rate and peak product rates taken from NVIDIA's data sheet for the SKU its
name matches (dense rates, no sparsity).  Float32 products run at the FMA
pipes' rate, not TF32's: the port keeps TF32 off (``chip_smoke.py``).
Without a card, ``hw()`` is the data sheet of the SXM H100 (or of ``sku``).

One card has no collective term: the roofline reports it as 0.  The
reference's ``make_production_mesh`` and ``make_host_mesh`` have no
counterpart here; the multi-device modules are a later slice.
"""
from __future__ import annotations

import torch

# (key in the device name, SMs, HBM bytes, HBM bytes/s, {dtype: product flop/s}),
# from NVIDIA's data sheets; the first entry whose key is in the name applies.
SKUS = (
    ("H200", 132, 141e9, 4.8e12, {torch.bfloat16: 989e12, torch.float32: 67e12}),
    ("H100 PCIe", 114, 80e9, 2.0e12, {torch.bfloat16: 756e12, torch.float32: 51e12}),
    ("H100 NVL", 132, 94e9, 3.9e12, {torch.bfloat16: 835e12, torch.float32: 60e12}),
    ("H100", 132, 80e9, 3.35e12, {torch.bfloat16: 989e12, torch.float32: 67e12}),  # SXM
)
DEFAULT_SKU = "NVIDIA H100 80GB HBM3"
# The artifacts' file tag: experiments/*_torch/<arch>_<shape>_h100.json.
TAG = "h100"


def sku(name: str) -> tuple:
    """The data-sheet row whose key is in ``name``."""
    for row in SKUS:
        if row[0] in name:
            return row
    raise ValueError(f"no data-sheet row for {name!r}")


def hw(name: str | None = None) -> dict:
    """The card's roofline parameters.

    ``name=None`` reads CUDA device 0 where there is one (its name, SM
    count and ``total_memory``); otherwise, or for a given ``name``, the
    data sheet's row for that name."""
    on_card = name is None and torch.cuda.is_available()
    if on_card:
        props = torch.cuda.get_device_properties(0)
        name, sms, hbm = props.name, props.multi_processor_count, props.total_memory
    name = name or DEFAULT_SKU
    key, sheet_sms, sheet_hbm, bw, peaks = sku(name)
    return {
        "name": name, "sku": key, "from_device": on_card,
        "sms": sms if on_card else sheet_sms,
        "hbm_bytes": int(hbm if on_card else sheet_hbm),
        "hbm_bw": bw,
        "peak_flops": dict(peaks),
        "peak_flops_bf16": peaks[torch.bfloat16],   # the reference's key
    }


def roofline_terms(flops: dict, bytes_moved: float, card: dict) -> dict:
    """Seconds: compute Σ flops of each dtype over its peak, memory bytes
    over the memory rate, collective 0 (one card)."""
    return {
        "compute": sum(f / card["peak_flops"][dt] for dt, f in flops.items()),
        "memory": bytes_moved / card["hbm_bw"],
        "collective": 0.0,
    }


def bound_ms(cost, card: dict) -> tuple[float, str]:
    """A kernel call's least time in ms and what bounds it: the larger of
    its bytes over the memory rate and its operations over the peak rate of
    their dtype (``kernels._common.Cost``)."""
    terms = roofline_terms(cost.flops, cost.bytes, card)
    t_bytes, t_ops = terms["memory"] * 1e3, terms["compute"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
