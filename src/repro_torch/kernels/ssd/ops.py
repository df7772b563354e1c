"""Backend dispatch for the Mamba-2 SSD scan (port of ``repro/kernels/ssd/ops.py``).

``impl`` follows the rule of ``kernels/_common.py``: ``None`` on the main
path, ``"cuda"`` to insist on the kernel, ``"ref"`` for the plain version.
The one-token decode update has no kernel in the reference either; it is
the plain ``ref.ssd_decode_step``.
"""
from __future__ import annotations

from repro_torch.kernels._common import use_kernel
from repro_torch.kernels.ssd import ref
from repro_torch.kernels.ssd import ssd_scan as _scan


def ssd(x, dt, A, Bm, Cm, D, h0=None, *, chunk=64, impl=None):
    """Chunked SSD scan; returns (y, final_state)."""
    if use_kernel(x, impl):
        return _scan.ssd(x, dt, A, Bm, Cm, D, h0=h0, chunk=chunk)
    return ref.ssd_chunked(x, dt, A, Bm, Cm, D, h0=h0, chunk=chunk)


ssd_decode_step = ref.ssd_decode_step
