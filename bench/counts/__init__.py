"""The benchmark's frozen yardstick: the card's peaks and the least work of
each kernel and of a whole step, worked out from shapes.

These are copies made for the benchmark, so that a change to the program's
own counts (``kernels/*::cost``, ``launch/roofline.py``) cannot move a
roofline share.  A kernel's least work counts each input byte read once and
each output byte written once, and the products that the algorithm needs:
whatever a kernel reads again or computes twice is its own cost.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The least time of a call: the larger of its compute and memory terms."""
    return max(flops / peak_flops, nbytes / PEAK_HBM_BYTES)


def causal_pairs(s: int, window: int = 0) -> int:
    """(query, key) pairs of a causal prompt of ``s`` tokens, in the window's
    band where ``window`` > 0."""
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


# -- the SSD scan ------------------------------------------------------------

def ssd_fwd(b: int, s: int, h: int, p: int, n: int, *, chunk: int, h0: bool = False,
            itemsize: int = 2) -> tuple[float, float]:
    """(flops, bytes) of one forward call at ``chunk``: C·Bᵀ once per (row,
    chunk), shared by the heads; the gated products and the state per head.
    x read and y written in the input type, dt in float32, B and C read, h0
    read and the final state written in float32."""
    chunks = -(-s // chunk)
    flops = (2 * chunk * chunk * n * b * chunks
             + 2 * chunk * (chunk * p + 2 * n * p) * b * h * chunks)
    state = b * h * p * n * 4
    nbytes = (2 * b * s * h * p * itemsize + b * s * h * 4 + 2 * b * s * n * itemsize
              + (state if h0 else 0) + state)
    return float(flops), float(nbytes)


def ssd_bwd(b: int, s: int, h: int, p: int, n: int, *, chunk: int, h0: bool = False,
            dh_final: bool = False, itemsize: int = 2) -> tuple[float, float]:
    """(flops, bytes) of one backward call: twice the forward's products,
    x, dt, B, C and dy read, dx, ddt, dB and dC written once (h0 read and
    dh0 written where h0 is given, dh_final read where it is)."""
    flops, _ = ssd_fwd(b, s, h, p, n, chunk=chunk, h0=h0, itemsize=itemsize)
    state = b * h * p * n * 4
    nbytes = (3 * b * s * h * p * itemsize + 2 * b * s * h * 4 + 4 * b * s * n * itemsize
              + (2 * state if h0 else 0) + (state if dh_final else 0))
    return 2 * flops, float(nbytes)


# -- whole steps ---------------------------------------------------------------

def train_flops(m: dict, n_params: int, batch: int, seq: int) -> float:
    """Model FLOPs of one training step as the port's records define ``mfu``:
    6·N·tokens with N every parameter (forward and backward, no recompute
    counted), plus 12·L·B·H·D·S(S+1)/2 for attention layers."""
    flops = 6.0 * n_params * batch * seq
    if m["family"] in ("dense", "moe"):
        flops += (12.0 * m["num_layers"] * batch * m["num_heads"] * m["head_dim"]
                  * causal_pairs(seq, m.get("sliding_window", 0)))
    return flops
