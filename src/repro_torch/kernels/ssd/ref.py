"""Plain PyTorch versions of the Mamba-2 SSD (state-space duality) scan
(port of ``repro/kernels/ssd/ref.py``).

Per head h with state size N and head dim P, the recurrence over time is

    h_t = exp(A * dt_t) * h_{t-1} + dt_t * (B_t outer x_t)      (P, N)
    y_t = h_t @ C_t + D * x_t

Shapes (single B/C group, as in Mamba-2 defaults):
    x:  (B, S, H, P)    dt: (B, S, H)    A, D: (H,)
    Bm, Cm: (B, S, N)

``ssd_naive`` is the sequential recurrence; ``ssd_chunked`` is the
quadratic-within-chunk / linear-across-chunks SSD algorithm (arXiv:2405.21060
§6), the decomposition the CUDA kernel also follows.  Every operand is
upcast to float32 and ``y`` is cast back to x's dtype at the end, as in the
reference; states are float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ssd_naive(x, dt, A, Bm, Cm, D, h0=None):
    """Sequential recurrence; returns (y, h_final)."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    xf, dtf = x.float(), dt.float()
    Bf, Cf = Bm.float(), Cm.float()
    Af = A.float()
    hstate = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
              if h0 is None else h0.float())
    ys = []
    for t in range(s):
        decay = torch.exp(Af[None] * dtf[:, t])                               # (B,H)
        upd = dtf[:, t, :, None, None] * xf[:, t, ..., None] * Bf[:, t, None, None, :]
        hstate = decay[..., None, None] * hstate + upd
        ys.append(torch.einsum("bhpn,bn->bhp", hstate, Cf[:, t]))
    y = torch.stack(ys, dim=1) + D[None, None, :, None].float() * xf
    return y.to(x.dtype), hstate


def _segsum(a):
    """Stable segment-sum: out[..., t, s] = sum_{r=s+1..t} a[..., r] (t >= s)."""
    t = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=a.device))
    return torch.where(mask, out, -torch.inf)


def ssd_chunked(x, dt, A, Bm, Cm, D, h0=None, chunk: int = 64):
    """Chunked SSD; exact (up to fp assoc.) match of ``ssd_naive``."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    if s % chunk:
        # Pad with dt=0 steps: decay exp(A*0)=1 and zero input contribution,
        # so the final state is unchanged; padded outputs are sliced off.
        pad = chunk - s % chunk
        y, hf = ssd_chunked(
            F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)), A,
            F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad)), D, h0=h0, chunk=chunk,
        )
        return y[:, :s], hf
    c = s // chunk
    xf = x.float().reshape(b, c, chunk, h, p)
    dtf = dt.float().reshape(b, c, chunk, h)
    Bf = Bm.float().reshape(b, c, chunk, n)
    Cf = Cm.float().reshape(b, c, chunk, n)
    Af = A.float()

    a = Af[None, None, None, :] * dtf                     # (B,C,Q,H)
    a_h = a.movedim(-1, 2)                                # (B,C,H,Q)
    a_cum = torch.cumsum(a_h, dim=-1)                     # within-chunk cumsum
    a_tot = a_cum[..., -1]                                # (B,C,H)

    # Intra-chunk (quadratic within the chunk):
    L = torch.exp(_segsum(a_h))                           # (B,C,H,Q,Q)
    scores = torch.einsum("bcqn,bcsn->bcqs", Cf, Bf)      # (B,C,Q,Q)
    gated = scores[:, :, None] * L                        # (B,C,H,Q,Q)
    y_intra = torch.einsum("bchqs,bcsh,bcshp->bcqhp", gated, dtf, xf)

    # Chunk states: contribution of each chunk to the running state.
    decay_tail = torch.exp(a_tot[..., None] - a_cum)      # (B,C,H,Q)
    states = torch.einsum("bchq,bcqh,bcqhp,bcqn->bchpn", decay_tail, dtf, xf, Bf)

    # Inter-chunk recurrence over c (linear):
    hstate = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
              if h0 is None else h0.float())
    h_prevs = []                                          # state entering each chunk
    for ci in range(c):
        h_prevs.append(hstate)
        hstate = torch.exp(a_tot[:, ci])[..., None, None] * hstate + states[:, ci]
    h_prevs = torch.stack(h_prevs, dim=1)                 # (B,C,H,P,N)

    # Inter-chunk output: decayed previous state read out by C.
    decay_in = torch.exp(a_cum)                           # (B,C,H,Q)
    y_inter = torch.einsum("bcqn,bchpn,bchq->bcqhp", Cf, h_prevs, decay_in)

    y = (y_intra + y_inter).reshape(b, s, h, p)
    y = y + D[None, None, :, None].float() * x.float()
    return y.to(x.dtype), hstate


def ssd_decode_step(x, dt, A, Bm, Cm, D, h):
    """One-token update: x (B,H,P), dt (B,H), Bm/Cm (B,N), h (B,H,P,N)."""
    xf, dtf = x.float(), dt.float()
    decay = torch.exp(A[None].float() * dtf)
    upd = dtf[..., None, None] * xf[..., None] * Bm[:, None, None, :].float()
    hnew = decay[..., None, None] * h + upd
    y = torch.einsum("bhpn,bn->bhp", hnew, Cm.float())
    y = y + D[None, :, None].float() * xf
    return y.to(x.dtype), hnew
