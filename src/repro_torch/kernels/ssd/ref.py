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


def ssd_bwd_plain(x, dt, A, Bm, Cm, D, h0, dy, dh_final, chunk: int = 64,
                  work: torch.dtype = torch.float32):
    """The vector-Jacobian product of ``ssd_chunked`` written out in float32
    (or ``work``):
    (dx, ddt, dA, dBm, dCm, dD, dh0), each in its input's dtype (dh0 None
    without h0).  ``dy`` (the cotangent of y) and ``dh_final`` (of the final
    state) may each be None (zero).  ``work`` is the dtype it computes in
    (float64 gives a yardstick for the float32 kernel).

    The chunked backward the kernel (``csrc/ssd_scan_bwd.cu``) computes, pass
    for pass.  With a = A·dt, cum the within-chunk cumsum of a, tot its last
    value, L[t, s] = exp(cum_t − cum_s) for s <= t:
      1. the state entering each chunk, H[c], as the forward computes it;
      2. the state's cotangent leaving each chunk, G[c] (G[last] = dh_final),
         walking the chunks backwards: G[c−1] = exp(tot_c)·G[c] + Σ_t
         exp(cum_t)·dy_t C_tᵀ; dh0 = G[−1];
      3. per chunk, with K = L ∘ dt_s ∘ (dy_t·x_s) and U_s = Σ_t (C_t·B_s)
         L[t, s] dy_t + exp(tot − cum_s) G B_s (= the state cotangent at s
         times B_s): dx = dt·U + D·dy, dB = Kᵀ C + dt·exp(tot − cum)·x G
         and dC = K B + exp(cum)·dy H (summed over heads), and the gradient
         of cum, dcum_t = Σ_s (C_t·B_s) K[t, s] + exp(cum_t) dy_t·(H C_t)
         − dt_t x_t·U_t (+ ⟨G, state leaving the chunk⟩ at the chunk's
         end), reverse-summed within the chunk into da; ddt = x·U + A·da,
         dA = Σ dt·da, dD = Σ dy·x.
    """
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    f32 = work
    dyf = torch.zeros((b, s, h, p), dtype=f32, device=x.device) if dy is None else dy.to(f32)
    if s % chunk:
        pad = chunk - s % chunk
        pad_s = lambda t, dims: F.pad(t, (0, 0) * dims + (0, pad))  # noqa: E731
        grads = ssd_bwd_plain(pad_s(x, 2), pad_s(dt, 1), A, pad_s(Bm, 1), pad_s(Cm, 1), D, h0,
                              pad_s(dyf, 2), dh_final, chunk=chunk, work=work)
        dx, ddt, dA, dB, dC, dD, dh0 = grads
        return dx[:, :s], ddt[:, :s], dA, dB[:, :s], dC[:, :s], dD, dh0
    c = s // chunk
    xf = x.to(f32).reshape(b, c, chunk, h, p)
    dtf = dt.to(f32).reshape(b, c, chunk, h)
    Bf = Bm.to(f32).reshape(b, c, chunk, n)
    Cf = Cm.to(f32).reshape(b, c, chunk, n)
    dyf = dyf.reshape(b, c, chunk, h, p)
    Af = A.to(f32)

    a_cum = torch.cumsum((Af * dtf).movedim(-1, 2), dim=-1)          # (B,C,H,Q)
    a_tot = a_cum[..., -1]                                            # (B,C,H)
    L = torch.exp(_segsum((Af * dtf).movedim(-1, 2)))                 # (B,C,H,Q,Q) [t, s]
    decay_in = torch.exp(a_cum).movedim(2, -1)                        # (B,C,Q,H)
    decay_tail = torch.exp(a_tot[..., None] - a_cum).movedim(2, -1)   # (B,C,Q,H)

    # Pass 1: the state entering each chunk.
    states = torch.einsum("bcqh,bcqh,bcqhp,bcqn->bchpn", decay_tail, dtf, xf, Bf)
    hstate = torch.zeros((b, h, p, n), dtype=f32, device=x.device) if h0 is None else h0.to(f32)
    h_prevs = []
    for ci in range(c):
        h_prevs.append(hstate)
        hstate = torch.exp(a_tot[:, ci])[..., None, None] * hstate + states[:, ci]
    H = torch.stack(h_prevs, dim=1)                                   # (B,C,H,P,N)

    # Pass 2: the state's cotangent leaving each chunk, backwards.
    local = torch.einsum("bcqh,bcqhp,bcqn->bchpn", decay_in, dyf, Cf)
    g = (torch.zeros((b, h, p, n), dtype=f32, device=x.device) if dh_final is None
         else dh_final.to(f32))
    g_next = [None] * c
    for ci in reversed(range(c)):
        g_next[ci] = g
        g = torch.exp(a_tot[:, ci])[..., None, None] * g + local[:, ci]
    G = torch.stack(g_next, dim=1)                                    # (B,C,H,P,N)
    dh0 = None if h0 is None else g.to(h0.dtype)

    # Pass 3: each chunk's gradients.
    CB = torch.einsum("bctn,bcsn->bcts", Cf, Bf)                      # (B,C,Q,Q)
    M = torch.einsum("bcthp,bcshp->bchts", dyf, xf)                   # dy_t · x_s
    K = L * dtf.movedim(-1, 2)[..., None, :] * M                      # (B,C,H,Q,Q)
    T = CB[:, :, None] * K
    U = (torch.einsum("bchts,bcthp->bcshp", CB[:, :, None] * L, dyf)
         + decay_tail[..., None] * torch.einsum("bcsn,bchpn->bcshp", Bf, G))
    dx = dtf[..., None] * U + D.to(f32)[:, None] * dyf
    xU = (xf * U).sum(-1)                                             # (B,C,Q,H)
    dB = (torch.einsum("bchts,bctn->bcsn", K, Cf)
          + torch.einsum("bcsh,bcshp,bchpn->bcsn", dtf * decay_tail, xf, G))
    dC = (torch.einsum("bchts,bcsn->bctn", K, Bf)
          + torch.einsum("bcth,bcthp,bchpn->bctn", decay_in, dyf, H))
    inter = decay_in * (dyf * torch.einsum("bctn,bchpn->bcthp", Cf, H)).sum(-1)
    row_t, col_t = T.sum(-1).movedim(2, -1), T.sum(-2).movedim(2, -1)   # (B,C,Q,H)
    d_tot = (torch.exp(a_tot) * (G * H).sum((-2, -1))
             + (dtf * xU - col_t).sum(2))                             # (B,C,H)
    dcum = row_t + inter - dtf * xU
    dcum[:, :, -1] += d_tot
    da = torch.flip(torch.cumsum(torch.flip(dcum, (2,)), dim=2), (2,))
    ddt = xU + Af * da
    dA = (dtf * da).sum((0, 1, 2))
    dD = (dyf * xf).sum((0, 1, 2, 4))
    return (dx.reshape(b, s, h, p).to(x.dtype), ddt.reshape(b, s, h).to(dt.dtype),
            dA.to(A.dtype), dB.reshape(b, s, n).to(Bm.dtype), dC.reshape(b, s, n).to(Cm.dtype),
            dD.to(D.dtype), dh0)


def ssd_decode_step(x, dt, A, Bm, Cm, D, h):
    """One-token update: x (B,H,P), dt (B,H), Bm/Cm (B,N), h (B,H,P,N)."""
    xf, dtf = x.float(), dt.float()
    decay = torch.exp(A[None].float() * dtf)
    upd = dtf[..., None, None] * xf[..., None] * Bm[:, None, None, :].float()
    hnew = decay[..., None, None] * h + upd
    y = torch.einsum("bhpn,bn->bhp", hnew, Cm.float())
    y = y + D[None, :, None].float() * xf
    return y.to(x.dtype), hnew
