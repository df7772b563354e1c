"""The plain reference of the training cell: Mamba-2's loss, its gradients
by autograd and AdamW, in float32 with TF32 off.

Written from the published description (arXiv:2405.21060) and the
configuration file, with the chunked SSD algorithm of the paper's section 6
(a frozen copy of that algorithm, not the program's): in_proj -> (z | x |
B | C | dt), a causal depthwise conv over (x, B, C), SiLU, softplus(dt +
dt_bias), A = -exp(A_log), the SSD scan with the D skip, a gated RMSNorm
(y * SiLU(z), normalised), out_proj, a residual around each layer; a final
RMSNorm, the output head and the mean next-token cross-entropy.

The parameters are drawn again from the seed (``bench/weights.py``) and
kept as float32 copies of the bfloat16 values; after each AdamW step they
are rounded to bfloat16 once, since the configuration trains bfloat16
parameters.  Each layer is recomputed in the backward and the rows go a
block at a time (``rows``), so that 8 x 4096 tokens fit.  ``fp8=True`` is
the control: every product's operands rounded to float8 e4m3 (per-row
scales for activations, per-column for weights).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench import weights

E4M3_MAX = 448.0


def fake_fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with a scale per slice along ``dim``; the
    gradient passes straight through."""
    amax = x.detach().abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


def matmul(x, w, fp8: bool):
    if fp8:
        return fake_fp8(x, -1) @ fake_fp8(w, -2)
    return x @ w


def rms_norm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _segsum(a):
    t = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=a.device))
    return torch.where(mask, out, -torch.inf)


def ssd(x, dt, A, Bm, Cm, D, chunk: int):
    """The chunked SSD scan (arXiv:2405.21060 section 6) in float32 from a
    zero state: x (b, s, h, p), dt (b, s, h), A and D (h,), B and C (b, s, n)."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    pad = -s % chunk
    if pad:
        x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        Bm, Cm = F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad))
    c = (s + pad) // chunk
    xf = x.reshape(b, c, chunk, h, p)
    dtf = dt.reshape(b, c, chunk, h)
    Bf = Bm.reshape(b, c, chunk, n)
    Cf = Cm.reshape(b, c, chunk, n)
    a_h = (A[None, None, None, :] * dtf).movedim(-1, 2)          # (b, c, h, q)
    a_cum = torch.cumsum(a_h, dim=-1)
    a_tot = a_cum[..., -1]
    L = torch.exp(_segsum(a_h))
    scores = torch.einsum("bcqn,bcsn->bcqs", Cf, Bf)
    y_intra = torch.einsum("bchqs,bcsh,bcshp->bcqhp", scores[:, :, None] * L, dtf, xf)
    decay_tail = torch.exp(a_tot[..., None] - a_cum)
    states = torch.einsum("bchq,bcqh,bcqhp,bcqn->bchpn", decay_tail, dtf, xf, Bf)
    # The state entering each chunk: the chunks' states decayed across the
    # chunk totals between them (the paper's Listing 1), from a zero state.
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    decay_chunk = torch.exp(_segsum(F.pad(a_tot.movedim(1, -1), (1, 0))))   # (b, h, c+1, c+1)
    prevs = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)[:, :-1]
    y_inter = torch.einsum("bcqn,bchpn,bchq->bcqhp", Cf, prevs, torch.exp(a_cum))
    y = (y_intra + y_inter).reshape(b, c * chunk, h, p)[:, :s]
    return y + D[None, None, :, None] * x[:, :s]


def ssm_layer(x, w: dict, m: dict, fp8: bool):
    """One residual Mamba-2 layer; ``w`` maps the layer's leaf names (after
    ``blocks.<i>.``) to float32 tensors."""
    d = m["d_model"]
    di = m["ssm_expand"] * d
    n = m["ssm_state_dim"]
    nh = di // m["ssm_head_dim"]
    eps = m["norm_eps"]
    b, s, _ = x.shape
    h = rms_norm(x, w["ln1.scale"], eps)
    z, xc, Bm, Cm, dt = torch.split(matmul(h, w["ssm.w_in"], fp8), [di, di, n, n, nh], dim=-1)
    conv_in = torch.cat([xc, Bm, Cm], dim=-1)
    width = m["ssm_conv_width"]
    padded = F.pad(conv_in, (0, 0, width - 1, 0))
    conv = sum(padded[:, k:k + s] * w["ssm.conv_w"][k] for k in range(width)) + w["ssm.conv_b"]
    xc, Bm, Cm = torch.split(F.silu(conv), [di, n, n], dim=-1)
    dtp = F.softplus(dt + w["ssm.dt_bias"])
    A = -torch.exp(w["ssm.A_log"])
    y = ssd(xc.reshape(b, s, nh, m["ssm_head_dim"]), dtp, A, Bm, Cm, w["ssm.D"],
            m["ssm_chunk_size"]).reshape(b, s, di)
    y = rms_norm(y * F.silu(z), w["ssm.norm_scale"], eps)
    return x + matmul(y, w["ssm.w_out"], fp8)


def nll_sum(params: dict, m: dict, tokens, labels, fp8: bool):
    """Summed next-token negative log-likelihood of rows ``tokens`` (b, s)."""
    x = params["embed.embedding"][tokens]
    for i in range(m["num_layers"]):
        pre = f"blocks.{i}."
        w = {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}
        x = checkpoint(lambda xx, w=w: ssm_layer(xx, w, m, fp8), x, use_reentrant=False)
    x = rms_norm(x, params["final_norm.scale"], m["norm_eps"])
    logits = matmul(x, params["embed.lm_head"], fp8)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1),
                           ignore_index=-1, reduction="sum")


def parts(m: dict) -> dict[str, list[tuple[str, int]]]:
    """The parts of a layer's leaves that play different roles, along their
    last axis: the in-projection's columns (z, x, B, C, dt) and the
    conv's channels (x, B, C); {leaf name after the layer: [(part, size)]}."""
    di = m["ssm_expand"] * m["d_model"]
    n = m["ssm_state_dim"]
    conv = [("x", di), ("B", n), ("C", n)]
    return {"ssm.w_in": [("z", di), ("x", di), ("B", n), ("C", n),
                         ("dt", di // m["ssm_head_dim"])],
            "ssm.conv_w": conv, "ssm.conv_b": conv}


def split_parts(name: str, t: torch.Tensor, m: dict) -> list[tuple[str, torch.Tensor]]:
    """Leaf ``name``'s parts as (``name[part]``, view), or the leaf whole."""
    ps = parts(m).get(name.split(".", 2)[-1]) if name.startswith("blocks.") else None
    if ps is None:
        return [(name, t)]
    return [(f"{name}[{p}]", c) for (p, _), c in
            zip(ps, torch.split(t, [size for _, size in ps], dim=-1))]


def weights_order(m: dict) -> list[str]:
    """The leaf names in the order ``train`` reports them."""
    return [k for leaves in weights.layout(m).values() for k in leaves]


def initial_params(seed: int, name: str, m: dict, device) -> dict:
    """float32 copies of the bfloat16 parameters the seed draws."""
    out = {}
    for group, leaves in weights.layout(m).items():
        out.update({k: v.float() for k, v in
                    weights.make_group(seed, name, group, leaves, device).items()})
    return {k: out[k] for k in weights_order(m)}


def lr_at(step: int, o: dict) -> float:
    """Linear warm-up, then cosine to ``min_lr_frac`` of the rate."""
    if step < o["warmup_steps"]:
        return o["lr"] * step / max(o["warmup_steps"], 1)
    frac = min(max((step - o["warmup_steps"]) / max(o["total_steps"] - o["warmup_steps"], 1),
                   0.0), 1.0)
    return o["lr"] * (o["min_lr_frac"] + (1 - o["min_lr_frac"]) * 0.5
                      * (1 + math.cos(math.pi * frac)))


def train(seed: int, name: str, m: dict, o: dict, batches, device, fp8: bool = False,
          rows: int = 4, against: dict | None = None, against_change=None,
          keep: bool = False) -> dict:
    """Steps of AdamW from the seed's parameters over ``batches`` (a list of
    (tokens, labels), one a step).  Returns, per step, the loss; per leaf
    (in ``weights.layout`` order) the first step's gradient norm after
    clipping, the norm of each parameter's change after the last step, and
    the first gradient's norm before clipping.  With ``against`` (leaf name
    -> a first clipped gradient to judge) also each leaf's norm of the
    difference from this one's (``first_diff``), and per part (``parts``:
    ``part_names``, this one's norm ``part_grad``, the difference's
    ``part_diff``); with ``against_change``
    (leaf name -> a function giving the change to judge, in float32) each
    leaf's norm of the difference between the two changes
    (``change_diff``); with ``keep`` this one's first clipped gradient and
    change themselves (``first``, ``changes``)."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        params = initial_params(seed, name, m, device)
        names = list(params)
        p0 = {k: v.clone() for k, v in params.items()}
        mo = {k: torch.zeros_like(v) for k, v in params.items()}
        vo = {k: torch.zeros_like(v) for k, v in params.items()}
        losses, first_grad, raw_grad, diff, first = [], None, None, None, None
        part = {"part_names": [], "part_grad": [], "part_diff": []}
        for step, (tokens, labels) in enumerate(batches, start=1):
            leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
            count = int((labels >= 0).sum())
            total = 0.0
            grads = {k: torch.zeros_like(v) for k, v in params.items()}
            for r in range(0, tokens.shape[0], rows):
                nll = nll_sum(leaves, m, tokens[r:r + rows], labels[r:r + rows], fp8) / count
                gs = torch.autograd.grad(nll, [leaves[k] for k in names], allow_unused=True)
                for k, g in zip(names, gs):
                    if g is not None:
                        grads[k] += g
                total += float(nll.detach())
            losses.append(total)
            gnorm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads.values()))
            scale = min(o["grad_clip"] / max(gnorm, 1e-9), 1.0)
            if first_grad is None:
                raw_grad = [float(grads[k].double().norm()) for k in names]
                first_grad = [x * scale for x in raw_grad]
                if against is not None:
                    diff = []
                    for k in names:
                        want = grads[k].double() * scale
                        diff.append(float((against[k].double() - want).norm()))
                        for (label, w), (_, a) in zip(split_parts(k, want, m),
                                                      split_parts(k, against[k].double(), m)):
                            part["part_names"].append(label)
                            part["part_grad"].append(float(w.norm()))
                            part["part_diff"].append(float((a - w).norm()))
                if keep:
                    first = {k: grads[k] * scale for k in names}
            lr = lr_at(step, o)
            b1c, b2c = 1.0 - o["b1"] ** step, 1.0 - o["b2"] ** step
            with torch.no_grad():
                for k in names:
                    g = grads[k] * scale
                    mo[k].mul_(o["b1"]).add_((1 - o["b1"]) * g)
                    vo[k].mul_(o["b2"]).add_((1 - o["b2"]) * g * g)
                    delta = (mo[k] / b1c) / (torch.sqrt(vo[k] / b2c) + o["eps"]) \
                        + o["weight_decay"] * params[k]
                    params[k] = (params[k] - lr * delta).to(torch.bfloat16).float()
        del mo, vo, grads
        change, change_diff, changes = [], None, {} if keep else None
        if against_change is not None:
            change_diff = []
        for k in names:
            c = params.pop(k) - p0.pop(k)
            change.append(float(c.double().norm()))
            if against_change is not None:
                change_diff.append(float((against_change(k) - c).double().norm()))
            if keep:
                changes[k] = c
        return {"names": names, "loss": losses, "first_grad": first_grad,
                "raw_grad": raw_grad, "change": change, "first_diff": diff,
                "change_diff": change_diff, "first": first, "changes": changes, **part}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
