"""Weights made on the device from the seed, one group at a time.

A model's parameters fall into groups: ``embed`` (the embedding, the output
head and the final norm) and ``layer.<i>`` for each layer.  Each group's
random leaves are drawn from a generator on the device seeded by (seed,
model, group), in bfloat16, by one ``torch.rand`` call (and one
``torch.randn`` for the normal leaves), and then shaped view by view; norms
and the other constant leaves are filled.  So the program gets its whole
tree in a few large calls, and the reference can draw any one group again,
bit for bit, without holding the rest.

The layout (names, shapes, init rules) is written here from the
configuration file, not read from the program: the harness checks that it
matches the program's own declarations before a run.  The rules are
Mamba-2's published initialisation (``mamba_ssm``'s ``Mamba2`` and
``_init_weights``): projections uniform in +-1/sqrt(fan_in) (PyTorch's
``nn.Linear``), ``out_proj`` further over sqrt(num_layers) (one residual a
layer), the depthwise conv and its bias uniform in +-1/sqrt(conv width),
dt drawn log-uniform in [1e-3, 0.1] and stored as softplus's inverse in
``dt_bias``, A uniform in [1, 16] stored as ``A_log``, D and the norms at
one, the embedding normal with std 0.02 and the output head (the
embedding's tied copy in the published model, a leaf of its own here)
drawn alike.
"""
from __future__ import annotations

import hashlib
import math

import torch

DT_MIN, DT_MAX, DT_FLOOR = 1e-3, 0.1, 1e-4
A_MIN, A_MAX = 1.0, 16.0
EMBED_STD = 0.02


def _leaf(shape, init, scale=None):
    return {"shape": tuple(shape), "init": init, "scale": scale}


def _uniform(shape, fan_in, over=1.0):
    return _leaf(shape, "uniform", 1.0 / math.sqrt(fan_in) / over)


def _layer_leaves(m: dict) -> dict:
    if m["family"] != "ssm":
        raise ValueError(f"no layout for family {m['family']!r}")
    d = m["d_model"]
    di = m["ssm_expand"] * d
    n = m["ssm_state_dim"]
    nh = di // m["ssm_head_dim"]
    conv_ch = di + 2 * n
    width = m["ssm_conv_width"]
    return {
        "ln1.scale": _leaf((d,), "ones"),
        "ssm.w_in": _uniform((d, 2 * di + 2 * n + nh), d),
        "ssm.conv_w": _uniform((width, conv_ch), width),
        "ssm.conv_b": _uniform((conv_ch,), width),
        "ssm.A_log": _leaf((nh,), "A_log"),
        "ssm.dt_bias": _leaf((nh,), "dt_bias"),
        "ssm.D": _leaf((nh,), "ones"),
        "ssm.norm_scale": _leaf((di,), "ones"),
        "ssm.w_out": _uniform((di, d), di, math.sqrt(m["num_layers"])),
    }


def layout(m: dict) -> dict[str, dict]:
    """{group: {leaf path inside the group: leaf}} for model config ``m``."""
    d, vp = m["d_model"], m["padded_vocab"]
    groups = {"embed": {"embed.embedding": _leaf((vp, d), "normal", EMBED_STD),
                        "embed.lm_head": _leaf((d, vp), "normal", EMBED_STD),
                        "final_norm.scale": _leaf((d,), "ones")}}
    for i in range(m["num_layers"]):
        groups[f"layer.{i}"] = {f"blocks.{i}.{k}": v for k, v in _layer_leaves(m).items()}
    return groups


def group_seed(seed: int, model: str, group: str) -> int:
    """A 63-bit generator seed for one group, from the run's seed."""
    digest = hashlib.sha256(f"{int(seed)}/{model}/{group}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def _from_uniform(u: torch.Tensor, leaf: dict) -> torch.Tensor:
    """A leaf from its view ``u`` of the group's uniform draw in [0, 1)."""
    if leaf["init"] == "uniform":
        return u.mul_(2 * leaf["scale"]).sub_(leaf["scale"])
    x = u.float()
    if leaf["init"] == "A_log":
        x = torch.log(A_MIN + (A_MAX - A_MIN) * x)
    else:   # dt_bias = softplus⁻¹(dt), dt log-uniform in [DT_MIN, DT_MAX]
        dt = torch.exp(x * (math.log(DT_MAX) - math.log(DT_MIN)) + math.log(DT_MIN))
        dt = dt.clamp_min(DT_FLOOR)
        x = dt + torch.log(-torch.expm1(-dt))
    return x.to(u.dtype)


def make_group(seed: int, model: str, group: str, leaves: dict, device,
               dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
    """One group's leaves as views of one uniform and one normal buffer."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(group_seed(seed, model, group))
    out = {}
    for draw, kinds in ((torch.rand, ("uniform", "A_log", "dt_bias")), (torch.randn, ("normal",))):
        rand = [(k, v) for k, v in leaves.items() if v["init"] in kinds]
        if not rand:
            continue
        buf = draw(sum(math.prod(v["shape"]) for _, v in rand), generator=gen, device=device,
                   dtype=dtype)
        at = 0
        for k, v in rand:
            n = math.prod(v["shape"])
            view = buf[at:at + n].view(v["shape"])
            out[k] = view.mul_(v["scale"]) if draw is torch.randn else _from_uniform(view, v)
            at += n
    for k, v in leaves.items():
        if v["init"] == "ones":
            out[k] = torch.ones(v["shape"], device=device, dtype=dtype)
    return {k: out[k] for k in leaves}


def nest(flat: dict[str, torch.Tensor]) -> dict:
    """{"blocks.3.ssm.w_in": t} -> {"blocks": [..., {"ssm": {"w_in": t}}]}."""
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        parts = path.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t
    if "blocks" in tree:
        blocks = tree["blocks"]
        tree["blocks"] = [blocks[str(i)] for i in range(len(blocks))]
    return tree


def make_model(seed: int, model: str, m: dict, device) -> dict:
    """The whole parameter tree of one model, group by group."""
    flat = {}
    for group, leaves in layout(m).items():
        flat.update(make_group(seed, model, group, leaves, device))
    return nest(flat)


def param_count(m: dict) -> int:
    return sum(math.prod(v["shape"]) for g in layout(m).values() for v in g.values())
