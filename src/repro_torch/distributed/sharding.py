"""Logical-axis -> mesh-axis sharding rules (port of
``repro/distributed/sharding.py``), as DTensor placements.

Model code declares *logical* axes on every parameter and cache dimension
(``models/params.py::ParamDecl.axes``).  The rule sets below map them onto
the production mesh's axes, the reference's tuples name for name:

Training rules (2D: FSDP over "data", tensor over "model"; "pod" is pure
data parallelism):
    batch    -> (pod, data)      activations
    embed    -> data             d_model rows of weights   (FSDP / ZeRO-3)
    ffn/heads/kv/vocab -> model  weight output dims        (tensor parallel)
    experts  -> None             (per-expert dims already sharded)
    layers   -> None             (scan axis; the port keeps one dict per layer)

Serving rules differ on the caches: the KV-cache sequence dim shards over
"model" (sequence-sharded decode attention: each shard's partial softmax is
merged by ``kernels/attention/decode_attention.py``'s log-sum-exp merge).

``spec_for_axes`` gives a partition spec as the reference's ``P(*entries)``
does: a tuple with one entry per tensor dim (None, an axis name, or a tuple
of names), trailing Nones dropped.  Any dimension not divisible by its
mapped axis size is replicated instead (``explain_specs`` lists each
fallback).  ``placements`` turns a spec into DTensor placements, one per
mesh dim.  A mesh is anything whose ``.shape`` maps axis names to sizes
(``launch/mesh.py::MeshDesc``, a stub) or a ``DeviceMesh`` with dim names.
"""
from __future__ import annotations

import contextlib
import math
from collections.abc import Mapping
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.placement_types import Partial

from repro_torch.models.params import ParamDecl, tree_map, tree_map_decls

TRAIN_RULES: dict[str, tuple[str, ...] | None] = {
    "batch": ("pod", "data"),
    "cache_batch": ("pod", "data"),
    "embed": ("data",),
    "ffn": ("model",),
    "heads": ("model",),
    "kv": ("model",),
    "kv_heads": ("model",),
    "vocab": ("model",),
    "experts": None,
    "layers": None,
    "kv_seq": None,
}

SERVE_RULES: dict[str, tuple[str, ...] | None] = {
    **TRAIN_RULES,
    "kv_seq": ("model",),   # sequence-sharded KV cache
    "kv_heads": None,       # kv heads (1-16) rarely divide the model axis
}

# Decode activations replicated over "data" instead of batch-sharded.
SERVE_V2_RULES: dict[str, tuple[str, ...] | None] = {
    **SERVE_RULES,
    "batch": None,
}

# Expert-parallel variants: the expert dim shards over "model".
SERVE_EP_RULES = {**SERVE_RULES, "experts": ("model",)}
SERVE_V2_EP_RULES = {**SERVE_V2_RULES, "experts": ("model",)}
TRAIN_EP_RULES = {**TRAIN_RULES, "experts": ("model",)}

# Window-sized caches skip sequence sharding.
SERVE_V2_NOSEQ_RULES = {**SERVE_V2_RULES, "kv_seq": None}

# The kv projection's output dim replicated (no w_k/w_v gather per token).
SERVE_V3_RULES = {**SERVE_V2_RULES, "kv": None}

# Sequence-parallel activations: dim 1 of the model inputs over "model".
SERVE_SP_RULES = {**SERVE_RULES, "seq": ("model",)}
TRAIN_SP_RULES = {**TRAIN_RULES, "seq": ("model",)}

RULE_SETS = {
    "train": TRAIN_RULES,
    "train_ep": TRAIN_EP_RULES,
    "serve": SERVE_RULES,
    "serve_ep": SERVE_EP_RULES,
    "serve_v2": SERVE_V2_RULES,
    "serve_v2_ep": SERVE_V2_EP_RULES,
    "serve_v2_noseq": SERVE_V2_NOSEQ_RULES,
    "serve_v3": SERVE_V3_RULES,
    "serve_sp": SERVE_SP_RULES,
    "train_sp": TRAIN_SP_RULES,
}


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} in the mesh's dim order."""
    if isinstance(mesh.shape, Mapping):
        return dict(mesh.shape)
    names = getattr(mesh, "mesh_dim_names", None)
    if not names:
        raise ValueError(f"mesh {mesh} has no axis names")
    return dict(zip(names, mesh.shape, strict=True))


def _mesh_axes(sizes: dict[str, int], wanted: tuple[str, ...] | None) -> tuple[str, ...]:
    if wanted is None:
        return ()
    return tuple(a for a in wanted if a in sizes)


def _entry(axes: tuple[str, ...]):
    return axes if len(axes) > 1 else axes[0]


def spec_for_axes(mesh, shape: tuple[int, ...], axes: tuple[str | None, ...],
                  rules: dict[str, tuple[str, ...] | None]) -> tuple:
    """Partition spec of one array; replicates non-divisible dims."""
    sizes = axis_sizes(mesh)
    used: set[str] = set()
    entries: list[Any] = []
    for dim, logical in zip(shape, axes):
        if logical is None or logical not in rules:
            entries.append(None)
            continue
        mapped = tuple(a for a in _mesh_axes(sizes, rules[logical]) if a not in used)
        total = math.prod(sizes[a] for a in mapped) if mapped else 1
        if not mapped or dim % total != 0:
            entries.append(None)
            continue
        used.update(mapped)
        entries.append(_entry(mapped))
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def placements(mesh, spec: tuple, ndim: int) -> tuple:
    """DTensor placements of ``spec`` for a tensor of ``ndim`` dims: one
    per mesh dim, ``Shard(d)`` where tensor dim d maps to that mesh axis,
    else ``Replicate()``.  A dim mapped to several axes shards over them in
    the mesh's order (pod-major for ``("pod", "data")``), as ``P`` does.  On
    an axis of size 1 a shard is the whole dim and is placed as
    ``Replicate()`` (DTensor cannot view a sharded dim of size 1)."""
    sizes = axis_sizes(mesh)
    names = list(sizes)
    out: list = [Replicate()] * len(names)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]} used twice in {spec}")
            if sizes[names[i]] > 1:
                out[i] = Shard(d)
    return tuple(out)


def local_shape(mesh, placements_: tuple, shape: tuple[int, ...]) -> tuple[int, ...]:
    """The shard's shape: each dim divided by the sizes of the mesh axes
    that shard it; raises where a dim does not divide."""
    sizes = list(axis_sizes(mesh).values())
    out = list(shape)
    for n, p in zip(sizes, placements_, strict=True):
        if isinstance(p, Shard):
            if out[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not divide over {n}")
            out[p.dim] //= n
    return tuple(out)


def decl_placements(mesh, d: ParamDecl, rules) -> tuple:
    return placements(mesh, spec_for_axes(mesh, d.shape, d.axes, rules), len(d.shape))


def shardings_for_decls(mesh, decl_tree, rules=TRAIN_RULES):
    """Placements tree matching a ParamDecl tree."""
    return tree_map_decls(lambda d: decl_placements(mesh, d, rules), decl_tree)


def batch_spec(mesh, shape: tuple[int, ...], rules=TRAIN_RULES) -> tuple:
    """An input's spec: dim 0 = batch; dim 1 = sequence iff the rule set
    enables sequence parallelism ("seq"); the rest replicated."""
    sizes = axis_sizes(mesh)
    entries: list = []
    bdims = _mesh_axes(sizes, rules["batch"])
    total = math.prod(sizes[a] for a in bdims) if bdims else 1
    if bdims and shape and shape[0] % total == 0:
        entries.append(_entry(bdims))
    else:
        entries.append(None)
    sdims = _mesh_axes(sizes, rules.get("seq"))
    stotal = math.prod(sizes[a] for a in sdims) if sdims else 1
    if sdims and len(shape) >= 2 and shape[1] % stotal == 0:
        entries.append(_entry(sdims))
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def batch_shardings(mesh, specs: dict, rules=TRAIN_RULES) -> dict:
    """Placements for an ``input_specs`` dict (``batch_spec`` of each)."""
    return {k: placements(mesh, batch_spec(mesh, tuple(t.shape), rules), len(t.shape))
            for k, t in specs.items()}


_layouts: list = []   # (mesh, rules) of the open ``activation_layout`` blocks


@contextlib.contextmanager
def activation_layout(mesh, rules):
    """Within the block, ``constrain`` lays the model's residual stream out
    as ``batch_spec`` says (the reference's activations rule: batch over
    ("pod", "data"), the sequence too under a ``"seq"`` rule)."""
    _layouts.append((mesh, rules))
    try:
        yield
    finally:
        _layouts.pop()


def constrain(x):
    """``x`` redistributed to the open ``activation_layout``'s batch layout
    (a pending sum reduced, a stray shard gathered: each a collective); ``x``
    itself outside one, or for a plain tensor.  The model calls it on the
    residual stream after the embedding and after every residual add, where
    GSPMD would propagate the inputs' sharding: a sublayer's pending sum is
    then reduced once, before the next norm reads it."""
    if not _layouts or not isinstance(x, DTensor):
        return x
    mesh, rules = _layouts[-1]
    want = placements(mesh, batch_spec(mesh, tuple(x.shape), rules), x.ndim)
    return x if tuple(x.placements) == want else x.redistribute(mesh, want)


def gather_weights(tree):
    """Within an open ``activation_layout``: each DTensor leaf of ``tree``
    with its shards on the batch axes gathered (FSDP: a weight whose rows
    are sharded over the axis that shards the batch is all-gathered where it
    is used, and its gradient reduce-scattered, as GSPMD does for the
    reference's ``embed -> data`` rule).  Under rules that replicate the
    batch (``serve_v2``) nothing is gathered: the products partial-sum over
    the rows instead.  ``tree`` itself outside one."""
    if not _layouts:
        return tree
    mesh, rules = _layouts[-1]
    sizes = axis_sizes(mesh)
    batch = {list(sizes).index(a) for a in _mesh_axes(sizes, rules["batch"]) if sizes[a] > 1}

    def gather(t):
        if not isinstance(t, DTensor):
            return t
        pl = [Replicate() if i in batch and isinstance(p, Shard) else p
              for i, p in enumerate(t.placements)]
        return t if tuple(pl) == tuple(t.placements) else t.redistribute(t.device_mesh, pl)

    return tree_map(gather, tree)


def channelwise(fn, x, *rest):
    """``fn(x, *rest)`` for an ``fn`` that treats each batch row and each
    channel (x's last dim) apart, along the whole of dim 1 (a causal conv,
    a linear recurrence over time): on a DTensor x, run on its local shards
    (DTensor has no strategy for some of their ops, padding among them, in
    every torch version).  x keeps its shards on dim 0 and on its last dim
    and is gathered elsewhere; each of ``rest`` is shaped like x or is a
    vector over x's channels (last dim), laid out to match.  A plain x
    calls ``fn`` directly."""
    if not isinstance(x, DTensor):
        return fn(x, *rest)
    from repro_torch.kernels._common import sharded_call

    mesh, last = x.device_mesh, x.ndim - 1
    x_pl = tuple(q if isinstance(q, Shard) and q.dim in (0, last) else Replicate()
                 for q in x.placements)
    args, in_pl, grad_pl = [x], [x_pl], [x_pl]
    batch = [i for i, q in enumerate(x_pl) if isinstance(q, Shard) and q.dim == 0]
    for r in rest:
        if r.ndim == x.ndim:
            want = x_pl
            grad = x_pl
        else:  # a vector over the channels: its gradient sums over the batch shards
            want = tuple(Shard(r.ndim - 1) if isinstance(q, Shard) and q.dim == last
                         else Replicate() for q in x_pl)
            grad = tuple(Partial() if i in batch else q for i, q in enumerate(want))
        args.append(r)
        in_pl.append(want)
        grad_pl.append(grad)
    args = [a if tuple(a.placements) == pl else a.redistribute(mesh, pl)
            for a, pl in zip(args, in_pl)]
    return sharded_call(fn, tuple(args), tuple(in_pl), [x_pl], tuple(grad_pl))


def reduce_partial(x):
    """``x`` with every pending sum (``Partial``) all-reduced to
    ``Replicate``; ``x`` itself for a plain tensor."""
    if not isinstance(x, DTensor) or not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in x.placements])


def split_last(x, *shape):
    """``x.reshape(*shape)`` where x's last dim splits into ``shape``'s last
    two (heads, head dim).  A DTensor sharded on that dim over mesh dims
    whose sizes do not divide the heads is gathered on them first (DTensor
    cannot split an uneven shard; the reference's GSPMD replicates it too),
    and its gradient is merged back shard by shard (``_SplitLast``)."""
    if not isinstance(x, DTensor):
        return x.reshape(*shape)
    last = x.ndim - 1
    dims = [i for i, p in enumerate(x.placements) if isinstance(p, Shard) and p.dim == last]
    if dims and shape[-2] % math.prod(x.device_mesh.size(i) for i in dims):
        x = x.redistribute(x.device_mesh, [Replicate() if i in dims else p
                                           for i, p in enumerate(x.placements)])
    return _SplitLast.apply(x, shape)


class _SplitLast(torch.autograd.Function):
    """DTensor ``reshape`` that splits the last dim, whose backward merges
    the gradient's last two dims on each shard as a plain tensor would (a
    view where the local strides allow one, else a copy).  DTensor's own
    backward decides by the global strides, which a gradient's local tensor
    need not have."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape, ctx.stride = x.shape, x.stride()
        return x.reshape(*shape)

    @staticmethod
    def backward(ctx, g):
        n, mesh = g.ndim, g.device_mesh
        last = [i for i, p in enumerate(g.placements)
                if isinstance(p, Shard) and p.dim == n - 1 and mesh.size(i) > 1]
        if last:  # a head-dim shard cannot merge into the heads: gather it
            g = g.redistribute(mesh, [Replicate() if i in last else p
                                      for i, p in enumerate(g.placements)])
        pl = []
        for i, p in enumerate(g.placements):
            if mesh.size(i) == 1:  # a shard of one rank is the whole dim
                p = Replicate()
            pl.append(Shard(n - 2) if isinstance(p, Shard) and p.dim == n - 2 else p)
        local = g.to_local()
        # The product behind it reshapes the gradient to two dims, a copy
        # where it is not contiguous: make that copy here, where DTensor's
        # global strides (contiguous) would otherwise misstate the local's.
        local = local.reshape(*local.shape[:-2], local.shape[-2] * local.shape[-1]).contiguous()
        return DTensor.from_local(local, g.device_mesh, pl, run_check=False, shape=ctx.shape,
                                  stride=ctx.stride), None


def replicated(mesh) -> tuple:
    return (Replicate(),) * len(axis_sizes(mesh))


def _flatten(tree, prefix: str = "") -> list[tuple[str, ParamDecl]]:
    """(path, decl) pairs, the path as ``checkpoint/ckpt.py`` writes keys."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _flatten(v, f"{prefix}['{k}']")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _flatten(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def explain_specs(mesh, decl_tree, rules=TRAIN_RULES) -> list[str]:
    """Human-readable fallback report for the dry-run log."""
    lines: list[str] = []
    for path, d in _flatten(decl_tree):
        spec = spec_for_axes(mesh, d.shape, d.axes, rules)
        wanted = [a for a in d.axes if a and rules.get(a)]
        got = [e for e in spec if e is not None]
        if wanted and not got:
            lines.append(f"{path}: {d.shape} axes={d.axes} -> replicated (non-divisible)")
    return lines
