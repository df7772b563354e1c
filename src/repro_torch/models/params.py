"""Parameter declaration trees: one source of truth for shape and init.

Port of ``repro/models/params.py``.  A model builder returns a nested
structure of dicts and lists whose leaves are ``ParamDecl``; ``init_params``
materializes it as tensors, ``abstract_params`` as ``meta`` tensors (shapes
and dtypes, no memory) for the dry-run.  Where the reference stacks layers
on a leading ``layers`` axis, the port keeps a Python list with one entry
per layer, so a per-layer weight has the shape the reference's stacked
weight has without its first axis — and the same fan-in (``shape[-2]``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch._device import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamDecl:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]   # logical axis name per dim (documentation)
    init: str = "normal"           # normal | zeros | ones
    scale: float | None = None     # default: 1/sqrt(fan_in)
    dtype: torch.dtype | None = None

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def decl(shape, axes, init="normal", scale=None, dtype=None) -> ParamDecl:
    return ParamDecl(tuple(shape), tuple(axes), init, scale, dtype)


def is_decl(x) -> bool:
    return isinstance(x, ParamDecl)


def tree_map_decls(fn: Callable, tree):
    """``fn`` over every ``ParamDecl`` of a declaration tree."""
    return tree_map(fn, tree)


def tree_map(fn: Callable, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts/lists (and parallel trees)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def abstract_params(decl_tree, dtype=torch.bfloat16):
    """``meta`` tensors of each declaration's shape and dtype (``dtype``
    unless the declaration names its own): what the dry-run runs against."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype or dtype, device="meta"),
                    decl_tree)


def distribute_abstract(decl_tree, mesh, rules, dtype=torch.bfloat16):
    """``abstract_params`` as DTensors on ``mesh``: each leaf's placements
    are ``distributed.sharding``'s for its declaration under ``rules``, and
    its local tensor is a ``meta`` tensor of the shard's shape (no memory
    on any rank).  Parameters, caches (``cache_decls``) and any other
    declaration tree alike."""
    from repro_torch.distributed import sharding

    def make(d: ParamDecl):
        pl = sharding.decl_placements(mesh, d, rules)
        return abstract_dtensor(mesh, pl, d.shape, d.dtype or dtype)

    return tree_map(make, decl_tree)


def distribute_params(tree, decl_tree, mesh, rules):
    """The tensors of ``tree`` (its declarations in ``decl_tree``) as
    DTensors over ``mesh`` placed as ``distribute_abstract`` places them
    (``torch.distributed.tensor.distribute_tensor``: each rank keeps its
    shard of rank 0's tensor)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed import sharding

    return tree_map(lambda t, d: distribute_tensor(t, mesh, sharding.decl_placements(mesh, d, rules)),
                    tree, decl_tree)


def abstract_dtensor(mesh, placements, shape, dtype):
    """A DTensor of global ``shape`` with ``placements`` over ``mesh``
    whose local tensor is on ``meta``."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import sharding

    local = torch.empty(sharding.local_shape(mesh, placements, shape), dtype=dtype,
                        device="meta")
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def init_params(decl_tree, generator: torch.Generator | int = 0,
                dtype=torch.bfloat16, device="cuda"):
    """Materialize parameters on ``device`` from a seeded generator.

    Same scale rule as the reference: normal · 1/√fan_in with
    fan_in = ``shape[-2]`` (``shape[-1]`` for vectors), drawn in float32
    and cast.  The draws differ from ``jax.random``'s; tests that compare
    with the JAX package convert its parameters (``models/convert.py``).
    On ``meta`` there is nothing to draw: the tree is ``abstract_params``'.
    """
    dev = resolve_device(device)
    if dev.type == "meta":
        return abstract_params(decl_tree, dtype)
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=dev).manual_seed(int(generator))

    def make(d: ParamDecl):
        dt = d.dtype or dtype
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=dev)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=dev)
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        scale = d.scale if d.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
        x = torch.randn(d.shape, generator=generator, dtype=torch.float32, device=dev)
        return x.mul_(scale).to(dt)

    return tree_map(make, decl_tree)


def param_bytes(decl_tree, bytes_per_el: int = 2) -> int:
    return sum(math.prod(d.shape) for d in tree_leaves(decl_tree)) * bytes_per_el


def count_params(decl_tree) -> int:
    return param_bytes(decl_tree, 1)
