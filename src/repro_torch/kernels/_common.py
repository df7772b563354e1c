"""What every kernel wrapper and dispatch shares: the dtype codes of the C
entries, the stream handle, the launch-error check and the ``impl`` rule.

``impl=None`` (the main path) hands a call to the kernel wrapper: on a CUDA
tensor it launches the Hopper kernel or raises, on a CPU tensor it computes
the plain version.  ``impl="cuda"`` insists on the kernel and raises for a
CPU tensor instead of returning the plain result.  ``impl="ref"`` runs the
plain version wherever the tensors are; only comparisons (``chip_smoke.py``,
the tests) pass it.

``PlainGrad`` puts a kernel call into autograd: the kernel computes the
forward, and the backward is the plain version's own (recomputed from the
saved inputs).  No kernel's main path uses it: flash attention and the SSD
scan have backward kernels and their own Functions
(``attention/flash_attention.py::FlashAttentionFn``,
``ssd/ssd_scan.py::SsdScanFn``).  ``chip_smoke.py`` times the old route
through it, and the tests hold it against native autograd.

On a ``meta`` tensor a wrapper launches nothing: it propagates the kernel's
output shapes and hands the call's ``Cost`` (the one count of its work, the
wrapper's ``cost`` function) to every counter that ``counting_costs`` has
opened (``launch/dryrun.py``).  Its launch count does not move.

On DTensor operands (a model under a mesh, ``distributed/sharding.py``) a
wrapper takes its sharded route: it reads the operands' placements, reduces
a pending sum (``Partial``) to the layout the call needs (a reduce-scatter
or an all-reduce), raises on any placement it does not handle, makes the
other explicit redistributions its kernel needs (each counted as a
collective by the dry-run), and runs the
kernel on the local shards through ``sharded_call``: launched on the card,
its ``cost`` counted at the local shapes on ``meta``, the plain version on
the CPU.  No wrapper gathers a whole operand quietly or falls back to the
plain version.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.placement_types import Partial, Replicate, Shard

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
IMPLS = (None, "cuda", "ref")


def use_kernel(x: torch.Tensor, impl) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r}; expected one of {IMPLS}")
    if impl == "cuda" and x.device.type != "cuda":
        raise ValueError(
            f"impl='cuda' asks for the CUDA kernel, but the tensors are on {x.device}"
        )
    return impl != "ref"


@dataclasses.dataclass(frozen=True)
class Cost:
    """The least work of one kernel call: the operations of its products by
    the inputs' dtype, and the bytes it must move (each input read once,
    each output written once)."""
    flops: dict[torch.dtype, float]
    bytes: int

    def with_backward(self) -> "Cost":
        """The least work of this call and its backward: each product of
        the forward has two in the backward (one per operand), and the
        backward reads the outputs' cotangents and writes the inputs'
        gradients, the forward's bytes once more."""
        return Cost({dt: 3 * f for dt, f in self.flops.items()}, 2 * self.bytes)


_cost_counters: list = []


@contextlib.contextmanager
def counting_costs(counter):
    """Within the block, ``counter.add_kernel(name, cost)`` takes the work
    of every kernel call on ``meta`` tensors."""
    _cost_counters.append(counter)
    try:
        yield counter
    finally:
        _cost_counters.remove(counter)


def count_meta_call(name: str, cost: Cost) -> None:
    for counter in _cost_counters:
        counter.add_kernel(name, cost)


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# Codes the C entries return besides CUDA's own errors.
OWN_ERRORS = {
    -1: "the driver's cuTensorMapEncodeTiled is not available",
    -2: "the driver refused a TMA tensor map for these operands",
}


def raise_on_error(name: str, err: int) -> None:
    if err < 0:
        raise RuntimeError(f"{name}: {OWN_ERRORS.get(err, f'error {err}')}")
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


class PlainGrad(torch.autograd.Function):
    """A kernel's forward with its plain version's backward.

    ``forward(ctx, kernel, plain, kwargs, *inputs)`` returns
    ``kernel(*inputs, **kwargs)``: a tensor or a tuple of tensors, cut off
    from the graph as any output written through ``data_ptr()`` is.  The
    backward recomputes ``plain(*inputs, **kwargs)`` under
    ``torch.enable_grad()`` on the saved inputs and returns its
    vector-Jacobian product for every input that needs one (``None`` for
    inputs given as ``None``), inside the profiler range
    ``plain_grad.<plain's name>``.  The reference's Pallas kernels have no
    ``custom_vjp``, and ``jax.grad`` differentiates their plain versions.
    No kernel's main path uses this Function: flash attention and the SSD
    scan run their backward kernels (``FlashAttentionFn``, ``SsdScanFn``);
    it is the old route that ``chip_smoke.py`` times beside them.  A test
    injects the plain version as ``kernel`` to hold this backward against
    native autograd on the CPU.
    """

    @staticmethod
    def forward(ctx, kernel, plain, kwargs, *inputs):
        ctx.plain, ctx.kwargs = plain, kwargs
        ctx.save_for_backward(*inputs)
        ctx.set_materialize_grads(False)
        return kernel(*inputs, **kwargs)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        wanted = [i for i, t in enumerate(saved)
                  if t is not None and ctx.needs_input_grad[3 + i]]
        with torch.enable_grad(), torch.profiler.record_function(
                f"plain_grad.{ctx.plain.__name__}"):
            inputs = [None if t is None else t.detach().requires_grad_(i in wanted)
                      for i, t in enumerate(saved)]
            outs = ctx.plain(*inputs, **ctx.kwargs)
            outs = outs if isinstance(outs, tuple) else (outs,)
            pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
            got = torch.autograd.grad([o for o, _ in pairs], [inputs[i] for i in wanted],
                                      [g for _, g in pairs], allow_unused=True)
        out = [None] * len(saved)
        for i, g in zip(wanted, got):
            out[i] = g
        return (None, None, None, *out)


def shard_index(mesh, dims: list[int]) -> tuple[int, int]:
    """(count, index) of this rank's shard over the mesh dims ``dims``
    together, row-major in the mesh's order."""
    coord = mesh.get_coordinate()
    n, r = 1, 0
    for i in dims:
        n, r = n * mesh.size(i), r * mesh.size(i) + coord[i]
    return n, r


def unit_dims_replicated(t: DTensor) -> DTensor:
    """``t`` with every placement on a mesh dim of size 1 made
    ``Replicate`` (a shard or a pending sum over one rank is the whole
    tensor): the same local tensor, no collective."""
    mesh = t.device_mesh
    pl = tuple(Replicate() if mesh.size(i) == 1 else p for i, p in enumerate(t.placements))
    if pl == tuple(t.placements):
        return t
    return DTensor.from_local(t.to_local(), mesh, pl, run_check=False, shape=t.shape,
                              stride=t.stride())


def check_placements(name: str, operand: str, t: DTensor, allowed: tuple[int, ...]) -> None:
    """Raise unless every placement of ``t`` is ``Replicate`` or a
    ``Shard`` of one of the dims in ``allowed``."""
    for i, p in enumerate(t.placements):
        if isinstance(p, Replicate) or (isinstance(p, Shard) and p.dim in allowed):
            continue
        raise ValueError(f"{name}: {operand} has placement {p} on mesh dim {i} "
                         f"({t.placements}); the sharded route takes Replicate or Shard of "
                         f"dims {allowed}")


def resolve_partial(t: DTensor, targets: dict[int, object]) -> DTensor:
    """``t`` with each ``Partial`` placement replaced by ``targets[mesh
    dim]`` (a ``Shard``: reduce-scatter; ``Replicate``: all-reduce)."""
    pl = [targets[i] if isinstance(p, Partial) else p for i, p in enumerate(t.placements)]
    return t if tuple(pl) == tuple(t.placements) else t.redistribute(t.device_mesh, pl)


def replicate_dims(t: DTensor, dims) -> DTensor:
    """``t`` with its placements on the mesh dims ``dims`` made
    ``Replicate`` (an explicit collective; ``t`` itself where none changes)."""
    pl = [Replicate() if i in dims else p for i, p in enumerate(t.placements)]
    return t if tuple(pl) == tuple(t.placements) else t.redistribute(t.device_mesh, pl)


def partial_on(placements, dims) -> tuple:
    """``placements`` with ``Partial()`` on the mesh dims ``dims``: the
    gradient layout of an operand that every rank of those dims reads in
    part."""
    return tuple(Partial() if i in dims else p for i, p in enumerate(placements))


def even_shards(name: str, t: DTensor) -> None:
    """Raise unless each sharded dim of ``t`` divides evenly over its mesh dims."""
    for d in range(t.ndim):
        n = math.prod(t.device_mesh.size(i) for i, p in enumerate(t.placements)
                      if isinstance(p, Shard) and p.dim == d)
        if t.shape[d] % n:
            raise ValueError(f"{name}: dim {d} of {tuple(t.shape)} is sharded unevenly over {n}")


def sharded_call(fn, args: tuple, in_placements: tuple, out_placements: list,
                 grad_placements=None):
    """``fn`` on the local shards of ``args`` (``local_map``): every DTensor
    argument must already have its ``in_placements`` entry (None for a
    non-tensor), the outputs are DTensors of ``out_placements`` (one
    placement tuple per output: ``fn`` returns one tensor for a list of
    one), and autograd hands each input's gradient back with its
    ``grad_placements`` entry (default: its placements)."""
    from torch.distributed.tensor.experimental import local_map

    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    outs = list(out_placements[0]) if len(out_placements) == 1 else tuple(out_placements)
    return local_map(fn, out_placements=outs, in_placements=in_placements,
                     in_grad_placements=grad_placements, device_mesh=mesh,
                     redistribute_inputs=False)(*args)
