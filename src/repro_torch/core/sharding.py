"""Process-group mesh for the sweep grids — mesh, padding, blocks (port of
``repro/core/sharding.py``).

The sweep evaluation surface is a (batch × policy × scenario) grid of
*independent* cells, which makes it embarrassingly shardable: this module
owns how that grid is laid out over the ranks of a ``torch.distributed``
process group, so ``core/sweep.py`` can stay about orchestration.

**Mesh.** ``grid_mesh()`` builds (and caches, one per shape and process
group) a 3D ``DeviceMesh`` over every rank of the default group, with axes

    ("data", "grid", "policy")

where ``data`` carries the batched sweep axis (fleet | workflow | capacity
| failure), ``grid`` the scenario axis and ``policy`` optionally the
allocation-policy stack.  By default the policy axis is a singleton (dp=1).
Callers opt in with ``shard="3d"`` (near-cubic ``mesh_shape_3d`` factoring:
8 ranks → 2×2×2), ``REPRO_SWEEP_POLICY_DEVICES=<dp>`` (explicit width) or
``REPRO_SWEEP_MESH3D=1`` (global switch).  With dp>1 each rank runs its
policy *block* (``simulator.simulate_stream_core``'s ``policy_block``, the
rank's policy coordinate); a policy count that dp does not divide pads with
repeats of policy 0, stripped afterwards.  The remaining ``ranks/dp``
factor splits near-square with the larger factor on ``grid`` (8 ranks,
dp=1 → 2 × 4).  CPU ranks talk over gloo, CUDA ranks over NCCL
(``backend``).

**Device count.** The counterpart of ``jax.device_count()`` is the world
size of the default process group (``device_count``), 1 when no group is
initialized: one card, or one CPU process, runs the unsharded path, as the
reference does on one device.

**Blocks.** ``grid_specs`` gives, for each grid input and for the outputs,
which leading axis is cut over which mesh axes — the reference's
``PartitionSpec``s as plain tuples.  ``shard_block`` cuts a rank's block out
of an input by its mesh coordinate, and ``assemble`` puts every rank's
output block back in place.  The block body is a plain function of
(inputs, mesh shape, coordinate), so one process can run every rank's
block in turn (``core/sweep.py`` with a ``(dd, dg, dp)`` tuple for
``shard``), and a process group runs one block per rank and gathers them
(``all_gather_blocks``).

**Divisibility.** A sharded axis must divide its mesh axis.  Non-divisible
axes are **padded** to the next multiple with copies of row 0 (always-valid
cells) and the padded rows are stripped afterwards — metrics are identical
to the unpadded grid.

**Escape hatch.** ``REPRO_SWEEP_SHARD=0`` in the environment forces the
unsharded path everywhere, whatever the world size.

**Host ranks.** On a CPU host the multi-rank path runs as N processes of
one gloo group: ``host_device_env`` builds a subprocess environment for
rank r of N (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, no
visible CUDA device, one intra-op thread), and the child initializes its
group with ``init_process_group``.  The reference's
``force_host_device_count`` (an XLA flag that makes one process see N
devices) has no torch counterpart: a process group's ranks are processes.
"""
from __future__ import annotations

import dataclasses
import math
import os
import socket
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"      # batched sweep axis: fleet | workflow | capacity | failure
GRID_AXIS = "grid"      # scenario axis
POLICY_AXIS = "policy"  # allocation-policy axis (the (P, ...) state stack rows)
MESH_AXES = (DATA_AXIS, GRID_AXIS, POLICY_AXIS)

SHARD_ENV = "REPRO_SWEEP_SHARD"
MESH3D_ENV = "REPRO_SWEEP_MESH3D"          # "1": auto near-cubic policy axis
POLICY_ENV = "REPRO_SWEEP_POLICY_DEVICES"  # explicit dp override

_BACKENDS = {"cpu": "gloo", "cuda": "nccl"}


def shard_env_enabled() -> bool:
    """False iff ``REPRO_SWEEP_SHARD=0`` (or ``false``/``off``) is set."""
    return os.environ.get(SHARD_ENV, "").lower() not in ("0", "false", "off")


def device_count() -> int:
    """The ranks of the default process group; 1 when none is initialized."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def should_shard(flag: bool | None = None) -> bool:
    """Resolve one sweep call's sharding decision.

    ``flag=False`` always wins; the ``REPRO_SWEEP_SHARD=0`` escape hatch
    wins next; otherwise shard exactly when more than one rank is live (on
    one rank the sharded and unsharded programs are the same placement, and
    the plain path keeps single-rank results bit-identical by
    construction).
    """
    if flag is False:
        return False
    if not shard_env_enabled():
        return False
    return device_count() > 1


def mesh_shape(num_devices: int) -> tuple[int, int]:
    """Factor ``num_devices`` into (data, grid) mesh dims, near-square with
    the larger factor on ``grid`` — the scenario axis dominates paper-style
    grids, so it gets the wider slice of the machine."""
    n = int(num_devices)
    if n < 1:
        raise ValueError(f"need at least one device, got {n}")
    dd = max(k for k in range(1, math.isqrt(n) + 1) if n % k == 0)
    return dd, n // dd


def mesh_shape_3d(num_devices: int) -> tuple[int, int, int]:
    """Factor ``num_devices`` into (data, grid, policy) mesh dims,
    near-cubic: the policy axis takes the largest divisor whose cube fits
    (8 → 2×2×2, 64 → 4×4×4), the remainder splits near-square with the
    larger factor on ``grid`` exactly as in the 2D layout.  Primes land
    entirely on ``grid`` (7 → 1×7×1)."""
    n = int(num_devices)
    if n < 1:
        raise ValueError(f"need at least one device, got {n}")
    dp = max(k for k in range(1, n + 1) if n % k == 0 and k ** 3 <= n)
    dd, dg = mesh_shape(n // dp)
    return dd, dg, dp


def backend(device_type: str) -> str:
    """The collective backend of a rank's device type: gloo on the CPU,
    NCCL on the card."""
    if device_type not in _BACKENDS:
        raise ValueError(f"no sweep mesh backend for device type {device_type!r}")
    return _BACKENDS[device_type]


def init_process_group(device_type: str = "cpu") -> None:
    """Join the default process group from the environment
    (``host_device_env``'s, or a launcher's) with ``backend(device_type)``."""
    dist.init_process_group(backend=backend(device_type), init_method="env://")


_MESHES: dict = {}


def grid_mesh(num_devices: int | None = None, policy_devices: int = 1,
              device_type: str = "cpu"):
    """The cached ``("data", "grid", "policy")`` sweep mesh over every rank
    of the default process group.

    ``policy_devices`` (dp) is the policy-axis width; the remaining
    ``num_devices / dp`` factor splits near-square over (data, grid).  Built
    with ``init_device_mesh`` once per (shape, device type, group) and
    cached with its own process group over the mesh's ranks (the group the
    blocks are gathered over).  Raises when no process group is
    initialized or when the mesh does not cover its ranks: a sharded sweep
    never falls back to one rank.
    """
    n = device_count() if num_devices is None else int(num_devices)
    dp = int(policy_devices)
    if dp < 1 or n % dp:
        raise ValueError(f"policy_devices={dp} must divide the device count {n}")
    dd, dg = mesh_shape(n // dp)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "the sweep mesh needs an initialized torch.distributed process group "
            "(sharding.init_process_group; host_device_env for CPU ranks)")
    if dist.get_world_size() != n:
        raise RuntimeError(f"a mesh of {n} ranks over a process group of "
                           f"{dist.get_world_size()}")
    key = (dd, dg, dp, device_type, dist.group.WORLD)
    if key not in _MESHES:
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh(device_type, (dd, dg, dp), mesh_dim_names=MESH_AXES)
        group = dist.new_group(ranks=mesh.mesh.flatten().tolist())
        _MESHES[key] = (mesh, group)
    return _MESHES[key][0]


def mesh_group(mesh):
    """The process group over every rank of a ``grid_mesh``."""
    for m, group in _MESHES.values():
        if m is mesh:
            return group
    raise ValueError("not a mesh built by grid_mesh")


def mesh_dims(mesh) -> tuple[int, int, int]:
    """(dd, dg, dp) of a ``grid_mesh`` or of a (dd, dg, dp) tuple."""
    if isinstance(mesh, tuple):
        return tuple(int(d) for d in mesh)
    return tuple(int(mesh.size(mesh.mesh_dim_names.index(a))) for a in MESH_AXES)


def rank_coordinate(rank: int, dims: tuple[int, int, int]) -> dict[str, int]:
    """Rank ``rank``'s coordinate on a (dd, dg, dp) mesh (row-major, as
    ``init_device_mesh`` lays the ranks out)."""
    return dict(zip(MESH_AXES, (int(c) for c in np.unravel_index(rank, dims))))


def policy_mesh_devices(flag=None) -> int:
    """Resolve one sweep call's policy-axis device count (dp).

    ``dp=1`` — the 2D layout — unless the caller opts in: ``shard="3d"``
    requests the near-cubic ``mesh_shape_3d`` factoring, the
    ``REPRO_SWEEP_POLICY_DEVICES`` env var pins an explicit dp, and
    ``REPRO_SWEEP_MESH3D=1`` turns the near-cubic factoring on globally.
    Whenever sharding itself is off (``should_shard``), dp is 1.
    """
    if not should_shard(flag):
        return 1
    n = device_count()
    env_dp = os.environ.get(POLICY_ENV, "")
    if env_dp:
        dp = int(env_dp)
        if dp < 1 or n % dp:
            raise ValueError(f"{POLICY_ENV}={dp} must divide the device count {n}")
        return dp
    if flag == "3d" or os.environ.get(MESH3D_ENV, "").lower() in ("1", "true", "on"):
        return mesh_shape_3d(n)[2]
    return 1


def pad_axis(x, axis: int, multiple: int):
    """Pad ``x`` along ``axis`` up to the next multiple of ``multiple`` by
    repeating the slice at index 0.  ``x`` is a tensor, a numpy array or a
    list of rows (axis 0).

    Repeating a *real* row (rather than zeros) keeps every padded cell a
    well-posed simulation — no degenerate fleets, no NaN risk anywhere in
    the padded block.  Callers strip the rows after the grid runs.
    """
    if isinstance(x, list):
        if axis != 0:
            raise ValueError("a list of rows pads along axis 0 only")
        return x + [x[0]] * ((-len(x)) % multiple)
    pad = (-x.shape[axis]) % multiple
    if pad == 0:
        return x
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(0, 1)
    filler_shape = tuple(x.shape[:axis]) + (pad,) + tuple(x.shape[axis + 1:])
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x[tuple(idx)].expand(filler_shape)], dim=axis)
    return np.concatenate([x, np.broadcast_to(x[tuple(idx)], filler_shape)], axis=axis)


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _map_fields(fn, obj):
    """``fn`` over every tensor and array field of a dataclass (static
    fields — names, step counts, python numbers — pass through)."""
    return dataclasses.replace(obj, **{
        f.name: fn(getattr(obj, f.name)) for f in dataclasses.fields(obj)
        if f.init and _is_leaf(getattr(obj, f.name))})


def pad_tree_axis(tree: Any, axis: int, multiple: int) -> Any:
    """``pad_axis`` over a stacked tree: every tensor and array field of a
    dataclass (Fleet / Workflow / CapacityConfig / FailureSpec /
    WorkloadSpec batches — static fields like names pass through), each
    leaf of a tuple or dict, a list of rows as rows.  ``None`` stays."""
    if tree is None:
        return None
    if _is_leaf(tree) or isinstance(tree, list):
        return pad_axis(tree, axis, multiple)
    if dataclasses.is_dataclass(tree):
        return _map_fields(lambda x: pad_axis(x, axis, multiple), tree)
    if isinstance(tree, tuple):
        return tuple(pad_tree_axis(x, axis, multiple) for x in tree)
    if isinstance(tree, dict):
        return {k: pad_tree_axis(v, axis, multiple) for k, v in tree.items()}
    raise TypeError(f"cannot pad a {type(tree).__name__}")


def grid_specs(batch_axis: str | None, policy: bool = False) -> tuple[tuple, tuple]:
    """(in_specs, out_spec) for one sharded streaming grid call.

    A spec is the reference's ``PartitionSpec`` as a tuple: entry k names
    the mesh axis (or a tuple of axes, flattened row-major) that leading
    axis k is cut over, ``None`` or a missing entry keeps it whole.
    ``in_specs`` covers ``(arrivals, fleet, workflow, capacity, wspec,
    fspec)``; a spec applies to every tensor field of a stacked tree and to
    a list of rows.  ``wspec`` (a stacked ``WorkloadSpec``, the in-loop
    synthesis twin of the arrivals tensor) always cuts like arrivals: its
    fields carry the same leading scenario/batch axes.  ``fspec`` is whole
    except under ``batch_axis="failure"``, where its rows cut over
    ``data``.  With a batch axis, the batch cuts over ``data`` and the
    scenario axis over ``grid``; the plain ``sweep`` grid has only a
    scenario axis, which cuts over the *flattened* (data × grid) plane so no
    rank idles.  ``out_spec`` covers the four stream outputs, laid out
    ([batch,] policy, scenario, ·); with ``policy=True`` the policy dim
    cuts over the third mesh axis (each rank computes only its own block of
    policy rows; its inputs are the same along ``policy``).
    """
    pol = POLICY_AXIS if policy else None
    if batch_axis is None:
        both = (DATA_AXIS, GRID_AXIS)
        return ((both,), (), (), (), (both,), ()), (pol, both)
    arrivals = {
        "fleet": (DATA_AXIS, GRID_AXIS),   # (F, W, S, N): per-fleet columns
        "workflow": (GRID_AXIS,),          # (W, S, N): one shared block
        "capacity": (GRID_AXIS,),
        "failure": (GRID_AXIS,),
    }[batch_axis]
    batched = (DATA_AXIS,)
    fleet = batched if batch_axis == "fleet" else ()
    workflow = batched if batch_axis == "workflow" else ()
    capacity = batched if batch_axis == "capacity" else ()
    fspec = batched if batch_axis == "failure" else ()
    return (arrivals, fleet, workflow, capacity, arrivals, fspec), (DATA_AXIS, pol, GRID_AXIS)


def _axis_part(axes, dims: dict, coord: dict) -> tuple[int, int]:
    """(parts, index) of one spec entry: how many blocks the axis is cut
    into and which of them the coordinate holds."""
    if axes is None:
        return 1, 0
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    parts, index = 1, 0
    for a in axes:
        parts *= dims[a]
        index = index * dims[a] + coord[a]
    return parts, index


def _cut(x, spec: tuple, dims: dict, coord: dict):
    if isinstance(x, list) and len(spec) > 1:
        raise ValueError("a list of rows is cut along its first axis only")
    for axis, axes in enumerate(spec):
        parts, index = _axis_part(axes, dims, coord)
        size = len(x) if isinstance(x, list) else x.shape[axis]
        if size % parts:
            raise ValueError(f"axis {axis} of size {size} does not split into {parts} "
                             "blocks; pad it first (pad_axis)")
        step = size // parts
        if isinstance(x, list):
            x = x[index * step:(index + 1) * step]
        else:
            idx = [slice(None)] * axis + [slice(index * step, (index + 1) * step)]
            x = x[tuple(idx)]
    return x


def shard_block(tree: Any, spec: tuple, dims, coord: dict) -> Any:
    """The block of ``tree`` that the rank at ``coord`` of a (dd, dg, dp)
    mesh holds under ``spec`` (one entry of ``grid_specs``): tensors,
    arrays, lists of rows and every tensor field of a dataclass."""
    dims = dict(zip(MESH_AXES, dims))
    if tree is None or not spec:
        return tree
    if _is_leaf(tree) or isinstance(tree, list):
        return _cut(tree, spec, dims, coord)
    if dataclasses.is_dataclass(tree):
        return _map_fields(lambda x: _cut(x, spec, dims, coord), tree)
    raise TypeError(f"cannot cut a {type(tree).__name__}")


def assemble(blocks: list[torch.Tensor], spec: tuple, dims) -> torch.Tensor:
    """The whole tensor from every rank's block under ``spec``; ``blocks[r]``
    is rank r's (``rank_coordinate``).  Ranks that hold the same block
    (an axis the spec does not name) write the same values."""
    dims = tuple(dims)
    named = dict(zip(MESH_AXES, dims))
    first = blocks[0]
    shape = list(first.shape)
    for axis, axes in enumerate(spec):
        shape[axis] *= _axis_part(axes, named, dict.fromkeys(MESH_AXES, 0))[0]
    out = first.new_empty(shape)
    for rank, block in enumerate(blocks):
        coord = rank_coordinate(rank, dims)
        idx = []
        for axis, axes in enumerate(spec):
            index = _axis_part(axes, named, coord)[1]
            step = block.shape[axis]
            idx.append(slice(index * step, (index + 1) * step))
        out[tuple(idx)] = block
    return out


def all_gather_blocks(block: tuple, mesh) -> list[tuple]:
    """Every rank's block of a tuple of tensors, gathered over the mesh's
    group (``mesh_group``): ``out[r]`` is rank r's tuple.  Each tensor has
    the same shape on every rank (the axes are padded to the mesh)."""
    group = mesh_group(mesh)
    world = dist.get_world_size(group)
    gathered = []
    for x in block:
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x, group=group)
        gathered.append(parts)
    return [tuple(parts[r] for parts in gathered) for r in range(world)]


# -- host ranks (CPU multi-rank harness) -------------------------------------


def free_port() -> int:
    """A TCP port on ``localhost`` that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def host_device_env(num_devices: int, rank: int = 0, port: int | None = None,
                    base_env: dict | None = None) -> dict[str, str]:
    """Environment for rank ``rank`` of ``num_devices`` CPU ranks on this
    host: the rendezvous (``MASTER_ADDR`` localhost, ``MASTER_PORT``),
    ``RANK`` and ``WORLD_SIZE`` that ``init_process_group`` reads, no
    visible CUDA device, and one intra-op thread per rank (N ranks share
    the host's cores).  Every rank of one group takes the same ``port``."""
    if not 0 <= int(rank) < int(num_devices):
        raise ValueError(f"rank {rank} outside a group of {num_devices}")
    env = dict(os.environ if base_env is None else base_env)
    env.update({
        "MASTER_ADDR": "127.0.0.1",
        "MASTER_PORT": str(free_port() if port is None else int(port)),
        "RANK": str(int(rank)),
        "WORLD_SIZE": str(int(num_devices)),
        "CUDA_VISIBLE_DEVICES": "",
        "OMP_NUM_THREADS": "1",
    })
    return env
