"""The card the roofline is drawn for (port of ``repro/launch/mesh.py``).

The reference's ``HW`` describes one TPU v5e chip of a 256- or 512-chip
mesh.  The port runs on one GPU, so ``hw()`` describes that card: its name,
SM count and memory read from the device when one is present, its memory
rate and peak product rates taken from NVIDIA's data sheet for the SKU its
name matches (dense rates, no sparsity).  Float32 products run at the FMA
pipes' rate, not TF32's: the port keeps TF32 off (``chip_smoke.py``).
Without a card, ``hw()`` is the data sheet of the SXM H100 (or of ``sku``).

The production meshes are the reference's 16x16 ``("data", "model")`` and
2x16x16 ``("pod", "data", "model")`` meshes, here of H100s in HGX nodes of
8 (``make_production_mesh``: a description, no devices).  ``device_mesh``
builds a ``DeviceMesh`` from one: over a ``fake`` process group for counting
on ``meta`` (the dry-run and roofline), over NCCL on cards, over gloo on the
CPU when asked.  The collective term of ``roofline_terms`` charges each mesh
axis's collective bytes at the rate of the slowest link its groups cross:
NVLink inside a node of 8 consecutive ranks, the inter-node fabric
otherwise.  Without a mesh the term is 0.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.core.sharding import free_port

# (key in the device name, SMs, HBM bytes, HBM bytes/s, {dtype: product flop/s},
# NVLink bytes/s of both directions together), from NVIDIA's data sheets; the
# first entry whose key is in the name applies.
SKUS = (
    ("H200", 132, 141e9, 4.8e12, {torch.bfloat16: 989e12, torch.float32: 67e12}, 900e9),
    ("H100 PCIe", 114, 80e9, 2.0e12, {torch.bfloat16: 756e12, torch.float32: 51e12}, 600e9),
    ("H100 NVL", 132, 94e9, 3.9e12, {torch.bfloat16: 835e12, torch.float32: 60e12}, 600e9),
    ("H100", 132, 80e9, 3.35e12, {torch.bfloat16: 989e12, torch.float32: 67e12}, 900e9),  # SXM
)
# Between nodes: one NDR InfiniBand port of 400 Gb/s per GPU (HGX H100).
INTERNODE_BW = 400e9 / 8
NODE_SIZE = 8   # GPUs of one HGX node, joined all to all by NVLink
DEFAULT_SKU = "NVIDIA H100 80GB HBM3"
# The artifacts' file tag: experiments/*_torch/<arch>_<shape>_h100.json.
TAG = "h100"


def sku(name: str) -> tuple:
    """The data-sheet row whose key is in ``name``."""
    for row in SKUS:
        if row[0] in name:
            return row
    raise ValueError(f"no data-sheet row for {name!r}")


def hw(name: str | None = None) -> dict:
    """The card's roofline parameters.

    ``name=None`` reads CUDA device 0 where there is one (its name, SM
    count and ``total_memory``); otherwise, or for a given ``name``, the
    data sheet's row for that name."""
    on_card = name is None and torch.cuda.is_available()
    if on_card:
        props = torch.cuda.get_device_properties(0)
        name, sms, hbm = props.name, props.multi_processor_count, props.total_memory
    name = name or DEFAULT_SKU
    key, sheet_sms, sheet_hbm, bw, peaks, nvlink = sku(name)
    return {
        "name": name, "sku": key, "from_device": on_card,
        "sms": sms if on_card else sheet_sms,
        "hbm_bytes": int(hbm if on_card else sheet_hbm),
        "hbm_bw": bw,
        "peak_flops": dict(peaks),
        "peak_flops_bf16": peaks[torch.bfloat16],   # the reference's key
        "nvlink_bw": nvlink / 2,                     # each direction
        "internode_bw": INTERNODE_BW,
    }


def roofline_terms(flops: dict, bytes_moved: float, card: dict, coll_by_axis=None,
                   desc: "MeshDesc | None" = None) -> dict:
    """Seconds: compute Σ flops of each dtype over its peak, memory bytes
    over the memory rate, collective Σ over mesh axes of that axis's
    collective bytes over ``link_bw`` (0 without a mesh)."""
    coll = 0.0
    if desc is not None:
        coll = sum(n / link_bw(desc, axis, card) for axis, n in (coll_by_axis or {}).items())
    return {
        "compute": sum(f / card["peak_flops"][dt] for dt, f in flops.items()),
        "memory": bytes_moved / card["hbm_bw"],
        "collective": coll,
    }


def bound_ms(cost, card: dict) -> tuple[float, str]:
    """A kernel call's least time in ms and what bounds it: the larger of
    its bytes over the memory rate and its operations over the peak rate of
    their dtype (``kernels._common.Cost``)."""
    terms = roofline_terms(cost.flops, cost.bytes, card)
    t_bytes, t_ops = terms["memory"] * 1e3, terms["compute"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshDesc:
    """A mesh of cards: axis names and sizes (ranks row-major over them)
    and the cards of one NVLink node."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    node_size: int = NODE_SIZE

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes, strict=True))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def groups(self, axis: str) -> list[list[int]]:
        """The ranks of every group along ``axis``."""
        i = self.axis_names.index(axis)
        stride = math.prod(self.sizes[i + 1:])
        bases = [r for r in range(self.size) if (r // stride) % self.sizes[i] == 0]
        return [[b + k * stride for k in range(self.sizes[i])] for b in bases]

    def within_node(self, axis: str) -> bool:
        """Whether every group along ``axis`` lies in one node of
        ``node_size`` consecutive ranks."""
        return all(len({r // self.node_size for r in g}) == 1 for g in self.groups(axis))


def make_production_mesh(*, multi_pod: bool = False) -> MeshDesc:
    """16x16 single pod (256 cards) or 2x16x16 two-pod (512 cards)."""
    if multi_pod:
        return MeshDesc(("pod", "data", "model"), (2, 16, 16))
    return MeshDesc(("data", "model"), (16, 16))


def link_bw(desc: MeshDesc, axis: str, card: dict) -> float:
    """Bytes/s of the slowest link ``axis``'s groups cross."""
    return card["nvlink_bw"] if desc.within_node(axis) else card["internode_bw"]


FAKE_WORLD = 512   # the 2x16x16 mesh: every production mesh fits in one fake group
_fake_meshes: dict = {}


def init_fake_group(world_size: int = FAKE_WORLD) -> None:
    """A process group of ``world_size`` ranks, this process rank 0, that
    runs no collective (``torch.testing``'s ``fake`` backend): DTensor
    emits and the dry-run counts each collective; on ``meta`` nothing moves.
    Kept for the process: a smaller mesh takes the group's first ranks."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()} process group is already initialized")
        if dist.get_world_size() >= world_size:
            return
        dist.destroy_process_group()
        _fake_meshes.clear()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def device_mesh(desc: MeshDesc, backend: str):
    """A ``DeviceMesh`` of ``desc``: ``"fake"`` (for counting on meta, over
    the first ``desc.size`` ranks of the fake group, made here; one mesh per
    description and process, since DTensor caches its plans by mesh),
    ``"nccl"`` (cards; the caller's group of ``desc.size`` ranks) or
    ``"gloo"`` (the CPU, only when asked)."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    if backend == "fake":
        init_fake_group(max(FAKE_WORLD, desc.size))
        if desc not in _fake_meshes:
            ranks = torch.arange(desc.size).view(desc.sizes)
            # A "cuda" mesh of meta tensors: nothing touches a device, and
            # DTensor picks the collectives it would pick on cards.
            _fake_meshes[desc] = DeviceMesh("cuda", ranks, mesh_dim_names=desc.axis_names)
        return _fake_meshes[desc]
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("device_mesh: the nccl backend needs CUDA")
        device_type = "cuda"
    elif backend == "gloo":
        device_type = "cpu"
    else:
        raise ValueError(f"device_mesh: backend {backend!r}; expected fake, nccl or gloo")
    if not dist.is_initialized() or dist.get_backend() != backend:
        raise RuntimeError(f"device_mesh: initialize a {backend} process group first")
    if dist.get_world_size() != desc.size:
        raise RuntimeError(f"device_mesh: {dist.get_world_size()} ranks, the mesh has "
                           f"{desc.size}")
    return init_device_mesh(device_type, desc.sizes, mesh_dim_names=desc.axis_names)


def make_host_mesh(device="cuda"):
    """The ranks that exist as a 1D ``("data",)`` mesh: the initialized
    process group's, or one rank (a group of one is made at a free local
    port; one on one card).  On ``cuda`` over NCCL, raising without a card;
    on ``cpu`` over gloo, only when asked."""
    device = torch.device(device).type
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_host_mesh: no CUDA device; pass device='cpu' for the CPU")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"make_host_mesh: device {device!r}")
    backend = "nccl" if device == "cuda" else "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=f"tcp://localhost:{free_port()}",
                                rank=0, world_size=1)
    return device_mesh(MeshDesc(("data",), (dist.get_world_size(),)), backend)
