"""Dry-run: every (architecture x input shape) on torch's ``meta`` device, at
published widths, with no memory allocated (port of
``repro/launch/dryrun.py``).

For each pair the step the shape dictates runs once on ``meta`` tensors:
``build_train_step``'s step for ``train``, ``api.prefill`` for ``prefill``,
``api.decode_step`` for ``decode`` (one token against a full cache of
``seq_len`` entries).  The kernels take their meta route, so the run goes
through the same wrappers as on the card.  ``WorkCounter`` records:
  * the products' operations by dtype, as ``torch.utils.flop_counter``'s
    formulas count them (mm, bmm, convolutions, ...), plus each kernel's
    ``cost``;
  * bytes: each aten op's operands and results, once each (views and other
    aliases 0, an in-place op's mutated operand once, allocations 0), plus
    each kernel's ``cost``;
  * the arguments' and the outputs' bytes, and the peak of live bytes
    (every storage from its creation until it is freed: autograd's saved
    tensors and remat's recompute decide a training step's peak).
``fits`` says whether the peak fits the card's memory (``mesh.hw()``); where
it does not, two runs (the memory is affine in the batch) give the largest
batch that fits.

On a mesh (``--mesh pod``: the reference's 16x16 production mesh of H100s,
``--multi-pod`` its 2x16x16) the step runs as DTensors on ``meta`` over a
``fake`` process group: parameters, optimizer state, caches and inputs
placed by a rule set of ``distributed/sharding.py`` (``--rules``; ``train``
or ``serve`` by mode), the residual stream laid out by
``sharding.constrain``, every kernel on its local shards.  The counter then
counts per device: DTensor's own ops are passed through (``NotImplemented``)
so that only the local ops and the collectives DTensor emits are seen, and
the ops of its sharding propagation (run on global shapes, under a
``FakeTensorMode`` or through a decomposition, and cached per op signature)
are not counted.  Collective bytes are the
output sizes of each functional collective, by kind, with a count and a
split by mesh axis (the reference's ``collective_bytes``); the roofline's
collective term charges each axis at its link's rate (``mesh.link_bw``).
DTensor picks its own collectives, so they are the port's, not GSPMD's.

Usage (any host; no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-405b \
      --shape decode_32k --multi-pod --rules serve_v2
writes experiments/dryrun_torch/<arch>_<shape>_h100[_pod1|_pod2][_<rules>].json.
"""
from __future__ import annotations

import argparse
import collections
import json
import math
import multiprocessing
import os
import threading
import time
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed import sharding
from repro_torch.kernels._common import counting_costs
from repro_torch.launch import mesh
from repro_torch.launch.mesh import hw
from repro_torch.models.model import (INPUT_SHAPES, InputShape, build_model, decode_token_specs,
                                      input_specs, shape_applicable)
from repro_torch.models.params import abstract_dtensor, abstract_params, distribute_abstract
from repro_torch.training.optimizer import OptimizerConfig, abstract_opt_state
from repro_torch.training.train_step import build_train_step

# Ops that allocate without writing: they move no bytes.
_ALLOCATIONS = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
                "empty_permuted"}


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


# The functional collectives DTensor emits (``torch.ops._c10d_functional``),
# under the reference's kind names.
COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    "permute_tensor": "collective-permute",
}
KINDS = tuple(dict.fromkeys(COLLECTIVES.values()))


def _tensors(tree) -> list:
    """The tensors in nested tuples, lists and dicts; a DTensor's local
    tensor for a DTensor (one device's share)."""
    if isinstance(tree, DTensor):
        return [tree._local_tensor]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _bytes(t: torch.Tensor) -> int:
    """The bytes of the distinct elements ``t`` addresses (a broadcast axis
    of stride 0 counts once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


_propagation = threading.local()
_PROPAGATOR_ENTRIES = ("propagate", "propagate_op_sharding", "propagate_op_sharding_non_cached")


def _hook_propagator() -> None:
    """Mark every call into DTensor's sharding propagator (its entries on
    the dispatcher's one ``ShardingPropagator``, wrapped once per process):
    it runs ops on global-shape meta or fake tensors (the output metadata,
    and strategies found through decompositions), cached per op signature,
    that no device runs."""
    prop = DTensor._op_dispatcher.sharding_propagator
    if getattr(prop, "_counted_by_dryrun", False):
        return
    entries = [name for name in _PROPAGATOR_ENTRIES if hasattr(prop, name)]
    if not entries:
        raise RuntimeError("DTensor's sharding propagator has none of "
                           f"{_PROPAGATOR_ENTRIES}: the counter cannot tell its ops apart")
    for name in entries:
        setattr(prop, name, _marked(getattr(prop, name)))
    prop._counted_by_dryrun = True


def _marked(fn):
    def run(*args, **kwargs):
        _propagation.depth = getattr(_propagation, "depth", 0) + 1
        try:
            return fn(*args, **kwargs)
        finally:
            _propagation.depth -= 1
    return run


def _in_propagation() -> bool:
    """Whether DTensor's sharding propagation is running the op: inside
    the propagator's entries, or under the ``FakeTensorMode`` it enters to
    run an op on global shapes (nothing else in a counted run enters one)."""
    return (getattr(_propagation, "depth", 0) > 0
            or torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None)


class WorkCounter(TorchDispatchMode):
    """Counts what a run on ``meta`` tensors computes, moves and holds, per
    device.

    ``flops`` maps a dtype to the operations of the products in that dtype,
    ``bytes`` is the bytes moved, ``kernels`` the kernel calls by name,
    ``live``/``peak`` the bytes of the storages alive now and at most
    (each storage keyed by identity and freed through a weak reference:
    every meta storage reports ``data_ptr() == 0``).  On DTensors only the
    local ops count (one device's work), and ``coll`` holds the collectives'
    output bytes by kind and mesh axis (``axis_names``: process-group name
    -> axis name)."""

    def __init__(self, axis_names: dict[str, str] | None = None):
        super().__init__()
        _hook_propagator()
        self.axis_names = axis_names or {}
        self.coll: dict[str, float] = dict.fromkeys(KINDS, 0)
        self.coll_count = 0
        self.coll_by_axis: dict[str, float] = collections.defaultdict(float)
        self.flops: dict[torch.dtype, float] = collections.defaultdict(float)
        self.bytes = 0
        self.kernels: dict[str, int] = collections.defaultdict(int)
        self.live = 0
        self.peak = 0
        self._held: dict[int, tuple] = {}   # storage key -> (bytes, weak reference)
        self._ops: dict = {}                # op -> (flop formula, moves bytes, mutable)
        self._lock = threading.RLock()

    # -- liveness ---------------------------------------------------------
    def _track(self, storage) -> int:
        """Count ``storage`` as live until it is freed; the bytes added."""
        key = storage._cdata
        with self._lock:
            if key in self._held:
                return 0
            n = storage.nbytes()
            self._held[key] = (n, weakref.ref(storage, lambda _, k=key: self._free(k)))
            self.live += n
            self.peak = max(self.peak, self.live)
        return n

    def _free(self, key: int) -> None:
        with self._lock:
            n, _ = self._held.pop(key, (0, None))
            self.live -= n

    def hold(self, tree) -> int:
        """Count the storages of ``tree``'s tensors as live (a run's
        arguments); returns their bytes."""
        return sum(self._track(t.untyped_storage()) for t in _tensors(tree))

    # -- work --------------------------------------------------------------
    def add_kernel(self, name: str, cost) -> None:
        """A kernel call on meta tensors (``kernels._common.count_meta_call``)."""
        for dtype, f in cost.flops.items():
            self.flops[dtype] += f
        self.bytes += cost.bytes
        self.kernels[name] += 1

    def _op(self, func) -> tuple:
        info = self._ops.get(func)
        if info is None:
            packet = func._overloadpacket
            info = (flop_registry.get(packet),
                    not func.is_view and packet.__name__ not in _ALLOCATIONS,
                    func._schema.is_mutable)
            self._ops[func] = info
        return info

    def _collective(self, func, args, kwargs, out) -> None:
        name = func._overloadpacket.__name__
        kind = COLLECTIVES.get(name)
        if kind is None or func.namespace not in ("_c10d_functional", "_c10d_functional_autograd"):
            return
        names = [a.name for a in func._schema.arguments]
        group = (args[names.index("group_name")] if names.index("group_name") < len(args)
                 else kwargs["group_name"])
        n = sum(_bytes(t) for t in _tensors(out))
        self.coll[kind] += n
        self.coll_count += 1
        self.coll_by_axis[self.axis_names.get(group, group)] += n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if DTensor in types:  # let DTensor run its local ops and collectives through us
            return NotImplemented
        out = func(*args, **kwargs)
        if _in_propagation():
            return out
        self._collective(func, args, kwargs, out)
        flop, moves, mutable = self._op(func)
        ins = _tensors((args, kwargs))
        if flop is not None:
            self.flops[ins[0].dtype] += flop(*args, **kwargs, out_val=out)
        ins = [(t, t.untyped_storage()) for t in ins if t.device.type == "meta"]
        outs = [(t, t.untyped_storage()) for t in _tensors(out) if t.device.type == "meta"]
        if moves:
            in_keys = {st._cdata for _, st in ins}
            fresh = [t for t, st in outs if st._cdata not in in_keys]
            # An op whose results all alias its operands without writing
            # them (``_unsafe_view``) moves nothing; an in-place op moves its
            # operands, the mutated one once.
            if fresh or not outs or mutable:
                self.bytes += sum(_bytes(t) for t, _ in ins) + sum(_bytes(t) for t in fresh)
        for _, st in outs:
            self._track(st)
        return out

    def work(self) -> dict:
        """``{"flops": {dtype: ...}, "bytes": ...}`` so far, and on a mesh
        ``"coll"`` (bytes by kind) and ``"coll_by_axis"``."""
        w = {"flops": dict(self.flops), "bytes": self.bytes}
        if self.coll_count:
            w["coll"] = dict(self.coll)
            w["coll_by_axis"] = dict(self.coll_by_axis)
        return w

    def collective_bytes(self) -> dict:
        """The reference's ``collective_bytes`` record: bytes by kind,
        ``count``, ``total``, and ``by_axis``."""
        return {**self.coll, "count": self.coll_count, "total": sum(self.coll.values()),
                "by_axis": dict(self.coll_by_axis)}


def axis_names(dmesh) -> dict[str, str]:
    """{process-group name: mesh axis name} of a ``DeviceMesh``."""
    if dmesh is None:
        return {}
    return {dmesh.get_group(i).group_name: name for i, name in enumerate(dmesh.mesh_dim_names)}


def count(fn, *args, dmesh=None) -> tuple[WorkCounter, object, int]:
    """Run ``fn(*args)`` on meta tensors under a ``WorkCounter``; returns
    (the counter, the result, the arguments' bytes).  With ``dmesh`` the
    collectives are split by its axes."""
    counter = WorkCounter(axis_names(dmesh))
    arg_bytes = counter.hold(args)
    with counting_costs(counter), counter:
        out = fn(*args)
    return counter, out, arg_bytes


def resolve_shape(shape) -> InputShape:
    return INPUT_SHAPES[shape] if isinstance(shape, str) else shape


def default_rules(shape: InputShape) -> str:
    return "train" if shape.mode == "train" else "serve"


def sharded(fn, dmesh, rules: dict):
    """``fn`` run with plain tensors taken as replicated and the residual
    stream laid out by ``rules`` (``sharding.activation_layout``)."""
    def run(*args):
        with implicit_replication(), sharding.activation_layout(dmesh, rules):
            return fn(*args)
    return run


def place_inputs(specs: dict, dmesh, rules: dict) -> dict:
    """``input_specs``' meta tensors as DTensors of ``sharding.batch_spec``."""
    return {k: abstract_dtensor(dmesh, pl, tuple(t.shape), t.dtype)
            for (k, t), pl in zip(specs.items(),
                                  sharding.batch_shardings(dmesh, specs, rules).values())}


def step_and_args(cfg, shape: InputShape, batch: int | None = None, pos: int | None = None,
                  dmesh=None, rules: dict | None = None):
    """(fn, args) of the step ``shape.mode`` dictates, on meta, at
    ``batch`` rows (the shape's own by default); a decode step at ``pos``
    (by default ``seq_len - 1``: a full cache).  With a ``DeviceMesh`` the
    arguments are DTensors placed by ``rules`` and ``fn`` runs ``sharded``."""
    if batch is not None:
        shape = InputShape(shape.name, shape.seq_len, batch, shape.mode)
    api = build_model(cfg)
    if dmesh is None:
        params = api.abstract()
        place = lambda specs: specs  # noqa: E731
        abstract = abstract_params
    else:
        params = distribute_abstract(api.param_decls, dmesh, rules)
        place = lambda specs: place_inputs(specs, dmesh, rules)  # noqa: E731
        abstract = lambda decls: distribute_abstract(decls, dmesh, rules)  # noqa: E731
    if shape.mode == "train":
        fn = build_train_step(api, OptimizerConfig())
        args = (params, abstract_opt_state(params), place(input_specs(cfg, shape)))
    elif shape.mode == "prefill":
        fn = lambda p, b: api.prefill(p, b, shape.seq_len)  # noqa: E731
        args = (params, place(input_specs(cfg, shape)))
    else:
        caches = abstract(api.cache_decls(shape.global_batch, shape.seq_len))
        token, full = decode_token_specs(shape)
        pos = full if pos is None else pos
        fn = lambda p, c, t: api.decode_step(p, c, t, pos, shape.seq_len)  # noqa: E731
        args = (params, caches, place({"t": token})["t"])
    return (fn if dmesh is None else sharded(fn, dmesh, rules)), args


def measure(cfg, shape: InputShape, batch: int | None = None, dmesh=None,
            rules: dict | None = None) -> dict:
    """One whole step on meta: its work, argument, output and peak bytes,
    per device of ``dmesh`` where given (and then its collectives)."""
    fn, args = step_and_args(cfg, shape, batch, dmesh=dmesh, rules=rules)
    counter, out, arg_bytes = count(fn, *args, dmesh=dmesh)
    outs = {t.untyped_storage()._cdata: t.untyped_storage().nbytes() for t in _tensors(out)}
    m = {"work": counter.work(), "kernels": dict(counter.kernels), "argument_bytes": arg_bytes,
         "output_bytes": sum(outs.values()), "peak_bytes": counter.peak}
    if dmesh is not None:
        m["collective_bytes"] = counter.collective_bytes()
    return m


def second_batch(batch: int) -> int:
    """The other batch the largest batch is read from."""
    return batch // 2 if batch > 1 else 2


def largest_batch(b1: int, peak1: int, b2: int, peak2: int, hbm: int) -> int:
    """The largest batch whose peak fits ``hbm``, from the peaks at two
    batches (the memory is affine in the batch)."""
    slope = (peak1 - peak2) / (b1 - b2)
    base = peak1 - slope * b1
    if slope <= 0:
        return b1 if peak1 <= hbm else 0
    return max(0, math.floor((hbm - base) / slope))


def result(arch: str, shape: InputShape, m: dict, m2: dict | None, card: dict, wall_s: float,
           desc: "mesh.MeshDesc | None" = None, rules: str | None = None) -> dict:
    """A pair's record from its step measured at the shape's batch (``m``)
    and at ``second_batch`` (``m2``); on a mesh (``desc``) from ``m`` alone,
    with no largest batch (a batch that the batch axes do not divide is
    replicated, so the peak is not affine in it)."""
    cfg = get_config(arch)
    w = m["work"]
    coll = m.get("collective_bytes")
    terms = mesh.roofline_terms(w["flops"], w["bytes"], card,
                                coll and coll["by_axis"], desc)
    per_device = {
        "flops": sum(w["flops"].values()),
        "flops_by_dtype": {dtype_name(dt): f for dt, f in w["flops"].items()},
        "bytes_accessed": w["bytes"],
        "kernel_calls": m["kernels"],
        "argument_bytes": m["argument_bytes"],
        "output_bytes": m["output_bytes"],
        "peak_bytes": m["peak_bytes"],
    }
    out = {
        "arch": arch, "shape": shape.name, "mode": shape.mode, "batch": shape.global_batch,
        "seq_len": shape.seq_len, "device": "meta", "hw": card["name"],
        "chips": 1 if desc is None else desc.size,
        "per_device": per_device,
        "hbm_bytes": card["hbm_bytes"], "fits": m["peak_bytes"] <= card["hbm_bytes"],
        "max_batch": None if m2 is None else largest_batch(
            shape.global_batch, m["peak_bytes"], second_batch(shape.global_batch),
            m2["peak_bytes"], card["hbm_bytes"]),
        "roofline_s": terms, "bottleneck": max(terms, key=terms.get),
        "model_params": cfg.param_count, "active_params": cfg.active_param_count,
        "wall_s": round(wall_s, 2),
    }
    if desc is not None:
        per_device["collective_bytes"] = coll
        out["mesh"], out["rules"] = desc.shape, rules
    return out


def _skipped(arch: str, shape: InputShape) -> dict | None:
    ok, why = shape_applicable(get_config(arch), shape)
    return None if ok else {"arch": arch, "shape": shape.name, "skipped": why}


def mesh_of(mesh_name: str | None, multi_pod: bool = False) -> "mesh.MeshDesc | None":
    """The mesh a run names: ``None``/``"card"`` one card (no mesh),
    ``"pod"`` the production mesh (2x16x16 with ``multi_pod``)."""
    if mesh_name in (None, "card") and not multi_pod:
        return None
    if mesh_name not in (None, "card", "pod"):
        raise ValueError(f"mesh {mesh_name!r}; expected card or pod")
    if mesh_name == "card":
        raise ValueError("--multi-pod names the 2x16x16 mesh, not one card")
    return mesh.make_production_mesh(multi_pod=multi_pod)


def run_one(arch: str, shape, *, card: dict | None = None, mesh: str | None = None,
            multi_pod: bool = False, rules: str | None = None) -> dict:
    """The dry-run of one pair: on one card, or on the production mesh
    (``mesh="pod"``, ``multi_pod``) under ``rules`` (``train``/``serve`` by
    mode), as the reference's ``run_one``."""
    shape = resolve_shape(shape)
    skipped = _skipped(arch, shape)
    if skipped:
        return skipped
    desc = mesh_of(mesh, multi_pod)
    cfg = get_config(arch)
    t0 = time.time()
    card = card or hw()
    if desc is None:
        m = measure(cfg, shape)
        m2 = measure(cfg, shape, second_batch(shape.global_batch))
        return result(arch, shape, m, m2, card, time.time() - t0)
    rules = rules or default_rules(shape)
    m = measure_arch(arch, shape, None, desc, rules)
    return result(arch, shape, m, None, card, time.time() - t0, desc, rules)


def measure_arch(arch: str, shape, batch: int | None = None, desc=None,
                 rules: str | None = None) -> dict:
    """``measure`` of ``arch``'s whole config at ``shape``, and its seconds;
    on ``desc``'s mesh over a fake process group under ``rules``."""
    t0 = time.time()
    shape = resolve_shape(shape)
    dmesh = None if desc is None else mesh.device_mesh(desc, "fake")
    rule_set = None if desc is None else sharding.RULE_SETS[rules or default_rules(shape)]
    return {**measure(get_config(arch), shape, batch, dmesh, rule_set),
            "wall_s": time.time() - t0}


def _call(fn, args, kwargs):
    try:
        return fn(*args, **kwargs)
    except Exception as e:  # a failure here is a fault of the port on meta
        return {"error": repr(e)[:2000]}


def _expected_cost(call) -> tuple:
    """Longest first: training steps, then the deeper models."""
    _, args, _ = call
    cfg, shape = get_config(args[0]), resolve_shape(args[1])
    return shape.mode == "train", cfg.num_layers + cfg.encoder_layers


def run_all(pairs, card: dict, workers: int = 1, also=(), desc=None,
            rules: str | None = None) -> tuple[list, list]:
    """The dry-run of every (arch, shape) pair, and the results of the
    calls ``also`` [(fn, (arch, shape, ...), kwargs)], in ``workers``
    spawned processes (meta runs are host-bound): a pair's two measurements
    are two calls (one on a mesh ``desc``, under ``rules`` or the mode's
    default), the longest calls go first.  A call that raises gives
    ``{"error": ...}``, and a pair with such a call ``{"arch", "shape",
    "error"}``."""
    pairs = [(arch, resolve_shape(shape)) for arch, shape in pairs]
    live = [(arch, shape) for arch, shape in pairs if not _skipped(arch, shape)]
    if desc is None:
        per = 2
        calls = [(measure_arch, (arch, shape, batch), {}) for arch, shape in live
                 for batch in (shape.global_batch, second_batch(shape.global_batch))]
    else:
        per = 1
        calls = [(measure_arch, (arch, shape, None, desc, rules), {}) for arch, shape in live]
    calls += list(also)
    order = sorted(range(len(calls)), key=lambda i: _expected_cost(calls[i]), reverse=True)
    if workers <= 1:
        done = {i: _call(*calls[i]) for i in order}
    else:
        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            done = dict(zip(order, pool.starmap(_call, [calls[i] for i in order], chunksize=1)))
    measured = {}
    for k, (arch, shape) in enumerate(live):
        ms = [done[per * k + j] for j in range(per)]
        bad = [x["error"] for x in ms if "error" in x]
        if bad:
            measured[arch, shape.name] = {"arch": arch, "shape": shape.name, "error": bad[0]}
        elif desc is None:
            measured[arch, shape.name] = result(arch, shape, ms[0], ms[1], card,
                                                ms[0]["wall_s"] + ms[1]["wall_s"])
        else:
            measured[arch, shape.name] = result(arch, shape, ms[0], None, card, ms[0]["wall_s"],
                                                desc, rules or default_rules(shape))
    out = [measured.get((arch, shape.name)) or _skipped(arch, shape) for arch, shape in pairs]
    return out, [done[i] for i in range(per * len(live), len(calls))]


def tag(arch: str, shape: str, desc=None, rules: str | None = None) -> str:
    """An artifact's file tag: ``<arch>_<shape>_h100``, on a mesh with
    ``_pod1``/``_pod2`` and, where given, ``_<rules>``."""
    t = f"{arch}_{shape}_{mesh.TAG}"
    if desc is not None:
        t += "_pod2" if "pod" in desc.shape else "_pod1"
        if rules:
            t += f"_{rules}"
    return t


def add_mesh_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--mesh", default="card", choices=("card", "pod"),
                    help="one card, or the reference's 16x16 production mesh of H100s")
    ap.add_argument("--multi-pod", action="store_true", help="the 2x16x16 mesh")
    ap.add_argument("--rules", default=None, choices=tuple(sharding.RULE_SETS),
                    help="a rule set of distributed/sharding.py (implies --mesh pod)")


def mesh_from_args(args) -> "mesh.MeshDesc | None":
    return mesh_of("pod" if args.rules or args.multi_pod else args.mesh, args.multi_pod)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--workers", type=int, default=1)
    add_mesh_args(ap)
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else (args.arch,)
    shapes = tuple(INPUT_SHAPES) if args.shape == "all" else (args.shape,)
    card = mesh.hw()
    desc = mesh_from_args(args)
    failed = 0
    results, _ = run_all([(a, s) for a in archs for s in shapes], card, args.workers,
                         desc=desc, rules=args.rules)
    os.makedirs(args.out, exist_ok=True)
    for res in results:
        name = tag(res["arch"], res["shape"], desc, args.rules)
        with open(os.path.join(args.out, name + ".json"), "w") as f:
            json.dump(res, f, indent=1)
        if "roofline_s" in res:
            r, d = res["roofline_s"], res["per_device"]
            line = (f"OK {name}: compute={r['compute']:.4f}s memory={r['memory']:.4f}s "
                    f"bottleneck={res['bottleneck']} peak={d['peak_bytes'] / 2**30:.2f}GiB "
                    f"fits={res['fits']} max_batch={res['max_batch']} ({res['wall_s']}s)")
            if desc is not None:
                line += (f" coll={r['collective']:.4f}s "
                         f"coll_bytes={d['collective_bytes']['total']:.4g} rules={res['rules']}")
            print(line)
        elif "skipped" in res:
            print(f"SKIP {name}: {res['skipped']}")
        else:
            print(f"FAIL {name}: {res['error'][:300]}")
            failed += 1
    if failed:
        raise SystemExit(f"{failed} pairs failed")


if __name__ == "__main__":
    main()
