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
batch that fits.  The reference's ``collective_bytes`` parses HLO of a mesh
and has no counterpart: one card has no collective.

Usage (any host; no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k
writes experiments/dryrun_torch/<arch>_<shape>_h100.json.
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
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels._common import counting_costs
from repro_torch.launch import mesh
from repro_torch.models.model import (INPUT_SHAPES, InputShape, build_model, decode_token_specs,
                                      input_specs, shape_applicable)
from repro_torch.models.params import abstract_params
from repro_torch.training.optimizer import OptimizerConfig, abstract_opt_state
from repro_torch.training.train_step import build_train_step

# Ops that allocate without writing: they move no bytes.
_ALLOCATIONS = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
                "empty_permuted"}


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _tensors(tree) -> list:
    """The tensors in nested tuples, lists and dicts."""
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


class WorkCounter(TorchDispatchMode):
    """Counts what a run on ``meta`` tensors computes, moves and holds.

    ``flops`` maps a dtype to the operations of the products in that dtype,
    ``bytes`` is the bytes moved, ``kernels`` the kernel calls by name,
    ``live``/``peak`` the bytes of the storages alive now and at most
    (each storage keyed by identity and freed through a weak reference:
    every meta storage reports ``data_ptr() == 0``)."""

    def __init__(self):
        super().__init__()
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

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
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
        """``{"flops": {dtype: ...}, "bytes": ...}`` so far."""
        return {"flops": dict(self.flops), "bytes": self.bytes}


def count(fn, *args) -> tuple[WorkCounter, object, int]:
    """Run ``fn(*args)`` on meta tensors under a ``WorkCounter``; returns
    (the counter, the result, the arguments' bytes)."""
    counter = WorkCounter()
    arg_bytes = counter.hold(args)
    with counting_costs(counter), counter:
        out = fn(*args)
    return counter, out, arg_bytes


def resolve_shape(shape) -> InputShape:
    return INPUT_SHAPES[shape] if isinstance(shape, str) else shape


def step_and_args(cfg, shape: InputShape, batch: int | None = None, pos: int | None = None):
    """(fn, args) of the step ``shape.mode`` dictates, on meta, at
    ``batch`` rows (the shape's own by default); a decode step at ``pos``
    (by default ``seq_len - 1``: a full cache)."""
    if batch is not None:
        shape = InputShape(shape.name, shape.seq_len, batch, shape.mode)
    api = build_model(cfg)
    params = api.abstract()
    if shape.mode == "train":
        step = build_train_step(api, OptimizerConfig())
        return step, (params, abstract_opt_state(params), input_specs(cfg, shape))
    if shape.mode == "prefill":
        return (lambda p, b: api.prefill(p, b, shape.seq_len)), (params, input_specs(cfg, shape))
    caches = abstract_params(api.cache_decls(shape.global_batch, shape.seq_len))
    token, full = decode_token_specs(shape)
    pos = full if pos is None else pos
    return (lambda p, c, t: api.decode_step(p, c, t, pos, shape.seq_len)), (params, caches, token)


def measure(cfg, shape: InputShape, batch: int | None = None) -> dict:
    """One whole step on meta: its work, argument, output and peak bytes."""
    fn, args = step_and_args(cfg, shape, batch)
    counter, out, arg_bytes = count(fn, *args)
    outs = {t.untyped_storage()._cdata: t.untyped_storage().nbytes() for t in _tensors(out)}
    return {"work": counter.work(), "kernels": dict(counter.kernels), "argument_bytes": arg_bytes,
            "output_bytes": sum(outs.values()), "peak_bytes": counter.peak}


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


def result(arch: str, shape: InputShape, m: dict, m2: dict, card: dict, wall_s: float) -> dict:
    """A pair's record from its step measured at the shape's batch (``m``)
    and at ``second_batch`` (``m2``)."""
    cfg = get_config(arch)
    w = m["work"]
    terms = mesh.roofline_terms(w["flops"], w["bytes"], card)
    b2 = second_batch(shape.global_batch)
    return {
        "arch": arch, "shape": shape.name, "mode": shape.mode, "batch": shape.global_batch,
        "seq_len": shape.seq_len, "device": "meta", "hw": card["name"], "chips": 1,
        "per_device": {
            "flops": sum(w["flops"].values()),
            "flops_by_dtype": {dtype_name(dt): f for dt, f in w["flops"].items()},
            "bytes_accessed": w["bytes"],
            "kernel_calls": m["kernels"],
            "argument_bytes": m["argument_bytes"],
            "output_bytes": m["output_bytes"],
            "peak_bytes": m["peak_bytes"],
        },
        "hbm_bytes": card["hbm_bytes"], "fits": m["peak_bytes"] <= card["hbm_bytes"],
        "max_batch": largest_batch(shape.global_batch, m["peak_bytes"], b2, m2["peak_bytes"],
                                   card["hbm_bytes"]),
        "roofline_s": terms, "bottleneck": max(terms, key=terms.get),
        "model_params": cfg.param_count, "active_params": cfg.active_param_count,
        "wall_s": round(wall_s, 2),
    }


def _skipped(arch: str, shape: InputShape) -> dict | None:
    ok, why = shape_applicable(get_config(arch), shape)
    return None if ok else {"arch": arch, "shape": shape.name, "skipped": why}


def run_one(arch: str, shape, *, card: dict | None = None) -> dict:
    shape = resolve_shape(shape)
    skipped = _skipped(arch, shape)
    if skipped:
        return skipped
    cfg = get_config(arch)
    t0 = time.time()
    m = measure(cfg, shape)
    m2 = measure(cfg, shape, second_batch(shape.global_batch))
    return result(arch, shape, m, m2, card or mesh.hw(), time.time() - t0)


def measure_arch(arch: str, shape, batch: int | None = None) -> dict:
    """``measure`` of ``arch``'s whole config at ``shape``, and its seconds."""
    t0 = time.time()
    shape = resolve_shape(shape)
    return {**measure(get_config(arch), shape, batch), "wall_s": time.time() - t0}


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


def run_all(pairs, card: dict, workers: int = 1, also=()) -> tuple[list, list]:
    """The dry-run of every (arch, shape) pair, and the results of the
    calls ``also`` [(fn, (arch, shape, ...), kwargs)], in ``workers``
    spawned processes (meta runs are host-bound): a pair's two measurements
    are two calls, the longest calls go first.  A call that raises gives
    ``{"error": ...}``, and a pair with such a call ``{"arch", "shape",
    "error"}``."""
    pairs = [(arch, resolve_shape(shape)) for arch, shape in pairs]
    live = [(arch, shape) for arch, shape in pairs if not _skipped(arch, shape)]
    calls = [(measure_arch, (arch, shape, batch), {}) for arch, shape in live
             for batch in (shape.global_batch, second_batch(shape.global_batch))]
    calls += list(also)
    order = sorted(range(len(calls)), key=lambda i: _expected_cost(calls[i]), reverse=True)
    if workers <= 1:
        done = {i: _call(*calls[i]) for i in order}
    else:
        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            done = dict(zip(order, pool.starmap(_call, [calls[i] for i in order], chunksize=1)))
    measured = {}
    for k, (arch, shape) in enumerate(live):
        m, m2 = done[2 * k], done[2 * k + 1]
        bad = [x["error"] for x in (m, m2) if "error" in x]
        measured[arch, shape.name] = (
            {"arch": arch, "shape": shape.name, "error": bad[0]} if bad else
            result(arch, shape, m, m2, card, m["wall_s"] + m2["wall_s"]))
    out = [measured.get((arch, shape.name)) or _skipped(arch, shape) for arch, shape in pairs]
    return out, [done[i] for i in range(2 * len(live), len(calls))]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--workers", type=int, default=1)
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else (args.arch,)
    shapes = tuple(INPUT_SHAPES) if args.shape == "all" else (args.shape,)
    card = mesh.hw()
    failed = 0
    results, _ = run_all([(a, s) for a in archs for s in shapes], card, args.workers)
    os.makedirs(args.out, exist_ok=True)
    for res in results:
        tag = f"{res['arch']}_{res['shape']}_{mesh.TAG}"
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(res, f, indent=1)
        if "roofline_s" in res:
            r, d = res["roofline_s"], res["per_device"]
            print(f"OK {tag}: compute={r['compute']:.4f}s memory={r['memory']:.4f}s "
                  f"bottleneck={res['bottleneck']} peak={d['peak_bytes'] / 2**30:.2f}GiB "
                  f"fits={res['fits']} max_batch={res['max_batch']} ({res['wall_s']}s)")
        elif "skipped" in res:
            print(f"SKIP {tag}: {res['skipped']}")
        else:
            print(f"FAIL {tag}: {res['error'][:300]}")
            failed += 1
    if failed:
        raise SystemExit(f"{failed} pairs failed")


if __name__ == "__main__":
    main()
