"""Per-unit roofline accounting on one card (port of
``repro/launch/roofline.py``).

The reference compiles each repeated unit once and scales it by its trip
count, since XLA counts a scan body once.  The port counts each unit on
``meta`` tensors with the dry-run's ``WorkCounter`` (products by dtype, the
kernels' ``cost``, bytes) and scales it the same way:

  decoder models:  one superblock x (n_super + rem/len(pattern))  + head
  enc-dec models:  one encoder block x encoder_layers
                   + one decoder block x num_layers             + head
  train:           + the optimizer (AdamW over every parameter) x 1

A unit is the step's work at one more repeat of itself: a superblock is
the step at two superblocks less the step at one, the head is the step at
one superblock less that superblock (the embedding, the final norm, the
unembedding and the CE, with their backward for ``train``; what the step
does once around its blocks).  So the units add up to the step exactly
wherever the depth is whole superblocks; the hybrid's tail of ``rem``
blocks is scaled as ``rem/len(pattern)`` superblocks, as in the reference.
Each unit runs the step's own code: ``training.train_step.loss_and_grads``
for ``train`` (the optimizer apart, ``adamw_update``), ``api.prefill``,
``api.decode_step``.  A decode step's units hold no encoder pass (the
reference's count one at 4096 frames): the port's enc-dec decode step runs
the decoder over cached cross K/V only.

On a mesh (``--mesh pod``, ``--multi-pod``, ``--rules``: as the dry-run)
each unit runs under the step's own mesh and placements
(``dryrun.step_and_args``), and its collective bytes are scaled by the trip
count with the rest, as in the reference.

The terms: compute Σ flops of each dtype over the card's peak for that
dtype, memory bytes over its memory rate, collective each mesh axis's
collective bytes over its link's rate (0 on one card).

  PYTHONPATH=src python -m repro_torch.launch.roofline --arch all --shape all
  PYTHONPATH=src python -m repro_torch.launch.roofline --arch llama3-405b \
      --shape decode_32k --multi-pod --rules serve_v2
writes experiments/roofline_torch/<arch>_<shape>_h100[_pod1|_pod2][_<rules>].json.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun, mesh
from repro_torch.launch.mesh import device_mesh, hw, roofline_terms
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (INPUT_SHAPES, InputShape, build_model, input_specs,
                                      shape_applicable)
from repro_torch.models.params import distribute_abstract
from repro_torch.training.optimizer import OptimizerConfig, abstract_opt_state, adamw_update
from repro_torch.training.train_step import loss_and_grads


def _add(*scaled) -> dict:
    """Σ k·work over (work, k) pairs (collective bytes, where counted, by
    kind and by mesh axis too)."""
    flops, nbytes, coll, by_axis = {}, 0.0, {}, {}
    for w, k in scaled:
        for dt, f in w["flops"].items():
            flops[dt] = flops.get(dt, 0.0) + k * f
        nbytes += k * w["bytes"]
        for name, n in w.get("coll", {}).items():
            coll[name] = coll.get(name, 0.0) + k * n
        for axis, n in w.get("coll_by_axis", {}).items():
            by_axis[axis] = by_axis.get(axis, 0.0) + k * n
    out = {"flops": flops, "bytes": nbytes}
    if coll or by_axis:
        out["coll"], out["coll_by_axis"] = coll, by_axis
    return out


def _step_work(cfg: ModelConfig, shape: InputShape, pos: int | None, dmesh=None,
               rules: dict | None = None) -> dict:
    """The work of the step ``shape.mode`` dictates at ``cfg``'s depth; for
    ``train`` without the optimizer."""
    if shape.mode == "train":
        api = build_model(cfg)
        fn = lambda p, b: loss_and_grads(api, p, b)  # noqa: E731
        if dmesh is None:
            args = (api.abstract(), input_specs(cfg, shape))
        else:
            fn = dryrun.sharded(fn, dmesh, rules)
            args = (distribute_abstract(api.param_decls, dmesh, rules),
                    dryrun.place_inputs(input_specs(cfg, shape), dmesh, rules))
    else:
        fn, args = dryrun.step_and_args(cfg, shape, pos=pos, dmesh=dmesh, rules=rules)
    return dryrun.count(fn, *args, dmesh=dmesh)[0].work()


def _opt_work(cfg: ModelConfig, dmesh=None, rules: dict | None = None) -> dict:
    api = build_model(cfg)
    fn = lambda g, s, p: adamw_update(g, s, p, OptimizerConfig())  # noqa: E731
    if dmesh is None:
        params, grads = api.abstract(), api.abstract()
    else:
        fn = dryrun.sharded(fn, dmesh, rules)
        params, grads = (distribute_abstract(api.param_decls, dmesh, rules) for _ in range(2))
    return dryrun.count(fn, grads, abstract_opt_state(params), params, dmesh=dmesh)[0].work()


def units(cfg: ModelConfig, shape: InputShape, pos: int | None = None, dmesh=None,
          rules: dict | None = None) -> dict:
    """{name: (unit work, trip count)} of one step (on ``dmesh`` under
    ``rules`` where given)."""
    if cfg.arch_type == "encdec":
        at = lambda e, d: _step_work(  # noqa: E731
            dataclasses.replace(cfg, encoder_layers=e, num_layers=d), shape, pos, dmesh, rules)
        c11, c21, c12 = at(1, 1), at(2, 1), at(1, 2)
        enc, dec = _add((c21, 1), (c11, -1)), _add((c12, 1), (c11, -1))
        out = {"enc_block": (enc, cfg.encoder_layers), "dec_block": (dec, cfg.num_layers),
               "head": (_add((c11, 1), (enc, -1), (dec, -1)), 1)}
    else:
        p = len(transformer.block_pattern(cfg))
        n_super, rem = transformer.super_counts(cfg)
        at = lambda n: _step_work(  # noqa: E731
            dataclasses.replace(cfg, num_layers=n * p), shape, pos, dmesh, rules)
        c1, c2 = at(1), at(2)
        block = _add((c2, 1), (c1, -1))
        out = {"block": (block, n_super + rem / p), "head": (_add((c1, 1), (block, -1)), 1)}
    if shape.mode == "train":
        out["opt"] = (_opt_work(cfg, dmesh, rules), 1)
    return out


def _json_work(w: dict) -> dict:
    by_dtype = {dryrun.dtype_name(dt): f for dt, f in w["flops"].items()}
    out = {"flops": sum(by_dtype.values()), "flops_by_dtype": by_dtype, "bytes": w["bytes"],
           "coll": sum(w.get("coll", {}).values()) + 0.0}
    if "coll" in w:
        out["coll_by_kind"], out["coll_by_axis"] = w["coll"], w["coll_by_axis"]
    return out


def run_one(arch: str, shape, *, card: dict | None = None, num_layers: int | None = None,
            pos: int | None = None, mesh: str | None = None, multi_pod: bool = False,
            rules: str | None = None) -> dict:
    """The roofline of one (arch, shape) pair.  ``shape`` is a name of
    ``INPUT_SHAPES`` or an ``InputShape``; ``num_layers`` cuts the depth (as
    the fleet cuts mixtral-8x7b); ``pos`` is a decode step's position
    (``seq_len - 1``, a full cache, by default); ``mesh="pod"`` and
    ``multi_pod`` put it on a production mesh under ``rules``
    (``dryrun.run_one``'s)."""
    cfg = get_config(arch)
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    shape = dryrun.resolve_shape(shape)
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape.name, "skipped": why}
    desc = dryrun.mesh_of(mesh, multi_pod)
    card = card or hw()
    t0 = time.time()
    dmesh, rule_set = None, None
    if desc is not None:
        rules = rules or dryrun.default_rules(shape)
        dmesh, rule_set = device_mesh(desc, "fake"), sharding.RULE_SETS[rules]
    parts = units(cfg, shape, pos, dmesh, rule_set)
    total = _add(*parts.values())
    b, s = shape.global_batch, shape.seq_len
    tokens = b * (1 if shape.mode == "decode" else s)
    model_flops = (6 if shape.mode == "train" else 2) * cfg.active_param_count * tokens
    flops = sum(total["flops"].values())
    chips = 1 if desc is None else desc.size
    terms = roofline_terms(total["flops"], total["bytes"], card, total.get("coll_by_axis"),
                           desc)
    out = {
        "arch": arch, "shape": shape.name, "mode": shape.mode, "batch": b, "seq_len": s,
        "num_layers": cfg.num_layers, "hw": card["name"], "chips": chips,
        "per_device": _json_work(total),
        "parts": {name: {"unit": _json_work(w), "mult": k} for name, (w, k) in parts.items()},
        "roofline_s": terms,
        "bottleneck": max(terms, key=terms.get),
        "model_flops_global": model_flops,
        "useful_flops_ratio": model_flops / max(flops * chips, 1.0),
        "wall_s": round(time.time() - t0, 2),
    }
    if desc is not None:
        out["mesh"], out["rules"] = desc.shape, rules
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--out", default="experiments/roofline_torch")
    ap.add_argument("--workers", type=int, default=1)
    dryrun.add_mesh_args(ap)
    args = ap.parse_args(argv)
    archs = ARCH_IDS if args.arch == "all" else (args.arch,)
    shapes = tuple(INPUT_SHAPES) if args.shape == "all" else (args.shape,)
    card = mesh.hw()
    desc = dryrun.mesh_from_args(args)
    kwargs = {"card": card}
    if desc is not None:
        kwargs.update(mesh="pod", multi_pod=args.multi_pod, rules=args.rules)
    failed = 0
    pairs = [(a, s) for a in archs for s in shapes]
    _, results = dryrun.run_all([], card, args.workers,
                                also=[(run_one, pair, kwargs) for pair in pairs])
    os.makedirs(args.out, exist_ok=True)
    for (arch, shape), res in zip(pairs, results):
        res = {"arch": arch, "shape": shape, **res}
        tag = dryrun.tag(res["arch"], res["shape"], desc, args.rules)
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(res, f, indent=1)
        if "roofline_s" in res:
            r = res["roofline_s"]
            print(f"OK {tag}: compute={r['compute']:.4f} memory={r['memory']:.4f} "
                  f"coll={r['collective']:.4f} bn={res['bottleneck']} "
                  f"useful={res['useful_flops_ratio']:.3f}")
        elif "skipped" in res:
            print(f"SKIP {tag}")
        else:
            print(f"FAIL {tag}: {res['error'][:300]}")
            failed += 1
    if failed:
        raise SystemExit(f"{failed} pairs failed")


if __name__ == "__main__":
    main()
