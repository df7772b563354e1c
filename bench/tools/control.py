"""Read a cell's control and its planted faults on the card, at the cell's
own size, seed by seed, in one process.

  python3 bench/tools/control.py --workload <cell> --seeds 1,2,3 --mode control --seconds 5

``--mode program`` runs the program as the benchmark does (a short
window), for the sound readings of many seeds in one process; ``--mode
control`` puts the reference, computed in float8, in the program's place;
``--mode <fault>`` runs the program with one of the faults a cell's
comparison has to catch (``FAULTS``) planted in its timed path; ``--mode
float32`` runs the program on float32 parameters (its float32 kernels), a
witness of how near the program comes to the reference when rounding is
taken out.  Each seed prints every reading beside the limits, as one JSON
line.  The benchmark's own runs never do this.
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def _unchanged(step):
    def run(params, opt_state, batch):
        _, _, met = step(copy.deepcopy(params), copy.deepcopy(opt_state), batch)
        return params, opt_state, met
    return run


def _half_batch(step):
    def run(params, opt_state, batch):
        half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return step(params, opt_state, half)
    return run


def _update_reversed(step):
    """Each step's parameter update applied with its sign flipped."""
    from repro_torch.models.params import tree_leaves

    def run(params, opt_state, batch):
        old = [t.detach().clone() for t in tree_leaves(params)]
        params, opt_state, met = step(params, opt_state, batch)
        with torch.no_grad():
            for new, was in zip(tree_leaves(params), old):
                new.copy_(2 * was.float() - new.float())
        return params, opt_state, met
    return run


class _ScaleGrad(torch.autograd.Function):
    """The identity, whose backward scales the gradient by ``factor``."""

    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


def _ssd_grad(arg: str, factor: float):
    """A fault of the SSD scan's backward: its gradient to ``arg`` (``x``,
    ``dt``, ``Bm`` or ``Cm``) scaled by ``factor`` in every ssm block,
    remat's recompute included, as if the backward kernel wrote it so."""
    def wrap(step):
        from repro_torch.kernels.ssd import ops

        scan = ops.ssd

        def faulty(x, dt, A, Bm, Cm, D, h0=None, **kw):
            a = {"x": x, "dt": dt, "Bm": Bm, "Cm": Cm}
            a[arg] = _ScaleGrad.apply(a[arg], factor)
            return scan(a["x"], a["dt"], A, a["Bm"], a["Cm"], D, h0, **kw)

        def run(params, opt_state, batch):
            ops.ssd = faulty
            try:
                return step(params, opt_state, batch)
            finally:
                ops.ssd = scan
        return run
    return wrap


FAULTS = {
    "mamba2-370m.train-8x4096": {"state_unchanged": {"wrap_step": _unchanged},
                                 "half_batch": {"wrap_step": _half_batch},
                                 "update_reversed": {"wrap_step": _update_reversed},
                                 "ssd_dB_zero": {"wrap_step": _ssd_grad("Bm", 0.0)},
                                 "ssd_dC_zero": {"wrap_step": _ssd_grad("Cm", 0.0)},
                                 "ssd_ddt_zero": {"wrap_step": _ssd_grad("dt", 0.0)},
                                 "ssd_dx_half": {"wrap_step": _ssd_grad("x", 0.5)}},
}


def _float32(tree):
    from repro_torch.models.params import tree_map

    return tree_map(lambda t: t.float(), tree)


WITNESS = {"wrap_params": _float32}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)

    from bench.run import execute, make_context

    hooks = ({} if args.mode == "program" else {"control": True} if args.mode == "control"
             else WITNESS if args.mode == "float32" else FAULTS[args.workload][args.mode])
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = make_context(args.workload, seed, args.seconds, False, torch.device("cuda", 0),
                           **hooks)
        res = execute(ctx)
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                          "correct": res["correct"], "checks": res["checks"],
                          "detail": res["_side"].get("detail")}), flush=True)
        del res, ctx
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
