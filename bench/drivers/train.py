"""The training driver: ``build_train_step`` over one model, timed over
whole steps dispatched back to back.

Set-up draws the weights and a pool of token batches on the card from the
seed, builds the step, and drives it through ``warmup_steps`` steps (the
first compiles); the reference follows the first ``check.steps`` of them.
Then one synchronise, and the window: steps enqueued back to back on
inputs already on the card, nothing read back, the host clock read after
each enqueue; at the first reading past ``--seconds`` one synchronise
closes it.  ``train_tokens_per_s`` is the tokens of exactly the steps
enqueued over the time to that synchronise.
"""
from __future__ import annotations

import gc
import math
import statistics
import time

import torch

from bench import harness, weights
from bench.reference import mamba2 as ref

MODEL_FIELDS = ("num_layers", "d_model", "vocab_size", "ssm_state_dim", "ssm_head_dim",
                "ssm_expand", "ssm_conv_width", "ssm_chunk_size", "norm_eps", "remat")


def program_config(name: str):
    """The program's configuration of model ``name``."""
    from repro_torch.configs import get_config

    return get_config(name)


def _program(name: str, m: dict, o: dict):
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.train_step import build_train_step

    cfg = program_config(name)
    for f in MODEL_FIELDS:
        if getattr(cfg, f) != m[f]:
            raise ValueError(f"{name}: {f} is {getattr(cfg, f)} in the program, {m[f]} in the "
                             "configuration file")
    api = build_model(cfg)
    opt = OptimizerConfig(lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                          weight_decay=o["weight_decay"], grad_clip=o["grad_clip"],
                          warmup_steps=o["warmup_steps"], total_steps=o["total_steps"],
                          min_lr_frac=o["min_lr_frac"])
    return api, build_train_step(api, opt)


def leaf_paths(tree, prefix="") -> list[str]:
    """Leaf paths of a nested dict/list tree in its own (insertion) order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in leaf_paths(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in leaf_paths(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def check_layout(params: dict, decls: dict) -> None:
    """The benchmark's layout against the program's declarations."""
    from repro_torch.models.params import tree_leaves

    got = dict(zip(leaf_paths(params), (tuple(t.shape) for t in tree_leaves(params))))
    want = dict(zip(leaf_paths(decls), (tuple(d.shape) for d in tree_leaves(decls))))
    if got != want:
        diff = sorted(set(got.items()) ^ set(want.items()))[:6]
        raise ValueError(f"the weights' layout differs from the program's: {diff}")


def token_pool(seed: int, name: str, vocab: int, n: int, batch: int, seq: int, device):
    """``n`` batches of token ids drawn on the card: rows of seq + 1 ids, the
    tokens and their next-token labels."""
    gen = torch.Generator(device=device).manual_seed(weights.group_seed(seed, name, "tokens"))
    ids = torch.randint(0, vocab, (n, batch, seq + 1), generator=gen, device=device)
    return ids[..., :-1], ids[..., 1:]


def run(ctx) -> dict:
    cfg_file, traffic, device = ctx.config, ctx.traffic, ctx.device
    (name, m), = cfg_file["models"].items()
    o = cfg_file["optimizer"]
    batch, seq = traffic["batch"], traffic["seq_len"]
    n_check = traffic["check"]["steps"]
    warm = traffic["warmup_steps"]
    if warm < n_check:
        raise ValueError("the warm-up must cover the steps the reference follows")

    api, step_fn = _program(name, m, o)
    step_fn = ctx.wrap_step(step_fn)
    ctx.mark("program")
    params = ctx.wrap_params(weights.make_model(ctx.seed, name, m, device))
    check_layout(params, api.param_decls)
    ctx.mark("weights")
    from repro_torch.models.params import tree_leaves
    from repro_torch.training.optimizer import init_opt_state

    paths = leaf_paths(params)
    p0 = [t.detach().clone() for t in tree_leaves(params)]
    opt_state = init_opt_state(params)
    tokens, labels = token_pool(ctx.seed, name, m["vocab_size"], traffic["pool_batches"],
                                batch, seq, device)
    feed = lambda i: {"tokens": tokens[i % len(tokens)], "labels": labels[i % len(labels)]}  # noqa: E731
    ctx.mark("tokens")

    losses, first_m, p_check = [], None, None
    for i in range(warm):
        params, opt_state, met = step_fn(params, opt_state, feed(i))
        losses.append(met["loss"])
        if i == 0:   # m after one step is (1 - b1) times the clipped gradient
            first_m = [mm.detach().clone() for mm in tree_leaves(opt_state["m"])]
        if i == n_check - 1:
            p_check = [t.detach().clone() for t in tree_leaves(params)]
        ctx.mark(f"step{i + 1}")
    gc.collect()
    gc.freeze()
    ctx.clock("open")
    ctx.mark("clock")
    t_open = time.perf_counter()
    setup_s = t_open - ctx.t_start

    out = {"record": None, "e2e": {"setup_s": setup_s}}
    window_loss = []
    if not ctx.trace:
        i, n = warm, 0
        while True:
            params, opt_state, met = step_fn(params, opt_state, feed(i))
            window_loss.append(met["loss"])
            i += 1
            n += 1
            if time.perf_counter() - t_open >= ctx.seconds:
                break
        ctx.sync()
        t_close = time.perf_counter()
        out["e2e"]["train_tokens_per_s"] = n * batch * seq / (t_close - t_open)
        out["side"] = {"steps": n, "window_s": t_close - t_open}
    else:
        # The step time on the host clock first, then the same number of
        # steps under the profiler, whose own cost would swell it.
        k = traffic["trace_steps"]
        t0 = time.perf_counter()
        for j in range(k):
            params, opt_state, met = step_fn(params, opt_state, feed(warm + j))
            window_loss.append(met["loss"])
        ctx.sync()
        t1 = time.perf_counter()
        with ctx.profile() as prof:
            with torch.profiler.record_function("bench.window"):
                for j in range(k, 2 * k):
                    with torch.profiler.record_function("bench.step"):
                        params, opt_state, met = step_fn(params, opt_state, feed(warm + j))
                        window_loss.append(met["loss"])
                ctx.sync()
        n = 2 * k
        data = {"steps": k, "step_s": (t1 - t0) / k, "model": m, "batch": batch, "seq": seq,
                "n_params": weights.param_count(m)}
        out["record"] = harness.reduce_trace(prof, "bench.window", data)
        out["side"] = {"steps": n, "step_s": data["step_s"]}
    ctx.clock("close")
    gc.unfreeze()
    out["side"]["stages"] = dict(ctx.stages)
    out["memory_peak_bytes"] = ctx.memory_peak()
    prog_loss = [float(x) for x in losses[:n_check]]
    prog_grad = {p: g / (1 - o["b1"]) for p, g in zip(paths, first_m)}
    prog_change = dict(zip(paths, zip(p_check, p0)))
    failed = sum(1 for x in window_loss if not math.isfinite(float(x)))
    del params, opt_state, step_fn, api, met, losses, window_loss, first_m, p_check, p0
    gc.collect()
    ctx.free()

    feed_ref = [(tokens[i], labels[i]) for i in range(n_check)]
    t_ref = time.perf_counter()
    if ctx.control:  # the reference in float8 in the program's place
        c = ref.train(ctx.seed, name, m, o, feed_ref, device, fp8=True, keep=True)
        prog_loss, prog_grad, changes = c["loss"], c["first"], c["changes"]
        del c
        change_of = changes.__getitem__
    else:
        def change_of(k):
            a, b = prog_change[k]
            return a.float() - b.float()
    prog = {"loss": prog_loss,
            "first_grad": {k: float(g.double().norm()) for k, g in prog_grad.items()},
            "change": {k: float(change_of(k).double().norm()) for k in prog_grad}}
    r = ref.train(ctx.seed, name, m, o, feed_ref, device, against=prog_grad,
                  against_change=change_of)
    del prog_grad, prog_change, change_of
    out.update(judge(r, prog, ctx.limits))
    out["detail"]["reference_s"] = time.perf_counter() - t_ref
    out["attempted"] = n
    out["failed"] = failed
    return out


def _kind(name: str) -> str:
    """A leaf's kind: its name after the layer (``ssm.w_in``), or its name."""
    return name.split(".", 2)[-1] if name.startswith("blocks.") else name


def _over(values: list[float], norms: list[float]) -> list[float]:
    """Each leaf's value over max(the reference's norm of that leaf, the
    median leaf's); the median is taken over the leaves that the
    reference's norm finds above zero.  A leaf whose both are zero reads
    0 where its value is 0, else infinity."""
    pos = [x for x in norms if x > 0]
    med = statistics.median(pos) if pos else 0.0
    return [v / max(w, med) if max(w, med) > 0 else (0.0 if v == 0 else math.inf)
            for v, w in zip(values, norms)]


def readings(r: dict, prog: dict) -> tuple[dict, dict]:
    """The numbers a run can be judged by, and what else is kept beside
    them.  ``prog`` holds the program's loss a step and its norms per leaf
    of the first clipped gradient (AdamW's m after one step over 1 - b1)
    and of the parameter change after the steps the reference followed.
    Each leaf's number is taken over the reference's norm of that leaf or
    the median leaf's, whichever is larger (``_over``):

    * ``loss_gap``: the largest relative gap of the loss over those steps;
    * ``grad_gap``, ``change_gap``: the worst leaf's gap between the
      program's norm and the reference's, of the first gradient and of the
      change;
    * ``grad_diff``: the median leaf's norm of the difference between the
      program's first gradient and the reference's, the backward through
      the whole stack; ``grad_diff_worst``: the worst leaf's;
      ``grad_diff_part``: the same difference taken per part of a leaf
      (the in-projection's columns z, x, B, C, dt and the conv's channels
      x, B, C, which the SSD backward's dx, dB, dC and ddt reach apart;
      other leaves whole) over the part's own norm, then the largest over
      the kinds of part (``ssm.w_in[B]``, ``ssm.D``, ..., the head) of
      each kind's median over the layers: a gradient wrong in one part of
      every layer.  A part is taken over its own norm, not the median
      leaf's, because the B, C and dt parts and the per-head leaves are
      small beside the median leaf, which would hide a part gone wrong;
      parts under a thousandth of the median leaf's norm are left out;
    * ``change_diff``: the worst leaf's norm of the difference between the
      two changes, AdamW's update as applied.

    Leaves whose first gradient the reference finds under a thousandth of
    the median leaf's move by round-off alone: they are left out of the
    change (``left_out``)."""
    names = r["names"]
    med_raw = statistics.median(r["raw_grad"])
    moving = [i for i, x in enumerate(r["raw_grad"]) if x >= 1e-3 * med_raw]
    g_gap = _over([abs(prog["first_grad"][k] - w) for k, w in zip(names, r["first_grad"])],
                  r["first_grad"])
    diff = _over(r["first_diff"], r["first_grad"])
    pos = [x for x in r["first_grad"] if x > 0]
    med_leaf = statistics.median(pos) if pos else 0.0
    part = [(d / g if g >= 1e-3 * med_leaf else None, n)
            for d, g, n in zip(r["part_diff"], r["part_grad"], r["part_names"])]
    want_c = [r["change"][i] for i in moving]
    c_gap = _over([abs(prog["change"][names[i]] - r["change"][i]) for i in moving], want_c)
    c_diff = _over([r["change_diff"][i] for i in moving], want_c)
    by_kind: dict[str, list[float]] = {}
    for d, n in part:
        if d is not None:
            by_kind.setdefault(_kind(n), []).append(d)
    kind_med = {k: statistics.median(v) for k, v in by_kind.items()}
    size: dict[str, list[float]] = {}
    for g, n in zip(r["part_grad"], r["part_names"]):
        size.setdefault(_kind(n), []).append(g / med_leaf if med_leaf else math.inf)
    values = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], r["loss"])),
              "grad_gap": max(g_gap), "change_gap": max(c_gap),
              "grad_diff": statistics.median(diff), "grad_diff_part": max(kind_med.values()),
              "grad_diff_worst": max(diff), "change_diff": max(c_diff)}

    def top(gaps, idx):
        return sorted(((g, names[i]) for g, i in zip(gaps, idx)), reverse=True)[:5]

    detail = {"loss_program": prog["loss"], "loss_reference": r["loss"],
              "grad_diff_by_part": kind_med,
              "part_norm_over_median_leaf": {k: statistics.median(v) for k, v in size.items()},
              "grad_gap_worst": top(g_gap, range(len(names))),
              "grad_diff_worst": top(diff, range(len(names))),
              "change_gap_worst": top(c_gap, moving), "change_diff_worst": top(c_diff, moving),
              "left_out": [names[i] for i in range(len(names)) if i not in moving],
              "parts_left_out": [n for d, n in part if d is None]}
    return values, detail


def judge(r: dict, prog: dict, limits: dict) -> dict:
    """The readings that the cell's limits file names, each beside its
    limit (PERF.md gives the readings each limit was set from)."""
    values, detail = readings(r, prog)
    checks = {k: [values[k], lim] for k, lim in limits.items()}
    detail["readings"] = values
    return {"checks": checks, "correct": all(v <= lim for v, lim in checks.values()),
            "detail": detail}
