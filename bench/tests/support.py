"""The training cell cut to CPU size for the tests: the cell's own files
with the model replaced by the program's reduced configuration and the
traffic shortened, on the CPU."""
from __future__ import annotations

import copy
import dataclasses

import torch

from bench.drivers import train
from bench.run import make_context

CELL = "mamba2-370m.train-8x4096"
FIELDS = ("num_layers", "d_model", "vocab_size", "padded_vocab", "norm_eps", "ssm_state_dim",
          "ssm_head_dim", "ssm_expand", "ssm_conv_width", "ssm_chunk_size", "remat")


def reduced_model(name: str, m: dict) -> dict:
    from repro_torch.configs import get_config

    cfg = get_config(name, reduced=True)
    out = dict(m)
    for f in FIELDS:
        out[f] = getattr(cfg, f)
    return out


def reduced_context(monkeypatch, workload: str = CELL, seed: int = 7, trace: bool = False,
                    **hooks):
    from repro_torch.configs import get_config

    monkeypatch.setattr(train, "program_config", lambda name: get_config(name, reduced=True))
    ctx = make_context(workload, seed, 0.5, trace, torch.device("cpu"), **hooks)
    ctx.config = copy.deepcopy(ctx.config)
    ctx.config["models"] = {k: reduced_model(k, m) for k, m in ctx.config["models"].items()}
    t = copy.deepcopy(ctx.traffic)
    t.update(batch=2, seq_len=32, warmup_steps=3, pool_batches=6, trace_steps=2)
    return dataclasses.replace(ctx, traffic=t)
