"""Model API (port of ``repro/models/model.py`` for the dense and ssm families).

``build_model(cfg)`` returns a ``ModelApi`` with the entry points the
serving engine uses.  The dense and ssm families are ported; the others
raise ``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import init_params

_NOT_PORTED = {
    "moe": "ROADMAP A5 (MoE and sliding windows)",
    "hybrid": "ROADMAP A7 (hybrid and enc-dec families)",
    "encdec": "ROADMAP A7 (hybrid and enc-dec families)",
}


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    param_decls: dict
    prefill: Callable       # (params, batch, max_len, impl=None) -> (logits, caches)
    decode_step: Callable   # (params, caches, token, pos, max_len, impl=None) -> (logits, caches)
    cache_decls: Callable   # (batch, max_len) -> decl tree

    def init(self, seed: int | torch.Generator = 0, dtype=torch.bfloat16, device="cuda"):
        """Random parameters from a seeded generator, on ``device``."""
        return init_params(self.param_decls, seed, dtype, device)


def build_model(cfg: ModelConfig) -> ModelApi:
    if cfg.arch_type in _NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.arch_type!r} family is not ported yet; "
            f"see {_NOT_PORTED[cfg.arch_type]}"
        )
    return ModelApi(
        cfg=cfg,
        param_decls=transformer.model_decls(cfg),
        prefill=lambda p, b, max_len, impl=None: transformer.prefill(p, b, cfg, max_len, impl),
        decode_step=lambda p, c, t, pos, max_len, impl=None: transformer.decode_step(
            p, c, t, pos, cfg, max_len, impl),
        cache_decls=lambda batch, max_len: transformer.cache_decls(cfg, batch, max_len),
    )
