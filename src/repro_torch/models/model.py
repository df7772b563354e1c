"""Model API (port of ``repro/models/model.py``).

``build_model(cfg)`` returns a ``ModelApi`` with the entry points the
trainer and the serving engine use: the enc-dec family through ``models/encdec.py``, every
other family (dense, MoE, ssm, hybrid) through ``models/transformer.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import encdec, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import init_params

# The encoder length of the enc-dec cache (the reference's _ENC_LEN_DECODE).
ENC_LEN_DECODE = 4_096


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    param_decls: dict
    train_loss: Callable    # (params, batch, impl=None) -> (loss, {"ce", "aux"})
    prefill: Callable       # (params, batch, max_len, impl=None) -> (logits, caches)
    decode_step: Callable   # (params, caches, token, pos, max_len, impl=None) -> (logits, caches)
    cache_decls: Callable   # (batch, max_len) -> decl tree

    def init(self, seed: int | torch.Generator = 0, dtype=torch.bfloat16, device="cuda"):
        """Random parameters from a seeded generator, on ``device``."""
        return init_params(self.param_decls, seed, dtype, device)


def build_model(cfg: ModelConfig) -> ModelApi:
    if cfg.arch_type == "encdec":
        return ModelApi(
            cfg=cfg,
            param_decls=encdec.model_decls(cfg),
            train_loss=lambda p, b, impl=None: encdec.forward_train(p, b, cfg, impl=impl),
            prefill=lambda p, b, max_len, impl=None: encdec.prefill(p, b, cfg, max_len, impl),
            decode_step=lambda p, c, t, pos, max_len, impl=None: encdec.decode_step(
                p, c, t, pos, cfg, max_len, impl),
            cache_decls=lambda batch, max_len: encdec.cache_decls(cfg, batch, max_len,
                                                                  ENC_LEN_DECODE),
        )
    return ModelApi(
        cfg=cfg,
        param_decls=transformer.model_decls(cfg),
        train_loss=lambda p, b, impl=None: transformer.forward_train(p, b, cfg, impl=impl),
        prefill=lambda p, b, max_len, impl=None: transformer.prefill(p, b, cfg, max_len, impl),
        decode_step=lambda p, c, t, pos, max_len, impl=None: transformer.decode_step(
            p, c, t, pos, cfg, max_len, impl),
        cache_decls=lambda batch, max_len: transformer.cache_decls(cfg, batch, max_len),
    )
