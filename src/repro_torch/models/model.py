"""Model API and input shapes (port of ``repro/models/model.py``).

``build_model(cfg)`` returns a ``ModelApi`` with the entry points the
trainer, the serving engine and the dry-run use: the enc-dec family through
``models/encdec.py``, every other family (dense, MoE, ssm, hybrid) through
``models/transformer.py``.  ``input_specs`` builds ``meta`` stand-ins for
every model input of a workload shape (no memory), and ``concrete_inputs``
small real batches, the reference's values for the same seed.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import abstract_params, init_params

# The encoder length of the enc-dec cache (the reference's _ENC_LEN_DECODE).
ENC_LEN_DECODE = 4_096


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One workload shape of the reference's dry-run."""

    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """The reference's rule: long_500k needs sub-quadratic state."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "pure full attention: 500k dense KV is the excluded quadratic-state regime"
    return True, ""


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    param_decls: dict
    train_loss: Callable    # (params, batch, impl=None) -> (loss, {"ce", "aux"})
    prefill: Callable       # (params, batch, max_len, impl=None) -> (logits, caches)
    decode_step: Callable   # (params, caches, token, pos, max_len, impl=None) -> (logits, caches)
    cache_decls: Callable   # (batch, max_len) -> decl tree

    def abstract(self, dtype=torch.bfloat16):
        """The parameter tree as ``meta`` tensors."""
        return abstract_params(self.param_decls, dtype)

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


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def _batch_struct(cfg: ModelConfig, b: int, s: int, mode: str, dtype) -> dict[str, Any]:
    """Shapes and dtypes of the model-input batch (shared by specs and concrete)."""
    out: dict[str, Any] = {}
    if cfg.arch_type == "encdec":
        out["frontend_embeds"] = ((b, s if mode == "train" else ENC_LEN_DECODE, cfg.d_model),
                                  dtype)
        if mode != "decode":
            out["tokens"] = ((b, s), torch.int32)
    else:
        if mode != "decode":
            out["tokens"] = ((b, s), torch.int32)
        if cfg.frontend == "vision":
            out["frontend_embeds"] = ((b, min(cfg.frontend_tokens, s), cfg.d_model), dtype)
            if cfg.mrope and mode != "decode":
                out["positions3"] = ((b, s, 3), torch.int32)
    if mode == "train":
        out["labels"] = ((b, s), torch.int32)
    return out


def input_specs(cfg: ModelConfig, shape: InputShape, dtype=torch.bfloat16) -> dict:
    """``meta`` stand-ins for the dry-run (no memory)."""
    struct = _batch_struct(cfg, shape.global_batch, shape.seq_len, shape.mode, dtype)
    return {k: torch.empty(sh, dtype=dt, device="meta") for k, (sh, dt) in struct.items()}


def decode_token_specs(shape: InputShape) -> tuple[torch.Tensor, int]:
    """(token, pos) for a decode shape: a ``meta`` (B,) int32 token and the
    host-int position ``seq_len - 1``, so the step attends to a full cache
    of ``seq_len`` entries (the port's ``decode_step`` takes ``pos`` as an
    int, where the reference traces it)."""
    return torch.empty((shape.global_batch,), dtype=torch.int32, device="meta"), shape.seq_len - 1


def concrete_inputs(cfg: ModelConfig, shape: InputShape, seed: int = 0, dtype=torch.bfloat16,
                    device="cuda") -> dict:
    """Small real batches (reduced configs): the reference's
    ``concrete_inputs(cfg, shape, jax.random.key(seed))`` bit for bit, drawn
    from ``np.random.default_rng(seed)`` in its order, the float rows
    rounded to float32 and then to ``dtype``."""
    dev = resolve_device(device)
    struct = _batch_struct(cfg, shape.global_batch, shape.seq_len, shape.mode, dtype)
    rng = np.random.default_rng(seed)
    out = {}
    for k, (sh, dt) in struct.items():
        if k == "positions3":
            x = np.broadcast_to(np.arange(sh[1])[None, :, None], sh).astype(np.int32)
        elif dt == torch.int32:
            x = rng.integers(0, cfg.vocab_size, sh).astype(np.int32)
        else:
            x = (rng.standard_normal(sh) * 0.02).astype(np.float32)
        out[k] = torch.from_numpy(x).to(device=dev, dtype=dt)
    return out
