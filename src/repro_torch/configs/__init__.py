"""Assigned-architecture registry: ``--arch <id>`` resolution."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = (
    "seamless-m4t-large-v2",
    "llama3-405b",
    "qwen2-vl-2b",
    "deepseek-67b",
    "minitron-4b",
    "granite-8b",
    "granite-moe-1b-a400m",
    "mamba2-370m",
    "recurrentgemma-9b",
    "mixtral-8x7b",
)

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_") for a in ARCH_IDS}


def get_config(arch_id: str, *, reduced: bool = False) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch '{arch_id}'; known: {ARCH_IDS}")
    mod = importlib.import_module(_MODULES[arch_id])
    return mod.REDUCED if reduced else mod.CONFIG


def all_configs(*, reduced: bool = False) -> dict[str, ModelConfig]:
    return {a: get_config(a, reduced=reduced) for a in ARCH_IDS}
