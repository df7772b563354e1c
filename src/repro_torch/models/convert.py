"""Parameters of the JAX package, as the port holds them.

``params_from_numpy`` takes the reference's parameter tree with every leaf
converted to a numpy array (``jax.tree_util.tree_map(np.asarray, params)``)
and returns the port's tree: the stacked ``blocks`` superblock, whose leaves
carry a leading ``layers`` axis, becomes one dict per layer.  Types are
kept: float32 stays float32, and bfloat16 (numpy's ``ml_dtypes`` bfloat16)
goes through float32, which is exact.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.params import tree_map


def _tensor(x: np.ndarray, device) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype.name not in ("float32", "bfloat16"):
        raise TypeError(f"unsupported parameter dtype {x.dtype}")
    dtype = torch.float32 if x.dtype == np.float32 else torch.bfloat16
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(device=device, dtype=dtype)


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cpu") -> dict:
    """Reference parameter tree (numpy leaves) -> the port's parameter tree."""
    if cfg.arch_type != "dense" or set(tree["blocks"]) != {"b0_attn_mlp"} or "tail" in tree:
        raise NotImplementedError(f"{cfg.name}: only dense attn_mlp stacks convert so far")
    stacked = tree["blocks"]["b0_attn_mlp"]
    blocks = [tree_map(lambda x, i=i: _tensor(x[i], device), stacked)
              for i in range(cfg.num_layers)]
    return {
        "embed": tree_map(lambda x: _tensor(x, device), tree["embed"]),
        "final_norm": tree_map(lambda x: _tensor(x, device), tree["final_norm"]),
        "blocks": blocks,
    }
