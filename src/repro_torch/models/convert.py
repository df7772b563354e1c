"""Parameters of the JAX package, as the port holds them.

``params_from_numpy`` takes the reference's parameter tree with every leaf
converted to a numpy array (``jax.tree_util.tree_map(np.asarray, params)``)
and returns the port's tree.  The reference stacks its superblocks: each
``b{i}_{kind}`` leaf carries a leading ``layers`` axis, one entry per
superblock, and the ``t{i}_{kind}`` tail blocks follow unstacked.  The port
keeps one dict per layer, in the reference's execution order: superblock 0's
sub-blocks in pattern order, then superblock 1, ..., then the tail
(``transformer.layer_kinds``).  The enc-dec tree stacks its encoder and
decoder blocks the same way (``enc_blocks``, ``dec_blocks``), with no tail;
the port's ``enc_blocks`` and ``dec_blocks`` are lists of one dict per
layer.  Types are kept: float32 stays float32, and
bfloat16 (numpy's ``ml_dtypes`` bfloat16) goes through float32, which is
exact.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import tree_leaves, tree_map


def _tensor(x: np.ndarray, device) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype.name not in ("float32", "bfloat16"):
        raise TypeError(f"unsupported parameter dtype {x.dtype}")
    dtype = torch.float32 if x.dtype == np.float32 else torch.bfloat16
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(device=device, dtype=dtype)


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    """Reference parameter tree (numpy leaves) -> the port's parameter tree,
    on ``device`` (``cuda`` unless the caller asks for the host)."""
    device = resolve_device(device)
    leaf = lambda x: _tensor(x, device)  # noqa: E731
    if cfg.arch_type == "encdec":
        return {
            "embed": tree_map(leaf, tree["embed"]),
            "enc_blocks": _unstack(tree["enc_blocks"], cfg.encoder_layers, device),
            "enc_norm": tree_map(leaf, tree["enc_norm"]),
            "dec_blocks": _unstack(tree["dec_blocks"], cfg.num_layers, device),
            "final_norm": tree_map(leaf, tree["final_norm"]),
        }
    pat = transformer.block_pattern(cfg)
    n_super, rem = transformer.super_counts(cfg)
    stacked = [f"b{i}_{kind}" for i, kind in enumerate(pat)]
    tail = [f"t{i}_{pat[i]}" for i in range(rem)]
    if set(tree["blocks"]) != set(stacked) or set(tree.get("tail", {})) != set(tail):
        raise ValueError(f"{cfg.name}: blocks {sorted(tree['blocks'])} and tail "
                         f"{sorted(tree.get('tail', {}))}, expected {stacked} and {tail}")
    blocks = [tree_map(lambda x, i=i: _tensor(x[i], device), tree["blocks"][name])
              for i in range(n_super) for name in stacked]
    blocks += [tree_map(leaf, tree["tail"][name]) for name in tail]
    return {
        "embed": tree_map(leaf, tree["embed"]),
        "final_norm": tree_map(leaf, tree["final_norm"]),
        "blocks": blocks,
    }


def _unstack(stacked: dict, n: int, device) -> list:
    """A tree whose leaves carry a leading layers axis of ``n`` -> one tree
    per layer."""
    sizes = {x.shape[0] for x in tree_leaves(stacked)}
    if sizes != {n}:
        raise ValueError(f"stacked blocks with leading axes {sorted(sizes)}, expected {n}")
    return [tree_map(lambda x, i=i: _tensor(x[i], device), stacked) for i in range(n)]


def opt_state_from_numpy(opt_state: dict, cfg: ModelConfig, device="cuda") -> dict:
    """Reference optimizer state (``{"m", "v", "step"}``, numpy leaves) -> the
    port's: m and v carried as ``params_from_numpy`` carries the parameters
    (float32 trees), the step as an int32 tensor, on ``device``."""
    device = resolve_device(device)
    return {"m": params_from_numpy(opt_state["m"], cfg, device),
            "v": params_from_numpy(opt_state["v"], cfg, device),
            "step": torch.tensor(int(np.asarray(opt_state["step"])), dtype=torch.int32,
                                 device=device)}
