"""Flat-npz checkpoints of parameter and optimizer-state trees (port of
``repro/checkpoint/ckpt.py``, in its format).

Keys are tree paths written as the reference's ``jax.tree_util.keystr``
writes them (``['params']['blocks'][0]['attn']['wq']``: a dict key quoted,
a list index bare); bfloat16 leaves are stored as uint16 views, and a
``__dtypes__`` JSON sidecar names each leaf's dtype, so numpy round-trips
every leaf exactly.  The port's trees hold one dict per layer where the
reference's stack them, so the two packages' parameter checkpoints have
different keys: ``load_numpy`` reads either into nested numpy trees, and
``models/convert.py`` carries a reference tree into the port's.
"""
from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from repro_torch._device import resolve_device

_NUMPY = {torch.float32: np.float32, torch.int32: np.int32, torch.int64: np.int64}
_KEY = re.compile(r"\[(?:'([^']*)'|(\d+))\]")


def _flatten(tree, prefix: str = "") -> dict:
    """{path: leaf}, in the tree's order."""
    if isinstance(tree, dict):
        items = ((f"{prefix}['{key}']", sub) for key, sub in tree.items())
    elif isinstance(tree, (list, tuple)):
        items = ((f"{prefix}[{i}]", sub) for i, sub in enumerate(tree))
    else:
        return {prefix: tree}
    return {k: v for path, sub in items for k, v in _flatten(sub, path).items()}


def save(path: str, tree) -> None:
    """Write ``tree`` (nested dicts and lists of tensors) to ``path``."""
    arrays, dtypes = {}, {}
    for k, t in _flatten(tree).items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            dtypes[k] = "bfloat16"
            arrays[k] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            dtypes[k] = str(np.dtype(_NUMPY[t.dtype]))
            arrays[k] = t.numpy()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, __dtypes__=json.dumps(dtypes), **arrays)


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(path: str, like, device="cuda"):
    """The tree of ``like``'s structure read from ``path``, each leaf in its
    stored dtype on ``device``; raises where a stored leaf's shape is not
    ``like``'s."""
    dev = resolve_device(device)
    flat = _flatten(like)
    with np.load(path, allow_pickle=False) as z:
        dtypes = json.loads(str(z["__dtypes__"]))
        leaves = {}
        for k, leaf in flat.items():
            arr = z[k]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{k}: checkpoint {arr.shape} vs model {tuple(leaf.shape)}")
            leaves[k] = _tensor(arr, dtypes[k]).to(dev)
    return _unflatten(like, leaves)


def _unflatten(like, leaves: dict, prefix: str = ""):
    if isinstance(like, dict):
        return {key: _unflatten(sub, leaves, f"{prefix}['{key}']") for key, sub in like.items()}
    if isinstance(like, (list, tuple)):
        return [_unflatten(sub, leaves, f"{prefix}[{i}]") for i, sub in enumerate(like)]
    return leaves[prefix]


def load_numpy(path: str):
    """Every leaf of a checkpoint of either package as a nested tree of numpy
    arrays (dict keys and list indices parsed from the paths); bfloat16
    leaves are widened to float32, which is exact."""
    root: dict = {}
    with np.load(path, allow_pickle=False) as z:
        dtypes = json.loads(str(z["__dtypes__"]))
        for k, dtype in dtypes.items():
            keys = [name if name else int(idx) for name, idx in _KEY.findall(k)]
            node = root
            for key in keys[:-1]:
                node = node.setdefault(key, {})
            arr = z[k]
            node[keys[-1]] = _tensor(arr, dtype).float().numpy() if dtype == "bfloat16" else arr
    return _lists(root)


def _lists(node):
    """Dicts keyed 0..n-1 by list indices -> lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        return [out[i] for i in range(len(out))]
    return out
