"""Agent profiling from dry-run artifacts (paper §V-C "agent profiling
methodologies"); port of ``repro/core/profiles.py``.

The paper hand-specifies Table I (T_i, R_i).  This module derives them for
any architecture from the artifacts that ``launch/roofline.py`` and
``launch/dryrun.py`` write for the card (``experiments/roofline_torch``,
``experiments/dryrun_torch``), with the reference's formulas:

  T_i  decode throughput: the shape's batch of tokens per step over the
       dominant roofline term (compute, memory or collective);
  R_i  minimum resource share: the step's argument bytes (parameters and
       cache) over the card's memory (``mesh.hw()["hbm_bytes"]``), clamped
       to [0.02, 0.9];
  M_i  parameter bytes in MB (bfloat16).

The batch is the shape's own: ``decode_32k`` (128 rows against 32768
entries, where every attention model's cache outgrows one card and R_i
clamps at 0.9) or ``ENGINE_DECODE``, the shape the serving engine decodes
at on one card (4 slots against 1024 entries).  ``fleet_from_archs`` builds
a Fleet the allocator, the simulator and the engine take.
"""
from __future__ import annotations

import glob
import json
import os

from repro_torch.configs import get_config
from repro_torch.core.agents import AgentSpec, Fleet
from repro_torch.launch import mesh
from repro_torch.models.model import INPUT_SHAPES, InputShape

# The serving engine's decode shape on one card: 4 slots (``build_engine``'s
# ``batch_slots``) against a cache of 1024 entries (its ``max_len``).
ENGINE_DECODE = InputShape("engine_decode", 1_024, 4, "decode")

ROOFLINE_ROOT = "experiments/roofline_torch"
DRYRUN_ROOT = "experiments/dryrun_torch"


def _shape(shape) -> InputShape:
    return INPUT_SHAPES[shape] if isinstance(shape, str) else shape


def _path(root: str, arch: str, shape) -> str:
    return os.path.join(root, f"{arch}_{_shape(shape).name}_{mesh.TAG}.json")


def load_roofline(arch: str, shape="decode_32k", root: str = ROOFLINE_ROOT) -> dict | None:
    path = _path(root, arch, shape)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        d = json.load(f)
    return d if "roofline_s" in d else None


def profile_arch(arch: str, *, shape="decode_32k", root: str = ROOFLINE_ROOT,
                 dryrun_root: str = DRYRUN_ROOT) -> dict | None:
    """Derived (T, R, M) of one architecture at ``shape`` (a name of
    ``INPUT_SHAPES`` or an ``InputShape``) from recorded artifacts; R_i over
    the memory of ``mesh.hw()``'s card."""
    roof = load_roofline(arch, shape, root)
    if roof is None:
        return None
    step_s = max(roof["roofline_s"].values())
    tput = _shape(shape).global_batch / max(step_s, 1e-9)
    param_bytes = get_config(arch).param_count * 2  # bf16
    chips = roof["chips"]
    # the step's footprint per device: parameters and cache (the dry-run's
    # argument bytes where it ran)
    arg_bytes = None
    dr_path = _path(dryrun_root, arch, shape)
    if os.path.exists(dr_path):
        with open(dr_path) as f:
            arg_bytes = (json.load(f).get("per_device") or {}).get("argument_bytes")
    arg_bytes = arg_bytes or param_bytes / chips
    min_share = min(0.9, max(0.02, arg_bytes / mesh.hw()["hbm_bytes"]))
    return {
        "arch": arch,
        "throughput_tokens_per_s": tput,
        "min_gpu": round(float(min_share), 4),
        "model_mb": param_bytes / 2**20,
        "bottleneck": roof["bottleneck"],
        "step_s": step_s,
    }


def fleet_from_archs(arch_priority: dict[str, int], **kw) -> Fleet:
    """A Fleet whose (M, T, R) come from the recorded artifacts."""
    specs = []
    for arch, pri in arch_priority.items():
        p = profile_arch(arch, **kw)
        if p is None:
            raise FileNotFoundError(
                f"no roofline artifact for {arch}; run repro_torch.launch.roofline first"
            )
        specs.append(AgentSpec(arch, p["model_mb"], p["throughput_tokens_per_s"],
                               p["min_gpu"], pri))
    return Fleet.from_specs(specs)


def available_archs(root: str = ROOFLINE_ROOT, shape="decode_32k") -> list[str]:
    out = []
    for f in glob.glob(os.path.join(root, f"*_{_shape(shape).name}_{mesh.TAG}.json")):
        with open(f) as fh:
            d = json.load(fh)
        if "roofline_s" in d:
            out.append(d["arch"])
    return sorted(set(out))
