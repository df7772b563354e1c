"""Serving launcher: the paper's multi-agent fleet on real models, on one GPU.

  PYTHONPATH=src python -m repro_torch.launch.serve --policy adaptive --ticks 20

Port of ``repro/launch/serve.py``.  ``main`` serves ``DEFAULT_FLEET``, the
reference's Table I fleet row for row: qwen2-vl-2b as the coordinator and
the vision specialist (one parameter set), granite-8b, and mixtral-8x7b as
the reasoning specialist.  ``DENSE_FLEET`` serves the same agents — same
names, ``min_gpu``, priorities and rates — from dense backbones only, with
granite-8b in mixtral's place.

At published widths (``--full``) the fleet does not fit one 80 GB card:
mixtral-8x7b alone holds 46.70B parameters, 93.4 GB in bfloat16.  ``--full``
therefore cuts mixtral in depth only, to 16 of its 32 layers
(``FULL_WIDTH_CUT``: 23.5B parameters, 47.0 GB), beside granite-8b (16.5 GB)
and the shared qwen2-vl-2b set (3.6 GB); widths, experts, top-k, window and
vocabulary are never cut.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.agents import AgentSpec, Fleet
from repro_torch.models.model import build_model
from repro_torch.serving.engine import AgentRuntime, FleetEngine

# Paper Table I fleet -> backbone per agent:
# (name, arch, base throughput, min_gpu, priority, arrivals per tick).
DEFAULT_FLEET = (
    ("coordinator", "qwen2-vl-2b", 100.0, 0.10, 1, 3),
    ("specialist_nlp", "granite-8b", 50.0, 0.30, 2, 2),
    ("specialist_vision", "qwen2-vl-2b", 60.0, 0.25, 2, 2),
    ("specialist_reasoning", "mixtral-8x7b", 30.0, 0.35, 1, 1),
)

DENSE_FLEET = tuple(
    (name, "granite-8b" if arch == "mixtral-8x7b" else arch, *rest)
    for name, arch, *rest in DEFAULT_FLEET
)

# The depth cut that fits DEFAULT_FLEET at published widths on one 80 GB card.
FULL_WIDTH_CUT = {"mixtral-8x7b": 16}


def build_engine(policy: str, *, reduced: bool = True, budget_tokens: int = 64,
                 max_len: int = 64, batch_slots: int = 4, fleet=DEFAULT_FLEET,
                 num_layers: dict[str, int] | None = None, device="cuda",
                 seed: int = 0) -> FleetEngine:
    """One engine over ``fleet``.  Every agent's weights come from the same
    seed, as in the reference (one ``jax.random.key(0)`` for all), so agents
    on one architecture share one parameter set on the device.
    ``num_layers`` cuts the named architectures to that many layers (a cut
    only: more layers than the config's raise)."""
    dev = resolve_device(device)
    specs, rts, params = [], {}, {}
    for name, arch, tput, min_gpu, pri, _rate in fleet:
        cfg = get_config(arch, reduced=reduced)
        if num_layers and arch in num_layers:
            if not 0 < num_layers[arch] <= cfg.num_layers:
                raise ValueError(f"{cfg.name}: a cut to {num_layers[arch]} of "
                                 f"{cfg.num_layers} layers")
            cfg = dataclasses.replace(cfg, num_layers=num_layers[arch])
        api = build_model(cfg)
        if arch not in params:
            params[arch] = api.init(seed, device=dev)
        specs.append(AgentSpec(name, cfg.param_count / 1e6, tput, min_gpu, pri))
        rts[name] = AgentRuntime(name, api, params[arch], max_len=max_len,
                                 batch_slots=batch_slots)
    return FleetEngine(Fleet.from_specs(specs), rts, policy=policy,
                       budget_tokens=budget_tokens, device=dev)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy", default="adaptive")
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--budget-tokens", type=int, default=64)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true", help="published widths, not reduced")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    fleet = DEFAULT_FLEET
    cut = FULL_WIDTH_CUT if args.full else None
    if cut:
        print(f"published widths; depth cut to fit one card: {cut}", flush=True)
    eng = build_engine(args.policy, reduced=not args.full, budget_tokens=args.budget_tokens,
                       fleet=fleet, num_layers=cut, device=args.device, seed=args.seed)
    vocab = min(rt.api.cfg.vocab_size for rt in eng.runtimes)
    rng = np.random.default_rng(args.seed)
    for t in range(args.ticks):
        for (name, _, _, _, _, rate) in fleet:
            for _ in range(rng.poisson(rate)):
                eng.submit(name, rng.integers(0, vocab, args.prompt_len), args.max_new)
        eng.step()
        h = eng.history[-1]
        print(f"tick {t:3d} alloc={[round(x, 2) for x in h['allocation']]} "
              f"queues={[int(q) for q in h['queues']]}", flush=True)
    print(json.dumps(eng.metrics(), indent=1))


if __name__ == "__main__":
    main()
