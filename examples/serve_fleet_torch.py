"""End-to-end driver on the PyTorch port (the paper is a serving paper): the
Table I fleet of four agents, each a REAL reduced-config model from the
assigned pool, served with batched requests under the adaptive allocator —
then the same traffic under round-robin for comparison.  Runs on the card
unless ``--device cpu`` is given.

Prompts draw their tokens below the fleet's smallest vocabulary (the
reduced configs' 512), where the JAX example draws below 1000.

  PYTHONPATH=src python examples/serve_fleet_torch.py [--ticks 16] [--device cpu]
"""
import argparse
import json

import numpy as np

from repro_torch.launch.serve import DEFAULT_FLEET, build_engine


def drive(policy: str, ticks: int, device, seed: int = 0) -> dict:
    eng = build_engine(policy, budget_tokens=48, max_len=48, device=device)
    vocab = min(rt.api.cfg.vocab_size for rt in eng.runtimes)
    rng = np.random.default_rng(seed)
    for t in range(ticks):
        for (name, _, _, _, _, rate) in DEFAULT_FLEET:
            for _ in range(rng.poisson(rate)):
                eng.submit(name, rng.integers(0, vocab, 6), max_new_tokens=3)
        eng.step()
    return eng.metrics()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    results = {}
    for policy in ("adaptive", "round_robin"):
        m = drive(policy, args.ticks, args.device)
        results[policy] = m
        print(f"\n== {policy} ==")
        print(json.dumps(m, indent=1))
    a, r = results["adaptive"], results["round_robin"]
    if np.isfinite(a["avg_latency_ticks"]) and np.isfinite(r["avg_latency_ticks"]):
        red = 1 - (a["avg_latency_ticks"] + 1) / (r["avg_latency_ticks"] + 1)
        print(f"\nadaptive vs round-robin latency reduction: {100*red:.0f}% "
              f"(paper's simulator-level figure: 85%)")
    return results


if __name__ == "__main__":
    main()
