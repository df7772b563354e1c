"""Profile-driven fleet on the PyTorch port: Table I derived from the
roofline of each assigned architecture's decode step on the card, instead
of hand-picked constants, then simulated under four policies.

This is the paper's §V-C "agent profiling methodology" made concrete: the
allocator consumes (T_i, R_i, M_i) that come from the roofline of each
architecture's decode step (``repro_torch/launch/roofline.py``, counted on
the meta device, no card needed), read back through
``repro_torch/core/profiles.py``.  The roofline artifacts are written to a
temporary directory: nothing under ``experiments/`` is read or written.

  PYTHONPATH=src python examples/profile_driven_fleet_torch.py [--device cpu]
"""
import argparse
import json
import os
import tempfile

from repro_torch.core import profiles, run_policy, workload
from repro_torch.launch import mesh, roofline

ARCH_PRIORITY = {           # coordinator-class small models high priority
    "qwen2-vl-2b": 1,
    "granite-8b": 2,
    "mixtral-8x7b": 2,
    "llama3-405b": 1,
}
POLICIES = ("static_equal", "round_robin", "adaptive", "water_filling")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--steps", type=int, default=100)
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory() as root:
        card = mesh.hw()
        for arch in ARCH_PRIORITY:
            res = roofline.run_one(arch, args.shape, card=card)
            with open(os.path.join(root, f"{arch}_{args.shape}_{mesh.TAG}.json"), "w") as f:
                json.dump(res, f)
        print(f"derived profiles (the roofline of each decode step on {card['name']}):")
        derived = {}
        for arch in ARCH_PRIORITY:
            p = derived[arch] = profiles.profile_arch(arch, shape=args.shape, root=root,
                                                      dryrun_root=root)
            print(f"  {arch:16s} T={p['throughput_tokens_per_s']:10.0f} tok/s  "
                  f"R={p['min_gpu']:.3f}  M={p['model_mb']:.0f}MB  bottleneck={p['bottleneck']}")
        fleet = profiles.fleet_from_archs(ARCH_PRIORITY, shape=args.shape, root=root,
                                          dryrun_root=root)

    # offered load proportional to capability, 3x oversubscribed overall
    rates = [t * 0.75 for t in fleet.base_throughput.tolist()]
    arr = workload.constant(rates, args.steps)

    print(f"\n{'policy':16s} {'avg lat (s)':>12s} {'tput (tok/s)':>13s}")
    rows = {}
    for policy in POLICIES:
        s = rows[policy] = run_policy(policy, arr, fleet, device=args.device)
        print(f"{policy:16s} {s.avg_latency:12.2f} {s.total_throughput:13.0f}")
    return {"profiles": derived, "rows": rows}


if __name__ == "__main__":
    main()
