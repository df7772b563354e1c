"""Quickstart on the PyTorch port: reproduce the paper's Table II in ~20
lines, on the card (``--device cpu`` for the host).

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

from repro_torch.core import PAPER_ARRIVAL_RATES, paper_fleet, run_policy, workload

POLICIES = ("static_equal", "round_robin", "adaptive")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    fleet = paper_fleet()
    arrivals = workload.constant(PAPER_ARRIVAL_RATES, num_steps=100)

    print(f"{'policy':16s} {'avg lat (s)':>12s} {'tput (rps)':>11s} {'cost':>7s}")
    rows = {}
    for policy in POLICIES:
        s = rows[policy] = run_policy(policy, arrivals, fleet, device=args.device)
        print(f"{policy:16s} {s.avg_latency:12.1f} {s.total_throughput:11.2f} ${s.cost:.3f}")

    print("\npaper Table II:  static 110.3 / 60.0   round-robin 756.1 / 60.0"
          "   adaptive 111.9 / 58.1   (all $0.020)")
    return rows


if __name__ == "__main__":
    main()
