"""§V-B robustness study + beyond-paper policy comparison under five
workload regimes (steady / 3x overload / spike / diurnal / poisson), on the
PyTorch port.  The poisson regime draws from the port's own sampler (an
inverse-CDF over threefry uniforms, ``repro_torch/core/workload.py``), so
its row is a different draw than the JAX example's.

  PYTHONPATH=src python examples/robustness_study_torch.py [--device cpu] [--steps 100]
"""
import argparse

from repro_torch.core import PAPER_ARRIVAL_RATES, paper_fleet, prng, run_policy, workload

POLICIES = ("static_equal", "round_robin", "adaptive", "water_filling", "predictive")


def regimes(steps: int = 100) -> dict:
    rates = PAPER_ARRIVAL_RATES
    return {
        "steady": workload.constant(rates, steps),
        "overload_3x": workload.scaled(rates, steps, 3.0),
        "spike_10x": workload.spike(rates, steps, spike_agent=3, spike_start=steps // 2,
                                    spike_len=steps // 5),
        "diurnal": workload.diurnal(rates, steps),
        "poisson": workload.poisson(rates, steps, prng.key(0)),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=100)
    args = ap.parse_args(argv)

    fleet = paper_fleet()
    table = {regime: {p: run_policy(p, arr, fleet, device=args.device) for p in POLICIES}
             for regime, arr in regimes(args.steps).items()}

    print(f"{'regime':12s} " + " ".join(f"{p:>14s}" for p in POLICIES) + "   (avg latency s)")
    for regime, row in table.items():
        print(f"{regime:12s} " + " ".join(f"{row[p].avg_latency:14.1f}" for p in POLICIES))

    print("\nthroughput (rps):")
    for regime, row in table.items():
        print(f"{regime:12s} " + " ".join(f"{row[p].total_throughput:14.2f}" for p in POLICIES))
    return table


if __name__ == "__main__":
    main()
