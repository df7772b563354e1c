"""Each cell run once on the card, short, through the benchmark's command
(skips without a CUDA device)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from bench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in harness.load_benchmark()["workloads"]])
def test_cell_runs_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "bench/run.py", "--workload", cell, "--seed", "2718281828",
                        "--seconds", "5", "--trace", "0"], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
