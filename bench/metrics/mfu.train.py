"""6·N·tokens a training step (bench/counts) over the step's time and the
bf16 peak."""
from bench import counts

LAYER = "whole step: a training step"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "train_tokens_per_s"


def read(rec):
    d = rec.data
    if "step_s" not in d:
        return None
    flops = counts.train_flops(d["model"], d["n_params"], d["batch"], d["seq"])
    return 100.0 * flops / d["step_s"] / counts.PEAK_BF16_FLOPS
