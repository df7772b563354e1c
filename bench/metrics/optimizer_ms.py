"""Device milliseconds a step of the kernels launched inside the profiler
range ``train_step.optimizer`` (AdamW over every leaf)."""
LAYER = "optimizer: training/optimizer.py adamw_update"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"
RANGE = "train_step.optimizer"


def read(rec):
    t = rec.ranges.get(RANGE)
    if not t or not rec.data.get("steps"):
        return None
    return 1e3 * t / rec.data["steps"]
