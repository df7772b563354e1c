"""Device milliseconds a step of the kernels launched inside the profiler
range ``train_step.forward`` (the forward before remat's recompute)."""
LAYER = "trainer: training/train_step.py"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"
RANGE = "train_step.forward"


def read(rec):
    t = rec.ranges.get(RANGE)
    if not t or not rec.data.get("steps"):
        return None
    return 1e3 * t / rec.data["steps"]
