"""The share of the traced training steps in which no operation ran on the
device."""
LAYER = "device: H100"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(rec):
    if "step_s" not in rec.data or not rec.window_s or not rec.busy_s:
        return None
    return 100.0 * (1.0 - rec.busy_s / rec.window_s)
