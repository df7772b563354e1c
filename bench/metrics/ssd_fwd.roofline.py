"""The bf16 SSD scan forward kernel's share of its roofline in the traced
training steps: the least time of its calls (bench/counts, at the model's
shapes: the batch, the sequence, the heads, chunk 128, no initial state)
over its device time."""
from bench import counts

LAYER = "kernels: kernels/*/csrc"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"
KERNELS = ("ssd_sm90_kernel",)


def read(rec):
    d = rec.data
    t = rec.kernel_seconds(KERNELS)
    calls = rec.kernel_calls(KERNELS)
    if not t or "model" not in d or d["model"]["family"] != "ssm":
        return None
    m = d["model"]
    di = m["ssm_expand"] * m["d_model"]
    f, b = counts.ssd_fwd(d["batch"], d["seq"], di // m["ssm_head_dim"], m["ssm_head_dim"],
                          m["ssm_state_dim"], chunk=m["ssm_chunk_size"])
    return 100.0 * calls * counts.bound_s(f, b) / t
