"""The bf16 SSD scan backward's four kernels' share of their roofline in the
traced training steps: the least time of the backward calls (bench/counts,
at the model's shapes, no initial state, no final-state cotangent) over
the four kernels' device time.  A call is one launch of the last kernel."""
from bench import counts

LAYER = "kernels: kernels/*/csrc"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"
KERNELS = ("ssd_bwd_states_sm90_kernel", "ssd_bwd_passing_sm90_kernel",
           "ssd_bwd_grads_sm90_kernel", "ssd_bwd_reduce_sm90_kernel")


def read(rec):
    d = rec.data
    t = rec.kernel_seconds(KERNELS)
    calls = rec.kernel_calls(KERNELS[-1:])
    if not t or not calls or "model" not in d or d["model"]["family"] != "ssm":
        return None
    m = d["model"]
    di = m["ssm_expand"] * m["d_model"]
    f, b = counts.ssd_bwd(d["batch"], d["seq"], di // m["ssm_head_dim"], m["ssm_head_dim"],
                          m["ssm_state_dim"], chunk=m["ssm_chunk_size"])
    return 100.0 * calls * counts.bound_s(f, b) / t
