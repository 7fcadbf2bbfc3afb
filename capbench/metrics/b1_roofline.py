"""The fused attention kernel's (B1's) share of its roofline in the
profiled segment: its least time by the benchmark's own byte and
operation count over its device time, summed by kernel name."""

from capbench.roofline import attention_bound_s
from capbench.trace import kernel_time


def read(rec):
    t = rec.get("trace")
    if not t:
        return None
    launches, seconds = kernel_time(t, "fused_attend")
    if not launches or seconds <= 0:
        return None
    cfg = rec["config"]
    bound, _ = attention_bound_s(rec["batch"] * cfg["beam_size"], cfg["num_ctx"],
                                 cfg["dim_attend_layer"], cfg["dim_ctx"])
    return 100.0 * launches * bound / seconds
