"""Wall time of one beam-search step: (a batch's share of the window by
the host's clock, less its encode's device time from ``encode_ms``) over
the steps a batch ran.  A step is one launch of the fused attention
kernel (the program's ``fused_attend.launches`` counter)."""


def read(rec):
    times = rec.get("encode_s")
    if not times or not rec.get("steps"):
        return None
    per_batch = rec["window_s"] / rec["batches"] - sum(times) / len(times)
    return 1e3 * per_batch / (rec["steps"] / rec["batches"])
