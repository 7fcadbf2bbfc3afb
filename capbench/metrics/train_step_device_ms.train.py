"""Device time of one train step: every kernel, copy and fill of the
profiled steps, summed, over the steps."""


def read(rec):
    t = rec.get("trace")
    if not t or not t.get("steps"):
        return None
    return 1e3 * sum(v[1] for v in t["kernels"].values()) / t["steps"]
