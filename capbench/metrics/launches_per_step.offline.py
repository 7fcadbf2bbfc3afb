"""CUDA kernels run in the profiled segment over the decode steps run
there (encode and merge included, spread over the steps)."""


def read(rec):
    t = rec.get("trace")
    return t["launches"] / t["steps"] if t and t.get("steps") else None
