"""Device time of one batch's encode: a pair of CUDA events, timed by the
card, around the program's ``captioner.encode`` as
``runtime.decode_batch`` calls it (the harness's wrapper, in a traced run
only), averaged over the window's batches."""


def read(rec):
    times = rec.get("encode_s")
    return 1e3 * sum(times) / len(times) if times else None
