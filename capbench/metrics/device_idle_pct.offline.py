"""Share of the window in which the card ran nothing, worked out and not
measured in the window, which is not traced: 1 − (the card's busy time a
batch in the profiled segment after the window × the window's batches) ÷
the window's length by the host's clock.  A kernel's time does not depend
on how fast the host launches it, so the segment's busy time a batch
stands for the window's; the segment's own idle share (``busy_s`` and
``window_s`` of the result's ``device``, read from the trace of the card
alone) runs higher, since the profiler slows the host that paces the
card."""


def read(rec):
    t = rec.get("trace")
    if not t or not t["busy_s"] or not rec.get("trace_batches"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / rec["trace_batches"] * rec["batches"] / rec["window_s"])
