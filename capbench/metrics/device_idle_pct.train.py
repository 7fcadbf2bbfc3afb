"""Share of the window in which the card ran nothing, worked out and not
measured in the window, which is not traced: 1 − (the card's busy time a
step in the profiled segment after the window × the window's steps) ÷ the
window's length by the host's clock (see ``device_idle_pct.offline``; the
segment's own idle share is in the result's ``device``)."""


def read(rec):
    t = rec.get("trace")
    if not t or not t["busy_s"] or not t.get("steps"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["steps"] * rec["steps"] / rec["window_s"])
