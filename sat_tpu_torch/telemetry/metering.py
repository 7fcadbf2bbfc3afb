"""Engine busy time from span aggregates — the port's copy of the busy-span
accounting of ``sat_tpu.telemetry.metering`` (per-request cost
attribution is not ported).
"""

from __future__ import annotations

# Span names whose aggregate totals ARE the measured device-busy windows:
# continuous mode records serve/encode per lane chunk and serve/step per
# fused window; batch mode records serve/encode per dispatch and
# serve/decode_window per drained batch.  Only one mode runs per server,
# so summing all three never double-counts.  Bulk drives the slot pool
# without the serve loop, so of these it records serve/encode alone.
BUSY_SPANS = ("serve/encode", "serve/step", "serve/decode_window")


def measured_busy_ms(tel) -> float:
    """Engine busy time (ms) summed over :data:`BUSY_SPANS`."""
    agg = tel.aggregates()
    return sum(agg[n][1] / 1e6 for n in BUSY_SPANS if n in agg)
