"""Prometheus text exposition (format 0.0.4) over the telemetry recorder —
the port's copy of ``sat_tpu.telemetry.promtext``'s ``render``.

Everything rendered here is already host-side — counters, gauges and span
aggregates live in the recorder, and the extras come from the heartbeat
payload computed anyway — so exposition is a pure read with no device
sync.  Three families cover the whole recorder without a registration
step:

* ``sat_counter_total{name="serve/completed"}`` — monotonic counters;
* ``sat_gauge{name="serve/queue_depth"}`` — last-set gauges, plus any
  numeric scalars of an ``extra`` mapping (heartbeat payload fields);
* ``sat_span_seconds_count`` / ``sat_span_seconds_sum`` — per-span
  summary pairs from :meth:`Telemetry.aggregates`.

Callers may add true histogram families (cumulative ``_bucket{le=…}`` /
``_sum`` / ``_count``) for chosen spans via ``render(histograms=…)``,
counted over the recorder's retained sample window.  The caption server
serves this from ``GET /metrics``; the train phase's read-only listener
is not ported.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

CONTENT_TYPE = "text/plain; version=0.0.4"

# A histogram request: span name to sample, upper bounds (in OUTPUT
# units, ascending; +Inf is implicit), and the factor converting the
# recorder's raw int64 slot values into output units (1e-9 for ns→s;
# 1.0 for spans that store raw counts, e.g. steps-per-dispatch).
HistogramSpec = Tuple[str, Sequence[float], float]

_ESCAPES = {"\\": "\\\\", '"': '\\"', "\n": "\\n"}


def _escape_label(value: str) -> str:
    return "".join(_ESCAPES.get(ch, ch) for ch in value)


def _fmt(value) -> str:
    # Prometheus wants plain decimal or scientific notation; repr of a
    # python int/float satisfies that, but bools must narrow to 0/1.
    if isinstance(value, bool):
        return "1" if value else "0"
    return repr(value) if isinstance(value, float) else str(int(value))


def _histogram_lines(
    tel, family: str, spec: HistogramSpec, lines: List[str]
) -> None:
    """Append one cumulative-bucket histogram family computed from the
    span's retained sample window.  Bucket counts are le-cumulative per
    the exposition format; ``_sum``/``_count`` cover the same window so
    ``histogram_quantile()`` is internally consistent."""
    span, bounds, scale = spec
    values = tel.durations_ns(span).astype(np.float64) * scale
    lines.append(f"# HELP {family} sampled window of span {span}")
    lines.append(f"# TYPE {family} histogram")
    sorted_values = np.sort(values)
    for le in bounds:
        n = int(np.searchsorted(sorted_values, float(le), side="right"))  # sync-ok: host telemetry ring
        lines.append(f'{family}_bucket{{le="{_fmt(float(le))}"}} {n}')  # sync-ok: host scalar
    lines.append(f'{family}_bucket{{le="+Inf"}} {values.size}')
    lines.append(f"{family}_sum {_fmt(round(float(values.sum()), 9))}")  # sync-ok: host telemetry ring
    lines.append(f"{family}_count {values.size}")


def render(
    tel,
    extra: Optional[Mapping[str, object]] = None,
    histograms: Optional[Mapping[str, HistogramSpec]] = None,
) -> str:
    """The exposition document for ``tel``'s current state.

    ``extra`` merges additional numeric scalars into the gauge family
    (non-numeric values are skipped, not errors — callers hand whole
    heartbeat payloads over without filtering).  ``histograms`` maps
    family names to :data:`HistogramSpec` requests; each renders a true
    cumulative-bucket histogram alongside the three standing families."""
    lines: List[str] = []

    counters = tel.counters()
    lines.append("# HELP sat_counter_total sat_tpu telemetry counters")
    lines.append("# TYPE sat_counter_total counter")
    for name in sorted(counters):
        lines.append(
            f'sat_counter_total{{name="{_escape_label(name)}"}} '
            f"{_fmt(counters[name])}"
        )

    gauges: Dict[str, object] = dict(tel.gauges())
    if extra:
        for key, value in extra.items():
            if isinstance(value, (int, float)) and key not in gauges:
                gauges[key] = value
    lines.append("# HELP sat_gauge sat_tpu telemetry gauges")
    lines.append("# TYPE sat_gauge gauge")
    for name in sorted(gauges):
        value = gauges[name]
        if isinstance(value, (int, float)):
            lines.append(
                f'sat_gauge{{name="{_escape_label(name)}"}} {_fmt(value)}'
            )

    aggregates = tel.aggregates()
    lines.append(
        "# HELP sat_span_seconds host span durations (summary: count+sum)"
    )
    lines.append("# TYPE sat_span_seconds summary")
    for name in sorted(aggregates):
        count, total_ns, _ = aggregates[name]
        label = _escape_label(name)
        lines.append(f'sat_span_seconds_count{{span="{label}"}} {_fmt(count)}')
        lines.append(
            f'sat_span_seconds_sum{{span="{label}"}} '
            f"{_fmt(round(total_ns / 1e9, 9))}"
        )

    if histograms:
        for family in sorted(histograms):
            _histogram_lines(tel, family, histograms[family], lines)

    lines.append("# HELP sat_up exposition endpoint liveness")
    lines.append("# TYPE sat_up gauge")
    lines.append("sat_up 1")
    return "\n".join(lines) + "\n"

