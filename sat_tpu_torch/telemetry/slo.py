"""SLO engine — the port's copy of ``sat_tpu.telemetry.slo``: declared
objectives, sliding windows, fast/slow burn rates.

An objective turns a signal the telemetry layer already records into a
yes/no question ("is the serve p99 under 250 ms?") and the engine answers
it continuously with the multiwindow rule: an objective is **burning**
only when BOTH a fast window (default 60 s) and a slow window (default
300 s) violate the target.  Early in a run both windows see the same
short history, so a sustained violation alarms before the slow window
has filled.

Six objective kinds: ``latency_p99`` (pXX of a span in the window),
``error_ratio`` (Δ counter / Δ denominator), ``rate_floor`` (Δ/Δt ×
scale, burning when too slow), ``age_ceiling`` (now − a unix-stamp
gauge), ``gauge_ceiling`` and ``gauge_floor`` (a gauge against a
maximum / minimum).

Outputs ride existing carriers: ``slo/*`` gauges (heartbeat and
/metrics), ok↔burning transitions appended to ``slo.jsonl`` through the
rotating sink, and :meth:`SLOEngine.burning`, which ``/healthz``
consults to report "degraded" with the objective named.  Sync-free and
degrade-don't-raise throughout.  :func:`objectives_from_config` builds
the same lanes as the JAX package's; the serve phase passes no tenant
lanes until the tenant plane is ported.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from . import SCHEMA_VERSION, run_id

KINDS = (
    "latency_p99",
    "error_ratio",
    "rate_floor",
    "age_ceiling",
    "gauge_ceiling",
    "gauge_floor",
)

# an objective only evaluates once its window holds this many events
# (latency/error kinds) — one outlier must not page
MIN_EVENTS = 3


@dataclass(frozen=True)
class Objective:
    """One declared objective: a signal, a target, and how to compare."""

    name: str          # short id, appears in gauges / healthz / slo.jsonl
    kind: str          # one of KINDS
    target: float      # the objective value (ms, ratio, rate, seconds)
    source: str        # span name (latency), counter (error/rate), gauge
    denom: str = ""    # error_ratio only: the denominator counter
    scale: float = 1.0  # rate_floor only: units per source increment

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"unknown SLO kind {self.kind!r} (one of {KINDS})")
        if self.target <= 0:
            raise ValueError(f"SLO {self.name}: target must be > 0")


def _quantile(sorted_vals: List[int], q: float) -> int:
    idx = min(len(sorted_vals) - 1, int(q / 100.0 * len(sorted_vals)))
    return sorted_vals[idx]


class SLOEngine:
    """Evaluates objectives over the recorder; owns the slo.jsonl log.

    ``clock_ns`` is injectable for deterministic transition tests — it
    must be the same timebase the recorder's span t0s use
    (``perf_counter_ns`` in production)."""

    def __init__(
        self,
        tel,
        objectives: List[Objective],
        jsonl_path: str = "",
        cap_bytes: int = 0,
        fast_s: float = 60.0,
        slow_s: float = 300.0,
        clock_ns: Callable[[], int] = time.perf_counter_ns,
        wall_clock: Callable[[], float] = time.time,
    ) -> None:
        self._tel = tel
        self.objectives = list(objectives)
        self.jsonl_path = jsonl_path
        self.cap_bytes = int(cap_bytes)
        self.fast_s = fast_s
        self.slow_s = max(slow_s, fast_s)
        self._clock_ns = clock_ns
        self._wall = wall_clock
        # (t_ns, counters, gauges) snapshots for windowed deltas; sized to
        # comfortably cover the slow window at the default tick cadence
        self._snaps: "deque" = deque(maxlen=4096)
        self._burning: Dict[str, bool] = {o.name: False for o in objectives}
        self._last_eval: Dict[str, Dict] = {}
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- measurement -------------------------------------------------------

    def _span_p99_ms(self, source: str, window_s: float, now_ns: int):
        names, ids, t0s, durs, _ = self._tel.spans_snapshot()
        try:
            want = names.index(source)
        except ValueError:
            return None
        cutoff = now_ns - int(window_s * 1e9)
        samples = [
            int(durs[k])
            for k in range(len(ids))
            if int(ids[k]) == want and int(t0s[k]) >= cutoff
        ]
        if len(samples) < MIN_EVENTS:
            return None
        samples.sort()
        return _quantile(samples, 99) / 1e6

    def _window_snap(self, window_s: float, now_ns: int):
        """The oldest retained snapshot inside the window (None when the
        window isn't half-covered yet — too early to judge a rate)."""
        cutoff = now_ns - int(window_s * 1e9)
        oldest = None
        for snap in self._snaps:
            if snap[0] >= cutoff:
                oldest = snap
                break
        if oldest is None or now_ns - oldest[0] < int(window_s * 0.5e9):
            return None
        return oldest

    def _measure(self, obj: Objective, window_s: float, now_ns: int):
        """(measured, burn) for one objective over one window; (None,
        None) when there isn't enough data to judge."""
        if obj.kind == "latency_p99":
            p99 = self._span_p99_ms(obj.source, window_s, now_ns)
            if p99 is None:
                return None, None
            return p99, p99 / obj.target
        if obj.kind == "error_ratio":
            old = self._window_snap(window_s, now_ns)
            if old is None:
                return None, None
            counters = self._tel.counters()
            d_err = counters.get(obj.source, 0) - old[1].get(obj.source, 0)
            d_all = counters.get(obj.denom, 0) - old[1].get(obj.denom, 0)
            if d_all < MIN_EVENTS:
                return None, None
            ratio = d_err / max(1, d_all)
            return ratio, ratio / obj.target
        if obj.kind == "rate_floor":
            old = self._window_snap(window_s, now_ns)
            if old is None:
                return None, None
            counters = self._tel.counters()
            gauges = self._tel.gauges()
            now_v = counters.get(obj.source, gauges.get(obj.source))
            old_v = old[1].get(obj.source, old[2].get(obj.source))
            if now_v is None or old_v is None:
                return None, None
            dt_s = (now_ns - old[0]) / 1e9
            if dt_s <= 0:
                return None, None
            rate = (now_v - old_v) / dt_s * obj.scale
            return rate, obj.target / max(rate, 1e-9)
        if obj.kind == "age_ceiling":
            stamp = self._tel.gauges().get(obj.source)
            if stamp is None:
                return None, None
            age = max(0.0, self._wall() - stamp)
            return age, age / obj.target
        if obj.kind == "gauge_ceiling":
            value = self._tel.gauges().get(obj.source)
            if value is None:
                return None, None
            return float(value), float(value) / obj.target  # sync-ok: host gauge scalar
        if obj.kind == "gauge_floor":
            value = self._tel.gauges().get(obj.source)
            if value is None:
                return None, None
            return float(value), obj.target / max(float(value), 1e-9)  # sync-ok: host gauge scalar
        return None, None

    # -- evaluation --------------------------------------------------------

    def tick(self) -> Dict[str, Dict]:
        """One evaluation pass: snapshot, measure both windows per
        objective, flip burning states, emit gauges + transitions."""
        now_ns = self._clock_ns()
        with self._lock:
            self._snaps.append(
                (now_ns, dict(self._tel.counters()), dict(self._tel.gauges()))
            )
            results: Dict[str, Dict] = {}
            burning_total = 0
            for obj in self.objectives:
                fast_v, fast_b = self._measure(obj, self.fast_s, now_ns)
                slow_v, slow_b = self._measure(obj, self.slow_s, now_ns)
                burning = bool(
                    fast_b is not None
                    and slow_b is not None
                    and fast_b >= 1.0
                    and slow_b >= 1.0
                )
                entry = {
                    "name": obj.name,
                    "kind": obj.kind,
                    "target": obj.target,
                    "measured_fast": fast_v,
                    "measured_slow": slow_v,
                    "burn_fast": fast_b,
                    "burn_slow": slow_b,
                    "burning": burning,
                }
                results[obj.name] = entry
                burning_total += int(burning)
                self._tel.gauge(
                    f"slo/{obj.name}_burn",
                    round(fast_b, 4) if fast_b is not None else 0.0,
                )
                self._tel.gauge(f"slo/{obj.name}_burning", int(burning))
                if burning != self._burning[obj.name]:
                    self._burning[obj.name] = burning
                    self._emit_transition(entry)
            self._tel.gauge("slo/burning_total", burning_total)
            self._last_eval = results
            return results

    def _emit_transition(self, entry: Dict) -> None:
        if not self.jsonl_path:
            return
        from .exporters import rotating_append

        record = {
            "schema_version": SCHEMA_VERSION,
            "run_id": run_id(),
            "t_unix": round(self._wall(), 3),
            "event": "burning" if entry["burning"] else "ok",
            **entry,
        }
        try:
            line = json.dumps(record)
        except (TypeError, ValueError) as e:
            print(
                f"sat_tpu_torch: slo.jsonl record unserializable: {e}",
                file=sys.stderr,
                flush=True,
            )
            return
        rotating_append(self.jsonl_path, line, self.cap_bytes, tel=self._tel)

    # -- read side ---------------------------------------------------------

    def burning(self) -> List[str]:
        """Names of currently-burning objectives (healthz degrades on
        any)."""
        with self._lock:
            return sorted(n for n, b in self._burning.items() if b)

    def snapshot(self) -> Dict[str, Dict]:
        """The most recent evaluation per objective."""
        with self._lock:
            return dict(self._last_eval)

    # -- background thread (Heartbeat-style) -------------------------------

    def start(self, interval_s: float = 5.0) -> "SLOEngine":
        if self._thread is not None or not self.objectives:
            return self
        self._stop.clear()

        def _loop() -> None:
            while not self._stop.wait(interval_s):
                try:
                    self.tick()
                except Exception as e:  # observability never kills the run
                    print(
                        f"sat_tpu_torch: SLO tick failed: {e}",
                        file=sys.stderr,
                        flush=True,
                    )

        self._thread = threading.Thread(target=_loop, name="sat-slo", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None


def objectives_from_config(config, phase: str, tenants=()) -> List[Objective]:
    """The declared objectives for a phase; a target of 0 disables that
    objective (the config default), so a run with no ``slo_*`` settings
    gets an empty list and the engine never starts.

    ``tenants`` (serve phase only) grows the tenant dimension: a
    sequence of ``(name, p99_ms, error_ratio)`` lane targets — one
    burn-rate lane pair per tenant over that tenant's own latency span
    and error-ratio counters (``serve/tenant_<name>_request`` /
    ``_5xx`` / ``_requests``, the per-tenant twins of the serve-wide
    signals, fed by the server's ``_finish_request``).  The multiwindow
    burn math is unchanged; a flooding tenant burns its own lanes while
    everyone else's stay green (the chaos campaign's isolation
    assertion).  Empty for single-tenant serving — no extra lanes."""
    out: List[Objective] = []
    if phase == "serve":
        if config.slo_serve_p99_ms > 0:
            out.append(
                Objective(
                    name="serve_p99_ms",
                    kind="latency_p99",
                    target=config.slo_serve_p99_ms,
                    source="serve/request",
                )
            )
        if config.slo_error_ratio > 0:
            out.append(
                Objective(
                    name="error_ratio",
                    kind="error_ratio",
                    target=config.slo_error_ratio,
                    source="serve/http_5xx",
                    denom="serve/http_requests",
                )
            )
        if config.slo_capacity_headroom_pct > 0:
            # capacity plane (telemetry/capacity.py): burn when the
            # replica's published headroom-% falls below the floor —
            # paging on approach to the ceiling, before latency melts
            out.append(
                Objective(
                    name="capacity_headroom",
                    kind="gauge_floor",
                    target=config.slo_capacity_headroom_pct,
                    source="capacity/headroom_pct",
                )
            )
        if config.slo_quality_psi > 0:
            # quality plane (telemetry/quality.py): burn when the worst
            # per-signal PSI vs the frozen reference stays at/above the
            # ceiling — diagnostic like the tenant lanes (healthz stays
            # "ok"; drift is a model problem, routing away fixes nothing)
            out.append(
                Objective(
                    name="quality_drift",
                    kind="gauge_ceiling",
                    target=config.slo_quality_psi,
                    source="quality/psi_max",
                )
            )
        if config.slo_quality_unk > 0:
            out.append(
                Objective(
                    name="quality_unk",
                    kind="gauge_ceiling",
                    target=config.slo_quality_unk,
                    source="quality/unk_rate",
                )
            )
        for name, p99_ms, error_ratio in tenants:
            if p99_ms > 0:
                out.append(
                    Objective(
                        name=f"tenant_{name}_p99_ms",
                        kind="latency_p99",
                        target=p99_ms,
                        source=f"serve/tenant_{name}_request",
                    )
                )
            if error_ratio > 0:
                out.append(
                    Objective(
                        name=f"tenant_{name}_error_ratio",
                        kind="error_ratio",
                        target=error_ratio,
                        source=f"serve/tenant_{name}_5xx",
                        denom=f"serve/tenant_{name}_requests",
                    )
                )
    elif phase == "canary":
        # the lifecycle controller's qualification objectives: the same
        # targets the serve plane declares, measured over CANARY-slot
        # traffic only (the server records canary requests under their
        # own span/counters), plus the caption-divergence ceiling that
        # p99/error-rate cannot see.  Evaluated by a per-cycle engine
        # whose windows are clipped to the canary window.
        if config.slo_serve_p99_ms > 0:
            out.append(
                Objective(
                    name="canary_p99_ms",
                    kind="latency_p99",
                    target=config.slo_serve_p99_ms,
                    source="serve/canary_request",
                )
            )
        if config.slo_error_ratio > 0:
            out.append(
                Objective(
                    name="canary_error_ratio",
                    kind="error_ratio",
                    target=config.slo_error_ratio,
                    source="serve/canary_5xx",
                    denom="serve/canary_requests",
                )
            )
        if config.canary_divergence_max > 0:
            out.append(
                Objective(
                    name="canary_divergence",
                    kind="gauge_ceiling",
                    target=config.canary_divergence_max,
                    source="lifecycle/caption_divergence",
                )
            )
    elif phase == "train":
        if config.slo_captions_per_s > 0:
            out.append(
                Objective(
                    name="captions_per_s",
                    kind="rate_floor",
                    target=config.slo_captions_per_s,
                    source="train/step",
                    scale=config.batch_size,
                )
            )
        if config.slo_ckpt_age_s > 0:
            out.append(
                Objective(
                    name="ckpt_age_s",
                    kind="age_ceiling",
                    target=config.slo_ckpt_age_s,
                    source="ckpt/last_save_unix",
                )
            )
        if config.fleet_telemetry:
            # the fleet plane publishes worst-host-p95 / fleet-median as
            # fleet/step_p95_skew; sustained skew at/above the straggler
            # factor is exactly the verdict condition, so it pages too
            out.append(
                Objective(
                    name="fleet_step_skew",
                    kind="gauge_ceiling",
                    target=config.straggler_factor,
                    source="fleet/step_p95_skew",
                )
            )
    return out
