"""Host-side span/counter/gauge recording on preallocated ring buffers —
the port's copy of ``sat_tpu.telemetry.spans``.

``torch.profiler`` answers "what did the device do for these steps";
this module answers "where did the HOST milliseconds of the whole run
go" — cheaply enough to leave on for every step of every run.  Three
primitives:

* **span** — a named wall-clock interval (``time.perf_counter_ns``)
  recorded into preallocated numpy ring buffers.  The hot path takes no
  lock: a slot index comes from ``itertools.count`` (``next()`` on it is
  a single C-level operation, atomic under the GIL, so producer threads
  — prefetch, checkpoint writer — never tear each other's slots) and the
  per-name aggregates are monotonic accumulators where a lost race costs
  one sample of statistics, never a crash or a corrupt trace.
* **counter** — a monotonically increasing named count (retry attempts,
  decode fallbacks, quarantined rows).
* **gauge** — a last-value-wins named measurement (prefetch queue depth,
  bulk progress).

Counters and gauges take a small lock — they are called per *event*
(a retry, a shard boundary), not per microsecond, so contention is nil.

The module-level API (``span``/``count``/``gauge``/``record``) dispatches
through a process-global implementation that defaults to
:data:`NULL_TELEMETRY` — a no-op object whose methods cost one attribute
lookup and one call (~0.1 µs), so instrumented library code (shards,
retry, quarantine) pays nothing measurable when telemetry is off, and
recording never adds a device sync.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

# Span names are interned to small integer ids; aggregate arrays are sized
# in blocks of this many names (a run uses a few dozen distinct names).
_NAME_BLOCK = 256


class _NullSpan:
    """Context manager that does nothing — the telemetry-off span."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = _NullSpan()


class NullTelemetry:
    """The telemetry-off implementation: every method is a no-op returning
    an inert value, so call sites never branch on enablement."""

    enabled = False

    def span(self, name: str) -> _NullSpan:
        return NULL_SPAN

    def record(self, name: str, t0_ns: int, dur_ns: int) -> None:
        pass

    def count(self, name: str, n: int = 1) -> None:
        pass

    def gauge(self, name: str, value: float) -> None:
        pass

    def counters(self) -> Dict[str, float]:
        return {}

    def gauges(self) -> Dict[str, float]:
        return {}

    def aggregates(self) -> Dict[str, Tuple[int, int, int]]:
        return {}

    def durations_ns(self, name: str) -> np.ndarray:
        return np.empty(0, np.int64)

    def spans_snapshot(self):
        return [], *(np.empty(0, d) for d in (np.int32, np.int64, np.int64, np.int64))


NULL_TELEMETRY = NullTelemetry()


class _Span(object):
    """One timed interval; created per use (re-entrant and thread-safe by
    construction — no shared mutable timing state)."""

    __slots__ = ("_tel", "_sid", "_t0")

    def __init__(self, tel: "Telemetry", sid: int) -> None:
        self._tel = tel
        self._sid = sid

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t0 = self._t0
        self._tel._record(self._sid, t0, time.perf_counter_ns() - t0)
        return False


class Telemetry:
    """Ring-buffered span recorder + counter/gauge registry.

    ``capacity`` (rounded up to a power of two) bounds the sample window:
    older spans are overwritten, but the per-name aggregates (count /
    total / max) accumulate for the whole run, so end-of-run totals are
    exact even when the ring wrapped; only the percentile window is
    bounded.
    """

    enabled = True

    def __init__(self, capacity: int = 65536) -> None:
        cap = 1 << max(int(capacity) - 1, 255).bit_length()  # pow2, >= 256
        self._capacity = cap
        self._mask = cap - 1
        self._ids = np.zeros(cap, np.int32)
        self._t0s = np.zeros(cap, np.int64)
        self._durs = np.zeros(cap, np.int64)
        self._tids = np.zeros(cap, np.int64)
        self._slot = itertools.count()
        self._written = 0  # approximate under racing writers; exact enough
        self._names: Dict[str, int] = {}
        self._name_list: List[str] = []
        self._name_lock = threading.Lock()
        self._agg_count = np.zeros(_NAME_BLOCK, np.int64)
        self._agg_total = np.zeros(_NAME_BLOCK, np.int64)
        self._agg_max = np.zeros(_NAME_BLOCK, np.int64)
        self._meta_lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        # Anchors pairing the monotonic span clock with wall time, so
        # exporters can place trace events on an absolute timeline.
        self.anchor_ns = time.perf_counter_ns()
        self.anchor_unix = time.time()

    # -- hot path ----------------------------------------------------------

    def span(self, name: str) -> _Span:
        sid = self._names.get(name)
        if sid is None:
            sid = self._intern(name)
        return _Span(self, sid)

    def record(self, name: str, t0_ns: int, dur_ns: int) -> None:
        """Record a manually timed interval (loop bodies that can't wrap a
        ``with`` around their own ``for``-statement fetch)."""
        sid = self._names.get(name)
        if sid is None:
            sid = self._intern(name)
        self._record(sid, t0_ns, dur_ns)

    def _record(self, sid: int, t0_ns: int, dur_ns: int) -> None:
        i = next(self._slot)          # lock-free slot reservation
        j = i & self._mask
        self._ids[j] = sid
        self._t0s[j] = t0_ns
        self._durs[j] = dur_ns
        self._tids[j] = threading.get_ident()
        self._written = i + 1
        # racing writers may drop one aggregate update; the ring row above
        # is slot-exclusive and never torn
        self._agg_count[sid] += 1
        self._agg_total[sid] += dur_ns
        if dur_ns > self._agg_max[sid]:
            self._agg_max[sid] = dur_ns

    def _intern(self, name: str) -> int:
        with self._name_lock:
            sid = self._names.get(name)
            if sid is None:
                sid = len(self._name_list)
                if sid >= len(self._agg_count):
                    grow = len(self._agg_count) + _NAME_BLOCK
                    for attr in ("_agg_count", "_agg_total", "_agg_max"):
                        old = getattr(self, attr)
                        new = np.zeros(grow, np.int64)
                        new[: len(old)] = old
                        setattr(self, attr, new)
                self._name_list.append(name)
                self._names[name] = sid
            return sid

    # -- events ------------------------------------------------------------

    def count(self, name: str, n: int = 1) -> None:
        with self._meta_lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        with self._meta_lock:
            self._gauges[name] = value

    # -- read side (exporters; never on the hot path) ----------------------

    def counters(self) -> Dict[str, float]:
        with self._meta_lock:
            return dict(self._counters)

    def gauges(self) -> Dict[str, float]:
        with self._meta_lock:
            return dict(self._gauges)

    def aggregates(self) -> Dict[str, Tuple[int, int, int]]:
        """{name: (count, total_ns, max_ns)} over the whole run."""
        out = {}
        for name, sid in list(self._names.items()):
            c = int(self._agg_count[sid])
            if c:
                out[name] = (c, int(self._agg_total[sid]), int(self._agg_max[sid]))
        return out

    def _window(self) -> np.ndarray:
        """Ring indices of the retained sample window, oldest first."""
        n = self._written
        if n <= self._capacity:
            return np.arange(n)
        start = n & self._mask
        return (np.arange(self._capacity) + start) & self._mask

    def durations_ns(self, name: str) -> np.ndarray:
        """Sampled durations for ``name`` within the ring window (the
        percentile source; totals come from :meth:`aggregates`)."""
        sid = self._names.get(name)
        if sid is None:
            return np.empty(0, np.int64)
        idx = self._window()
        return self._durs[idx][self._ids[idx] == sid]

    def spans_snapshot(self):
        """(names, ids, t0s, durs, tids) — the retained window in
        chronological order; ``names[ids[k]]`` is span k's name."""
        idx = self._window()
        with self._name_lock:
            names = list(self._name_list)
        return (
            names,
            self._ids[idx].copy(),
            self._t0s[idx].copy(),
            self._durs[idx].copy(),
            self._tids[idx].copy(),
        )


# ---------------------------------------------------------------------------
# process-global dispatch
# ---------------------------------------------------------------------------

_impl = NULL_TELEMETRY


def get():
    """The active implementation (hot loops grab this once per loop)."""
    return _impl


def enabled() -> bool:
    return _impl.enabled


def enable(capacity: int = 65536) -> Telemetry:
    """Install a FRESH enabled implementation (one per run: buffers and
    counters start empty) and return it."""
    global _impl
    _impl = Telemetry(capacity)
    return _impl


def disable() -> NullTelemetry:
    global _impl
    _impl = NULL_TELEMETRY
    return _impl


def span(name: str):
    return _impl.span(name)


def record(name: str, t0_ns: int, dur_ns: int) -> None:
    _impl.record(name, t0_ns, dur_ns)


def count(name: str, n: int = 1) -> None:
    _impl.count(name, n)


def gauge(name: str, value: float) -> None:
    _impl.gauge(name, value)
