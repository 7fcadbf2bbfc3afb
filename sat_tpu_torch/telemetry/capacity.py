"""Online capacity model and encode-cache opportunity probe — the port's
copy of ``sat_tpu.telemetry.capacity``.

Built on the metering ledger's feeds (occupancy-ms, request counts) and
the serve spans the batcher records (steps per dispatch, encode-lane
geometry), it answers two questions no raw counter does:

* **How close to the ceiling is this replica?**  The effective
  captions/s ceiling is ``slots / mean_occupancy_s`` at the current
  traffic mix; headroom is the unused fraction of slot capacity, and the
  SLO engine can burn on it (the ``capacity_headroom`` objective).
* **Would an encode cache pay for itself?**  A keyed sliding sketch
  measures the would-be hit ratio of a bounded encode cache on live
  traffic; no pixels are retained.  With ``encode_cache="on"`` the
  server passes the real cache, whose measured hit ratio is published
  beside the sketch's prediction.

Everything here is host arithmetic over numbers already collected:
``maybe_update`` is rate-limited (once per ``interval_s``, except the
first publish) and called from boundaries that already run per request
or per scrape.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, Optional


class EncodeCacheSketch(object):
    """Sliding-window membership sketch over request image keys.

    ``observe(key)`` reports whether the key was seen within the last
    ``window`` observations — exactly the hit a ``window``-entry LRU-ish
    encode cache would have scored.  O(1) per observation: a deque for
    recency eviction plus a refcount dict for membership (the same key
    may appear several times inside one window)."""

    def __init__(self, window: int = 4096) -> None:
        self._window = max(int(window), 1)
        self._ring: collections.deque = collections.deque()
        self._counts: Dict[int, int] = {}
        self._lock = threading.Lock()
        self.lookups = 0
        self.hits = 0

    def observe(self, key: int) -> bool:
        """Record one request's image key; True when a cache of this
        window size would have hit."""
        with self._lock:
            self.lookups += 1
            hit = key in self._counts
            if hit:
                self.hits += 1
            self._ring.append(key)
            self._counts[key] = self._counts.get(key, 0) + 1
            if len(self._ring) > self._window:
                old = self._ring.popleft()
                left = self._counts[old] - 1
                if left:
                    self._counts[old] = left
                else:
                    del self._counts[old]
            return hit

    def ratio(self) -> float:
        with self._lock:
            return self.hits / self.lookups if self.lookups else 0.0


class CapacityModel(object):
    """Windowed capacity gauges from ledger totals + span aggregates.

    Keeps the previous cumulative snapshot and differences against it on
    each (rate-limited) update, so every gauge reflects the LAST window
    of real traffic, not the lifetime average — a replica that was busy
    an hour ago but idle now shows full headroom."""

    def __init__(
        self,
        tel,
        ledger,
        slots: int,
        interval_s: float = 1.0,
        sketch: Optional[EncodeCacheSketch] = None,
        cache=None,
        clock=time.monotonic,
    ) -> None:
        self._tel = tel
        self._ledger = ledger
        self._slots = max(int(slots), 1)
        self._interval = float(interval_s)
        self._sketch = sketch
        # the real EncodeCache (when --encode_cache on): its measured hit
        # ratio closes the loop on the sketch's would-hit prediction
        self._cache = cache
        self._clock = clock
        self._lock = threading.Lock()
        self._t_last = clock()
        # previous cumulative readings (requests, occupancy_ms,
        # steps-per-dispatch count/total, lane images/slots)
        self._prev = dict.fromkeys(
            ("req", "occ_ms", "spd_n", "spd_tot", "lane_img", "lane_slot"),
            0.0,
        )
        self._ceiling = 0.0  # last known, held across idle windows
        self._published = False  # first publish bypasses the rate limit

    def _cumulative(self) -> Dict[str, float]:
        snap = self._ledger.snapshot() if self._ledger is not None else {}
        req = sum(r["requests"] for r in snap.values())
        occ = sum(r["occupancy_ms"] for r in snap.values())
        agg = self._tel.aggregates()
        spd = agg.get("serve/steps_per_dispatch", (0, 0, 0))
        ctr = self._tel.counters()
        return {
            "req": float(req),
            "occ_ms": float(occ),
            # record() stores raw step counts in the duration slot, so
            # total "ns" here is total steps and count is dispatches
            "spd_n": float(spd[0]),
            "spd_tot": float(spd[1]),
            "lane_img": float(ctr.get("serve/encode_images", 0.0)),
            "lane_slot": float(ctr.get("serve/encode_lane_slots", 0.0)),
        }

    def maybe_update(self, force: bool = False) -> None:
        """Recompute and publish the capacity gauges, at most once per
        ``interval_s`` (call freely from request funnels and scrape
        paths; off-interval calls cost one clock read)."""
        now = self._clock()
        with self._lock:
            window_s = now - self._t_last
            if not force and self._published and window_s < self._interval:
                # Rate-limited — except the very first publish, which must
                # not race the interval: a scrape that lands before any
                # update would otherwise see an empty capacity block.
                return
            self._t_last = now
            cur = self._cumulative()
            prev, self._prev = self._prev, cur
        if window_s <= 0:
            return
        d_req = cur["req"] - prev["req"]
        d_occ_s = (cur["occ_ms"] - prev["occ_ms"]) / 1e3
        # Occupancy is credited at retire, so a window can momentarily
        # absorb more occupancy-seconds than it spans; clamp to [0, 1].
        busy = min(max(d_occ_s / (self._slots * window_s), 0.0), 1.0)
        if d_req > 0 and d_occ_s > 0:
            self._ceiling = self._slots * d_req / d_occ_s
        tel = self._tel
        self._published = True
        tel.gauge("capacity/slot_busy_ratio", round(busy, 4))
        tel.gauge("capacity/headroom_pct", round(100.0 * (1.0 - busy), 2))
        tel.gauge("capacity/ceiling_captions_per_s", round(self._ceiling, 3))
        tel.gauge(
            "capacity/completed_per_s",
            round(d_req / window_s, 3) if d_req > 0 else 0.0,
        )
        d_disp = cur["spd_n"] - prev["spd_n"]
        if d_disp > 0:
            tel.gauge(
                "capacity/steps_per_dispatch",
                round((cur["spd_tot"] - prev["spd_tot"]) / d_disp, 3),
            )
        d_slot = cur["lane_slot"] - prev["lane_slot"]
        if d_slot > 0:
            tel.gauge(
                "capacity/encode_lane_fill",
                round((cur["lane_img"] - prev["lane_img"]) / d_slot, 4),
            )
        if self._sketch is not None and self._sketch.lookups:
            tel.gauge(
                "capacity/encode_cache_would_hit_ratio",
                round(self._sketch.ratio(), 4),
            )
        if self._cache is not None and self._cache.lookups:
            actual = self._cache.hit_ratio()
            tel.gauge("capacity/encode_cache_hit_ratio", round(actual, 4))
            if self._sketch is not None and self._sketch.lookups:
                # prediction-vs-reality residual: positive means the sketch
                # over-promised (e.g. its window outlives the real ring)
                tel.gauge(
                    "capacity/encode_cache_reconcile_delta",
                    round(self._sketch.ratio() - actual, 4),
                )
