"""Per-request device-cost attribution and per-tenant metering — the
port's copy of ``sat_tpu.telemetry.metering``.

Shared device work makes "what does a request cost" a matter of
*attribution*: encode lanes batch several requests into one dispatch, a
fused decode window advances every live slot at once, and a batch-mode
dispatch decodes a whole padded bucket.  The rules:

* **encode** — each request in an encode chunk is charged an equal share
  of that chunk's measured device window (``dur / chunk_len``; padded
  lane rows bill nobody and feed the lane-fill gauge);
* **decode** — each *live* request riding a decode window (a fused
  continuous window, or a batch-mode dispatch's search and drain) is
  charged an equal share of it;
* **occupancy** — admission→retire wall time: how long the request held
  its slot (beam state, contexts);
* **queue / detok** — host phases, lifted from the request's trace.

Every charge happens at a host boundary that is already synced and
telemetry-gated, so metering adds no device sync.  The per-tenant
roll-up lands in a torn-tolerant ``metering.jsonl`` ledger (cumulative
rows through ``rotating_append``; readers keep the last parseable row
per tenant), the server's ``/stats`` ``tenants_cost`` block, and float
counters ``promtext`` exports on ``/metrics``.

:data:`BUSY_SPANS` and :func:`measured_busy_ms` are the other side of
the accounting identity: the span totals that ARE the measured device
windows the attribution splits.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional

from .exporters import rotating_append, run_id

# Ledger rows are cumulative snapshots, not deltas: replaying a ledger
# needs only the LAST full row per tenant, so a torn tail (kill -9 mid
# append) costs one snapshot of staleness, never a double-count.
LEDGER_SCHEMA = 1

# Cost fields accumulated per tenant, in the order /stats reports them.
_FIELDS = (
    "requests",
    "errors",
    "encode_ms",
    "decode_ms",
    "device_ms",
    "occupancy_ms",
    "queue_ms",
    "detok_ms",
    "decode_steps",
    "dispatches",
)


class RequestCost(object):
    """Mutable per-request cost accumulator, attached to a request at
    submit and charged to its tenant at the terminal funnel.

    Attribution sites mutate it via plain adds on already-synced,
    telemetry-gated boundaries (slot_pool encode chunks, batcher decode
    windows) — no locks: a request's cost is only ever touched by the
    single thread driving its current phase."""

    __slots__ = (
        "encode_ns",
        "decode_ns",
        "occupancy_ns",
        "decode_steps",
        "dispatches",
    )

    def __init__(self) -> None:
        self.encode_ns = 0
        self.decode_ns = 0
        self.occupancy_ns = 0
        self.decode_steps = 0
        self.dispatches = 0

    def add_encode(self, dur_ns: int) -> None:
        self.encode_ns += int(dur_ns)

    def add_decode(self, dur_ns: int, steps: int = 0) -> None:
        self.decode_ns += int(dur_ns)
        self.decode_steps += int(steps)
        self.dispatches += 1

    def set_occupancy(self, dur_ns: int) -> None:
        self.occupancy_ns = int(dur_ns)

    @property
    def device_ns(self) -> int:
        return self.encode_ns + self.decode_ns

    def as_dict(self) -> Dict[str, float]:
        """ms-denominated view for access.jsonl / API responses."""
        return {
            "encode_ms": round(self.encode_ns / 1e6, 4),
            "decode_ms": round(self.decode_ns / 1e6, 4),
            "device_ms": round(self.device_ns / 1e6, 4),
            "occupancy_ms": round(self.occupancy_ns / 1e6, 3),
            "decode_steps": int(self.decode_steps),
            "dispatches": int(self.dispatches),
        }


class MeteringLedger(object):
    """Per-tenant cost roll-up + torn-tolerant JSONL sink.

    ``charge()`` is called once per request from the server's terminal
    funnel — a dict update under one small lock (the same cost profile
    as a telemetry counter tick), then a rate-limited flush: at most one
    ledger append burst per ``flush_interval_s``, so the sink costs
    nothing measurable per request."""

    def __init__(
        self,
        path: str = "",
        cap_bytes: int = 0,
        tel=None,
        flush_interval_s: float = 5.0,
        clock=time.monotonic,
    ) -> None:
        self._path = path
        self._cap_bytes = int(cap_bytes)
        self._tel = tel
        self._interval = float(flush_interval_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._tenants: Dict[str, Dict[str, float]] = {}
        self._t_flush = clock()
        self._dirty = False

    # -- write side --------------------------------------------------------

    def charge(
        self,
        tenant: str,
        cost: Optional[RequestCost] = None,
        queue_ms: float = 0.0,
        detok_ms: float = 0.0,
        error: bool = False,
    ) -> None:
        """Fold one finished request into its tenant's totals."""
        t = tenant or "default"
        enc = cost.encode_ns / 1e6 if cost is not None else 0.0
        dec = cost.decode_ns / 1e6 if cost is not None else 0.0
        occ = cost.occupancy_ns / 1e6 if cost is not None else 0.0
        with self._lock:
            row = self._tenants.get(t)
            if row is None:
                row = self._tenants[t] = dict.fromkeys(_FIELDS, 0.0)
            row["requests"] += 1
            row["errors"] += 1 if error else 0
            row["encode_ms"] += enc
            row["decode_ms"] += dec
            row["device_ms"] += enc + dec
            row["occupancy_ms"] += occ
            row["queue_ms"] += float(queue_ms)
            row["detok_ms"] += float(detok_ms)
            if cost is not None:
                row["decode_steps"] += cost.decode_steps
                row["dispatches"] += cost.dispatches
            self._dirty = True
        if self._tel is not None and self._tel.enabled:
            # Float counters ride the existing promtext export, so every
            # tenant's cumulative cost appears on /metrics with no new
            # exposition machinery (dimension-on-the-name, house style).
            self._tel.count("metering/%s/requests" % t)
            self._tel.count("metering/%s/device_ms" % t, enc + dec)
            self._tel.count("metering/%s/occupancy_ms" % t, occ)
        self.maybe_flush()

    def maybe_flush(self, force: bool = False) -> None:
        """Append one cumulative row per tenant, at most once per
        interval.  Failures degrade inside ``rotating_append``."""
        if not self._path:
            return
        now = self._clock()
        with self._lock:
            if not self._dirty:
                return
            if not force and now - self._t_flush < self._interval:
                return
            self._t_flush = now
            self._dirty = False
            rows = [
                dict(v, tenant=k, schema=LEDGER_SCHEMA, run_id=run_id(),
                     wall_time=round(time.time(), 3))
                for k, v in sorted(self._tenants.items())
            ]
        for row in rows:
            rotating_append(
                self._path, json.dumps(row), self._cap_bytes, tel=self._tel
            )

    # -- read side ---------------------------------------------------------

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """{tenant: totals} with ms fields rounded — the /stats block."""
        with self._lock:
            out = {}
            for t, row in sorted(self._tenants.items()):
                out[t] = {
                    k: (round(v, 3) if k.endswith("_ms") else int(v))
                    for k, v in row.items()
                }
            return out

    def attributed_device_ms(self) -> float:
        """Sum of encode+decode ms attributed across all tenants — the
        left side of the accounting identity."""
        with self._lock:
            return sum(r["device_ms"] for r in self._tenants.values())


def read_ledger(path: str) -> List[Dict]:
    """Parse a metering ledger, torn-tail tolerant: unparsable lines
    (a half-written tail after kill -9, a corrupted block) are skipped,
    never fatal.  Reads the single ``.1`` rollover first so rows come
    back oldest-first across the rotation boundary."""
    rows: List[Dict] = []
    for p in (path + ".1", path):
        try:
            with open(p) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        row = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(row, dict) and "tenant" in row:
                        rows.append(row)
        except OSError:
            continue
    return rows


def latest_totals(rows: List[Dict]) -> Dict[str, Dict]:
    """Last full cumulative row per tenant — how a billing job replays
    the ledger (later rows supersede earlier ones, so a dropped tail
    only loses recency, never correctness)."""
    out: Dict[str, Dict] = {}
    for row in rows:
        out[str(row["tenant"])] = row
    return out


# Span names whose aggregate totals ARE the measured device-busy windows
# the attributor splits: continuous mode records serve/encode per lane
# chunk and serve/step per fused window; batch mode records serve/encode
# per dispatch and serve/decode_window per drained batch.  Only one mode
# runs per server, so summing all three never double-counts.
BUSY_SPANS = ("serve/encode", "serve/step", "serve/decode_window")


def measured_busy_ms(tel) -> float:
    """Engine busy time (ms) from span aggregates — the right side of
    the accounting identity (attributed ≈ measured within ±5%)."""
    agg = tel.aggregates()
    return sum(agg[n][1] / 1e6 for n in BUSY_SPANS if n in agg)
