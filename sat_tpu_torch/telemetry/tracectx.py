"""Request-scoped tracing — the port's copy of ``sat_tpu.telemetry.tracectx``.

The span layer sees the *process*: aggregate p50/p95/p99 over every
request that ever ran.  This module sees one *request*: a trace id minted
at the HTTP boundary (honoring an inbound ``X-Request-Id`` so a client or
an upstream proxy can correlate), carried on the batcher's ``Request``
through admission → batch forming → dispatch → drain → detok, with each
phase stamped as a ``(t0_ns, dur_ns)`` interval on the same
``perf_counter_ns`` clock the telemetry ring uses.  Three outputs:

* ``access.jsonl`` — one line per terminal reply (success AND sheds),
  size-capped through :func:`exporters.rotating_append`, holding the
  trace id, status, bucket, tenant, total latency, the attributed device
  cost (``metering``) and all five phase timings;
* Chrome-trace child spans — :meth:`RequestTracer.trace_events` renders
  each retained request as its own named lane;
* the completed-trace ring itself (bounded, ``keep`` most recent).

Sync-free: every timestamp is host time the serve path already takes.
All writers degrade on failure — tracing never fails a request.
"""

from __future__ import annotations

import re
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from . import run_id

# the correlation header, honored inbound and echoed on EVERY reply
# (including 400/429/503/504 sheds — clients correlate rejects too)
TRACE_HEADER = "X-Request-Id"

# the five per-request phases, in causal order (docs/OBSERVABILITY.md):
# queue_wait   submit -> popped from the admission queue
# batch_form   popped -> the batch's dispatch boundary (held open for
#              riders up to serve_max_wait_ms)
# dispatch     pad-to-bucket + AOT executable launch (async)
# drain        host<->device sync waiting on the batch's device results
# detok        host detokenize of the drained arrays
PHASES = ("queue_wait", "batch_form", "dispatch", "drain", "detok")

# inbound ids are sanitized, not trusted: header-safe charset, bounded
_ID_RE = re.compile(r"[^A-Za-z0-9_.:\-]")
_MAX_ID_LEN = 128

# synthetic Perfetto lane ids for request tracks, far above any real
# thread ident's low bits so lanes never collide with host-thread tracks
_LANE_BASE = 1 << 20


def mint_trace_id() -> str:
    """A fresh 16-hex-char request id (uuid4 entropy, log-friendly)."""
    return uuid.uuid4().hex[:16]


def ensure_id(raw: Optional[str]) -> str:
    """The id a reply must echo: the inbound header value when one came
    (sanitized to a header-safe charset, length-bounded), minted fresh
    otherwise."""
    if raw is None:
        return mint_trace_id()
    cleaned = _ID_RE.sub("", raw.strip())[:_MAX_ID_LEN]
    return cleaned if cleaned else mint_trace_id()


class RequestTrace:
    """One request's id + phase intervals.

    Phases are marked from the batcher thread (strictly ordered), and
    :meth:`RequestTracer.finish` reads them from the HTTP thread only
    after the request's ``done`` event fired — the Event is the
    happens-before edge, so no lock is needed."""

    __slots__ = ("trace_id", "t_start_ns", "phases")

    def __init__(self, trace_id: str, t_start_ns: Optional[int] = None) -> None:
        self.trace_id = trace_id
        self.t_start_ns = (
            t_start_ns if t_start_ns is not None else time.perf_counter_ns()
        )
        self.phases: Dict[str, Tuple[int, int]] = {}

    def mark(self, phase: str, t0_ns: int, dur_ns: int) -> None:
        """Stamp one phase interval (last write wins; phases fire once
        per request on the happy path)."""
        self.phases[phase] = (t0_ns, max(0, dur_ns))

    def phase_ms(self) -> Dict[str, float]:
        """All five phase durations in ms, absent phases as 0.0 — the
        access-log contract is that every record carries every phase."""
        return {
            f"{name}_ms": round(self.phases.get(name, (0, 0))[1] / 1e6, 3)
            for name in PHASES
        }


class RequestTracer:
    """Mints traces, writes ``access.jsonl``, retains finished traces.

    ``path`` empty disables the access log (traces still retain for the
    Perfetto export); ``cap_bytes`` 0 disables rotation."""

    def __init__(self, path: str = "", cap_bytes: int = 0, keep: int = 256) -> None:
        self.path = path
        self.cap_bytes = int(cap_bytes)
        self._lock = threading.Lock()
        self._finished: "deque" = deque(maxlen=max(1, int(keep)))
        self._seq = 0

    # -- request lifecycle -------------------------------------------------

    def begin(self, raw_header: Optional[str] = None) -> RequestTrace:
        return RequestTrace(ensure_id(raw_header))

    def finish(
        self,
        trace: RequestTrace,
        status: int,
        total_ns: int,
        bucket: Optional[int] = None,
        error: Optional[str] = None,
        tenant: Optional[str] = None,
        cost: Optional[Any] = None,
    ) -> Dict[str, Any]:
        """Record the terminal reply: one access.jsonl line + retention.
        ``tenant`` stamps the submitting tenant (per-tenant log filtering
        and Perfetto lane args); ``cost`` is the request's attributed
        device cost (a ``metering.RequestCost`` — its ms view lands as a
        ``cost`` sub-object).  Returns the record (tests and callers read
        it back); never raises — a failed append degrades inside
        ``rotating_append``."""
        record: Dict[str, Any] = {
            "run_id": run_id(),
            "trace_id": trace.trace_id,
            "wall_time": round(time.time(), 6),
            "status": int(status),
            "total_ms": round(max(0, total_ns) / 1e6, 3),
            "phases": trace.phase_ms(),
        }
        if bucket is not None:
            record["bucket"] = int(bucket)
        if tenant is not None:
            record["tenant"] = str(tenant)
        if cost is not None:
            record["cost"] = cost.as_dict()
        if error:
            record["error"] = error
        with self._lock:
            self._seq += 1
            self._finished.append((self._seq, trace, record))
        if self.path:
            import json

            from .exporters import rotating_append

            rotating_append(self.path, json.dumps(record), self.cap_bytes)
        return record

    # -- read side ---------------------------------------------------------

    def finished(self) -> List[Dict[str, Any]]:
        """The retained access records, oldest first."""
        with self._lock:
            return [rec for _, _, rec in self._finished]

    def trace_events(self, anchor_ns: int, pid: int = 0) -> List[Dict]:
        """Chrome trace events for the retained requests: one lane per
        request (synthetic tid + thread_name metadata), a whole-request
        parent span, and one child span per recorded phase — merged into
        the process trace via ``exporters.chrome_trace(extra_events=…)``.
        """
        events: List[Dict] = []
        with self._lock:
            entries = list(self._finished)
        for seq, trace, record in entries:
            tid = _LANE_BASE + seq
            events.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": pid,
                    "tid": tid,
                    "args": {"name": f"request {trace.trace_id}"},
                }
            )
            events.append(
                {
                    "name": f"request {trace.trace_id}",
                    "cat": "request",
                    "ph": "X",
                    "pid": pid,
                    "tid": tid,
                    "ts": (trace.t_start_ns - anchor_ns) / 1e3,
                    "dur": record["total_ms"] * 1e3,
                    "args": {
                        "trace_id": trace.trace_id,
                        "status": record["status"],
                        "bucket": record.get("bucket"),
                        # tenant + attributed cost ride the lane args so
                        # Perfetto queries can filter/aggregate by tenant
                        "tenant": record.get("tenant"),
                        "cost": record.get("cost"),
                    },
                }
            )
            for phase, (t0, dur) in trace.phases.items():
                events.append(
                    {
                        "name": phase,
                        "cat": "request",
                        "ph": "X",
                        "pid": pid,
                        "tid": tid,
                        "ts": (t0 - anchor_ns) / 1e3,
                        "dur": dur / 1e3,
                        "args": {"trace_id": trace.trace_id},
                    }
                )
        return events
