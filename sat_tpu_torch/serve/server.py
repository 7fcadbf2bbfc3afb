"""HTTP frontend for the captioning service — the port of ``sat_tpu.serve.server``.

A stdlib ``ThreadingHTTPServer``: request threads decode the image and
park on an Event while the batcher owns the device.

Endpoints:

* ``POST /caption`` — body: image bytes (JPEG/PNG).  200 →
  ``{"captions": [{"caption", "log_prob", "prob"}, ...beam-ordered],
  "bucket", "slot", "model_step", "request_id"}``, the JAX server's
  payload (``bucket`` is the page width in continuous mode).  400 for an
  empty or undecodable body, 429 when the queue is full, 500 when the
  batch wedged, 503 while draining, 504 past the deadline
  (``X-Deadline-Ms`` or ``serve_deadline_ms``).
* ``GET /healthz`` — readiness plus the heartbeat payload: 200 "ok",
  503 "degraded" (a wedged batch being re-warmed, or a burning SLO),
  "draining" or "stopped".  The top-level load signals a router polls:
  ``queue_depth``, ``in_flight``, ``serve_mode``, ``tier``, ``buckets``.
* ``GET /stats`` — queue depth, bucket histogram, the ``serve/``
  counters, p50/p95/p99 per serve span, the SLO verdicts, profile
  captures, per-tenant cost and the capacity gauges; ``fused_attend``
  launches and the device (port only); in continuous mode a
  ``slot_pool`` block.
* ``GET /metrics`` — Prometheus text (``telemetry.promtext``).
* ``POST /profile?duration_ms=N`` — a bounded live ``torch.profiler``
  capture into ``<telemetry_dir>/profiles/<ts>/``; 409 while another
  runs, 400 for a duration that is not an integer.

Every reply echoes ``X-Request-Id`` (the inbound value sanitized, or
minted), and each ``POST /caption`` is traced per phase into
``access.jsonl`` and its own Perfetto lane (``--trace_export``).  The
heartbeat writes ``heartbeat.json`` every ``heartbeat_interval``
seconds, the metering ledger ``metering.jsonl`` (``serve_metering``),
the SLO engine ``slo.jsonl`` when an ``slo_*`` objective is set.  With
``serve_wedge_timeout_ms`` > 0 a batch the card never finishes fails
fast with 500s, health flips to "degraded", the engine re-warms, and
health comes back "ok".  The XLA compile fields of the JAX server's
``/stats`` (``warm_compiles``, ``compiles_since_ready``) have no
counterpart: nothing is compiled ahead here.

``serve_mode="batch"`` dispatches whole padded batches
(:class:`MicroBatcher`); ``"continuous"`` seeds requests into a
:class:`PagedSlotPool` between fused decode windows
(:class:`ContinuousBatcher`).

Shutdown: SIGTERM/SIGINT (through ``resilience.preempt.GracefulShutdown``)
or ``request_shutdown()`` flips readiness, drains the batcher, closes the
listener, stops the SLO engine and any capture, flushes the ledger,
writes the trace, then stops the heartbeat.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import urllib.parse
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

import numpy as np

from .. import telemetry
from ..config import Config
from ..data.vocabulary import Vocabulary
from ..ops.fused_attend import fused_attend
from ..resilience.preempt import GracefulShutdown
from ..telemetry import promtext, tracectx
from ..telemetry.capacity import CapacityModel, EncodeCacheSketch
from ..telemetry.heartbeat import Heartbeat
from ..telemetry.metering import MeteringLedger
from ..telemetry.profwin import ProfileLatch
from ..telemetry.slo import SLOEngine, objectives_from_config
from .batcher import ContinuousBatcher, MicroBatcher, Rejected
from .engine import ServeEngine, check_ported, load_serving_state
from .slot_pool import PagedSlotPool

_LATENCY_SPANS = (
    "serve/request",
    "serve/queue_wait",
    "serve/preprocess",
    "serve/dispatch",
    "serve/step",
    "serve/detok_queue",
    "serve/detok",
)

# /metrics histogram families: cumulative _bucket/_sum/_count beside the
# percentile gauges.  Latency bounds in seconds; steps per dispatch in
# raw counts matching the fused window's K ladder.
_HISTOGRAMS: Dict[str, promtext.HistogramSpec] = {
    "sat_request_latency_seconds": (
        "serve/request",
        (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0),
        1e-9,
    ),
    "sat_steps_per_dispatch": (
        "serve/steps_per_dispatch",
        (1.0, 2.0, 4.0, 8.0, 16.0, 32.0),
        1.0,
    ),
}

# the one param slot until the lifecycle plane is ported
_INCUMBENT = "incumbent"


def telemetry_dir(config: Config) -> str:
    return config.telemetry_dir or os.path.join(config.summary_dir, "telemetry")


def _percentiles(tel, name: str, scale: float) -> Optional[Dict[str, Any]]:
    """p50/p95/p99 of a span's recorded values times ``scale`` (1e-6 for
    ns → ms, 1.0 for spans that store raw counts); None when empty."""
    data = np.asarray(tel.durations_ns(name), np.float64)
    if data.size == 0:
        return None
    data = np.sort(data) * scale

    def pct(p: float) -> float:
        return round(float(data[min(data.size - 1, int(p / 100.0 * data.size))]), 3)

    return {"count": int(data.size), "p50": pct(50), "p95": pct(95), "p99": pct(99)}


def _percentiles_ms(tel, name: str) -> Optional[Dict[str, Any]]:
    return _percentiles(tel, name, 1e-6)


def _percentiles_raw(tel, name: str) -> Optional[Dict[str, Any]]:
    return _percentiles(tel, name, 1.0)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "sat-torch-serve"

    def log_message(self, fmt, *args):  # per-request stderr noise: off
        pass

    def _request_id(self) -> str:
        return tracectx.ensure_id(self.headers.get(tracectx.TRACE_HEADER))

    def _send(
        self, status: int, body: bytes, ctype: str, rid: str, headers: Optional[Dict[str, str]] = None
    ) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        # every reply carries the correlation id, sheds and 404s too
        self.send_header(tracectx.TRACE_HEADER, rid)
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _reply(
        self, status: int, payload: Dict[str, Any], rid: str, headers: Optional[Dict[str, str]] = None
    ) -> None:
        self._send(status, json.dumps(payload).encode(), "application/json", rid, headers)

    def do_GET(self) -> None:
        app = self.server.app
        rid = self._request_id()
        route = self.path.split("?", 1)[0]
        if route == "/healthz":
            payload, status = app.healthz()
            self._reply(status, payload, rid)
        elif route == "/stats":
            self._reply(200, app.stats(), rid)
        elif route == "/metrics":
            self._send(200, app.metrics_text().encode(), promtext.CONTENT_TYPE, rid)
        else:
            self._reply(404, {"error": f"no route {self.path}"}, rid)

    def do_POST(self) -> None:
        app = self.server.app
        rid = self._request_id()
        route, _, query = self.path.partition("?")
        if route == "/profile":
            params = urllib.parse.parse_qs(query)
            try:
                duration_ms = int(params["duration_ms"][0]) if "duration_ms" in params else None
            except (ValueError, IndexError):
                self._reply(400, {"error": "duration_ms must be an integer"}, rid)
                return
            ok, info = app.start_profile(duration_ms)
            if ok:
                self._reply(200, {"profile_dir": info, "duration_ms": duration_ms}, rid)
            else:
                self._reply(409 if "in progress" in info else 503, {"error": info}, rid)
            return
        if route != "/caption":
            self._reply(404, {"error": f"no route {self.path}"}, rid)
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            length = 0
        if length <= 0:
            self._reply(400, {"error": "empty body; POST image bytes"}, rid)
            return
        body = self.rfile.read(length)
        status, payload = app.handle_caption(
            body, deadline_ms=self.headers.get("X-Deadline-Ms"), request_id=rid
        )
        headers = None
        if status in (429, 503) and "retry_after_ms" in payload:
            # Retry-After is whole seconds, rounded up and never 0
            secs = max(1, int(-(-payload["retry_after_ms"] // 1000)))
            headers = {"Retry-After": str(secs), "X-Shed-Scope": payload.get("shed_scope", "global")}
        self._reply(status, payload, rid, headers)


class _HTTPServer(ThreadingHTTPServer):
    # listen backlog: a burst of connections beyond socketserver's default
    # of 5 waits in the kernel for the accept loop
    request_queue_size = 128
    daemon_threads = True


class CaptionServer:
    """The batcher, the HTTP listener, the heartbeat and the operations
    layer (tracer, profile latch, metering, capacity, SLOs) around a
    :class:`ServeEngine`; owns the readiness flag and the drain."""

    # longest a request thread waits on an admitted request without a
    # deadline (a wedged card must not strand connections for long)
    DEFAULT_WAIT_S = 120.0

    def __init__(
        self,
        config: Config,
        engine: ServeEngine,
        port: Optional[int] = None,
        host: Optional[str] = None,
    ) -> None:
        self.config = config
        self.engine = engine
        self._tel = telemetry.get()
        self.pool: Optional[PagedSlotPool] = None
        if config.serve_mode == "continuous":
            self.pool = PagedSlotPool(
                engine, pages=config.serve_slot_pages, page_width=config.serve_page_width, tel=self._tel
            )
            self.batcher = ContinuousBatcher(
                engine, pool=self.pool, queue_depth=config.serve_queue_depth, tel=self._tel,
                on_wedge=self._on_wedge, wedge_timeout_ms=config.serve_wedge_timeout_ms,
            )
        else:
            self.batcher = MicroBatcher(
                engine, max_batch=config.serve_max_batch, max_wait_ms=config.serve_max_wait_ms,
                queue_depth=config.serve_queue_depth, tel=self._tel,
                on_wedge=self._on_wedge, wedge_timeout_ms=config.serve_wedge_timeout_ms,
            )
        self._host = host if host is not None else config.serve_host
        self._requested_port = port if port is not None else config.serve_port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self._ready = False
        self._stop = threading.Event()
        # admitted /caption requests resident in this process (queued or
        # decoding): a /healthz load signal beside queue_depth
        self._in_flight = 0
        self._in_flight_lock = threading.Lock()
        # a wedged batch being re-warmed: /healthz says 503 "degraded"
        # while requests are still admitted
        self._degraded = False
        self._t_start = time.time()
        self.heartbeat: Optional[Heartbeat] = None
        tdir = telemetry_dir(config)
        cap_bytes = int(config.telemetry_log_cap_mb * 1e6)
        self.tracer = tracectx.RequestTracer(path=os.path.join(tdir, "access.jsonl"), cap_bytes=cap_bytes)
        self.profiles = ProfileLatch(tdir, device=engine.device)
        # cost attribution and the capacity plane, only with telemetry on
        # (attribution rides telemetry-gated windows)
        self.metering: Optional[MeteringLedger] = None
        self.capacity: Optional[CapacityModel] = None
        self._cache_sketch: Optional[EncodeCacheSketch] = None
        if config.serve_metering and self._tel.enabled:
            self.metering = MeteringLedger(
                path=os.path.join(tdir, "metering.jsonl"), cap_bytes=cap_bytes, tel=self._tel
            )
            self._cache_sketch = EncodeCacheSketch()
            self.capacity = CapacityModel(
                self._tel, self.metering,
                # decode seats: pool slots, or the largest bucket in batch mode
                slots=self.pool.slots if self.pool is not None else max(engine.buckets),
                sketch=self._cache_sketch,
                cache=None,  # the encode cache is not ported
            )
        self.slo = SLOEngine(
            self._tel, objectives_from_config(config, "serve"),
            jsonl_path=os.path.join(tdir, "slo.jsonl"), cap_bytes=cap_bytes,
            fast_s=config.slo_window_fast_s, slow_s=config.slo_window_slow_s,
        )

    @property
    def port(self) -> Optional[int]:
        return None if self._httpd is None else self._httpd.server_address[1]

    @property
    def ready(self) -> bool:
        return self._ready

    @property
    def in_flight(self) -> int:
        with self._in_flight_lock:
            return self._in_flight

    # -- request handlers (HTTP worker threads) ----------------------------

    def _finish_request(
        self, trace, status: int, payload: Dict[str, Any], bucket: Optional[int] = None, cost=None
    ) -> Tuple[int, Dict[str, Any]]:
        """Every terminal /caption reply funnels through here: the access
        log gets its record, the SLO error-ratio counters tick, the
        request's attributed cost is charged, and the payload learns its
        request id."""
        total_ns = time.perf_counter_ns() - trace.t_start_ns
        with self._in_flight_lock:
            self._in_flight = max(0, self._in_flight - 1)
        self._tel.count("serve/http_requests")
        if status >= 500:
            self._tel.count("serve/http_5xx")
        if self.metering is not None:
            # host phases lift off the trace; device phases arrive on cost
            phases = trace.phases
            self.metering.charge(
                "default", cost=cost,
                queue_ms=phases.get("queue_wait", (0, 0))[1] / 1e6,
                detok_ms=phases.get("detok", (0, 0))[1] / 1e6,
                error=status >= 500,
            )
        if self.capacity is not None:
            self.capacity.maybe_update()  # rate-limited
        self.tracer.finish(trace, status, total_ns, bucket=bucket, error=payload.get("error"), cost=cost)
        payload["request_id"] = trace.trace_id
        return status, payload

    def handle_caption(
        self, body: bytes, deadline_ms=None, request_id: Optional[str] = None
    ) -> Tuple[int, Dict[str, Any]]:
        t_req0 = time.perf_counter_ns()
        trace = self.tracer.begin(request_id)
        trace.t_start_ns = t_req0
        with self._in_flight_lock:
            self._in_flight += 1  # paired decrement in _finish_request
        if not self._ready:
            return self._finish_request(trace, 503, self._shed({"error": "server is draining; not accepting work"}))
        try:
            image = self.engine.preprocess(body)
        except ValueError as e:
            # undecodable body: a client problem, counted
            self._tel.count("serve/bad_input")
            return self._finish_request(
                trace, 400, {"error": "bad image", "detail": f"cannot decode image bytes: {e}"}
            )
        if self._cache_sketch is not None:
            # would-be encode-cache probe over the raw POST bytes.  The JAX
            # server keys it by crc32c; utils.summary.crc32c holds the GIL
            # ~11 ms over a 60 KB JPEG, which serialized a 32-request burst
            # by ~0.35 s on the H100's host, so the key here is zlib's
            # crc32 (C, ~40 us): the same membership, the same hit ratio
            self._cache_sketch.observe(zlib.crc32(body))
        if deadline_ms is None or deadline_ms == "":
            budget_ms = self.config.serve_deadline_ms
        else:
            try:
                budget_ms = int(deadline_ms)
            except (TypeError, ValueError):
                return self._finish_request(trace, 400, {"error": "X-Deadline-Ms must be integer milliseconds"})
        deadline_unix = time.time() + budget_ms / 1e3 if budget_ms > 0 else None
        try:
            req = self.batcher.submit(image, deadline_unix=deadline_unix, trace=trace)
        except Rejected as e:
            payload = {"error": e.reason}
            return self._finish_request(trace, e.status, self._shed(payload) if e.status in (429, 503) else payload)
        wait_s = budget_ms / 1e3 + 5.0 if deadline_unix else self.DEFAULT_WAIT_S
        if not req.done.wait(timeout=wait_s):
            self._tel.count("serve/timeouts")
            # abandoned work is still charged what it accrued
            return self._finish_request(trace, 504, {"error": "request timed out in service"}, cost=req.cost)
        if req.error is not None:
            payload = {"error": req.error[1]}
            if req.error[0] in (429, 503):
                payload = self._shed(payload)
            return self._finish_request(trace, req.error[0], payload, bucket=req.bucket, cost=req.cost)
        self._tel.record("serve/request", t_req0, time.perf_counter_ns() - t_req0)
        payload = dict(req.result)
        payload["bucket"] = req.bucket
        payload["slot"] = _INCUMBENT
        payload["model_step"] = self.engine.step
        return self._finish_request(trace, 200, payload, bucket=req.bucket, cost=req.cost)

    def _shed(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """A 429/503 payload with the backoff hint: about one service
        period (the observed p50 request latency, else twice the batching
        window), clamped to 50 ms-10 s.  The scope is always the
        service's until the tenant plane is ported."""
        p = _percentiles_ms(self._tel, "serve/request")
        hint = p["p50"] if p else 2.0 * max(1.0, self.config.serve_max_wait_ms)
        payload["retry_after_ms"] = int(min(10_000.0, max(50.0, hint)))
        payload["shed_scope"] = "global"
        return payload

    def healthz(self) -> Tuple[Dict[str, Any], int]:
        payload = self.heartbeat.payload() if self.heartbeat else {}
        # two degrade causes: a wedged batch being re-warmed, and a
        # burning SLO; both flip the balancer-facing health while
        # requests are still admitted
        burning = self.slo.burning()
        degraded = self._degraded or bool(burning)
        if degraded:
            status = "degraded"
        elif self._ready:
            status = "ok"
        else:
            status = "draining" if self._httpd is not None else "stopped"
        payload.update(
            {
                "ready": self._ready,
                "status": status,
                "uptime_s": round(time.time() - self._t_start, 1),
                "queue_depth": self.batcher.queue_depth(),
                "in_flight": self.in_flight,
                "serve_mode": self.config.serve_mode,
                "tier": self.config.serve_tier,
                "buckets": list(self.engine.buckets),
                "model_step": self.engine.step,
            }
        )
        if burning:
            payload["slo_burning"] = burning
        return payload, (200 if self._ready and not degraded else 503)

    # -- wedge containment (called from the batcher thread) ----------------

    def _on_wedge(self) -> None:
        """A stuck batch was just failed with 500s: flip health to 503
        "degraded" and re-warm the engine in the background; the re-warm
        returns once the card answers again, and health recovers."""
        self._degraded = True
        self._tel.gauge("serve/degraded", 1)
        threading.Thread(target=self._rewarm, name="sat-torch-serve-rewarm", daemon=True).start()

    def _rewarm(self) -> None:
        t0 = time.perf_counter()
        try:
            if self.config.serve_mode == "continuous":
                # on the loop thread: the pool has one owner
                self.batcher.rewarm()
            else:
                self.engine.warmup()
        except Exception as e:
            # still wedged: stay degraded
            print(f"sat_tpu_torch: serve re-warm failed ({e!r}); staying degraded", file=sys.stderr, flush=True)
            return
        self._tel.count("serve/rewarms")
        self._degraded = False
        self._tel.gauge("serve/degraded", 0)
        print(
            f"sat_tpu_torch: serve engine re-warmed after wedged batch in "
            f"{time.perf_counter() - t0:.2f}s; health restored",
            file=sys.stderr,
            flush=True,
        )

    def stats(self) -> Dict[str, Any]:
        counters = self._tel.counters()
        prefix = "serve/bucket_"
        histogram = {k[len(prefix):]: v for k, v in counters.items() if k.startswith(prefix)}
        latency = {}
        for name in _LATENCY_SPANS:
            p = _percentiles_ms(self._tel, name)
            if p:
                latency[name] = p
        out = {
            "ready": self._ready,
            "serve_mode": self.config.serve_mode,
            "tier": self.config.serve_tier,
            "queue_depth": self.batcher.queue_depth(),
            "in_flight": self.in_flight,
            "buckets": list(self.engine.buckets),
            "bucket_histogram": histogram,
            "counters": {k: v for k, v in counters.items() if k.startswith("serve/")},
            "latency_ms": latency,
            "slo": self.slo.snapshot(),
            "profile_captures": self.profiles.captures,
            "device": str(self.engine.device),
            "kernels": {"fused_attend": {
                "launches": fused_attend.launches,
                "masked_launches": fused_attend.masked_launches,
            }},
        }
        steps = _percentiles_raw(self._tel, "serve/decode_steps")
        if steps:
            out["decode_steps"] = steps
        engine_block: Dict[str, Any] = {
            "encoder_quant": self.engine.encoder_quant,
            "quantize_seconds": round(self.engine.quantize_seconds, 3),
        }
        spd = _percentiles_raw(self._tel, "serve/steps_per_dispatch")
        if spd:
            engine_block["steps_per_dispatch"] = spd
        enc = _percentiles_ms(self._tel, "serve/encode")
        if enc:
            engine_block["encode_ms"] = enc
        lanes = {}
        for lane in self._encode_lanes():
            p = _percentiles_ms(self._tel, f"serve/encode_lane{lane}")
            if p:
                lanes[str(lane)] = p
        if lanes:
            engine_block["encode_lanes_ms"] = lanes
        out["engine"] = engine_block
        if self.pool is not None:
            out["slot_pool"] = {
                "slots": self.pool.slots,
                "pages": self.pool.pages,
                "page_width": self.pool.width,
                "busy": self.pool.occupancy(),
                "dispatches": counters.get("serve/dispatches", 0),
                "steps": counters.get("serve/steps", 0),
                "dispatches_per_k": {
                    str(k): counters.get(f"serve/dispatch_k{k}", 0) for k in self.pool.decode_depths
                },
            }
        if self.metering is not None:
            # per-tenant attributed cost: one "default" row until tenants
            out["tenants_cost"] = self.metering.snapshot()
        if self.capacity is not None:
            self.capacity.maybe_update()
            out["capacity"] = {
                name.split("/", 1)[1]: value
                for name, value in self._tel.gauges().items()
                if name.startswith("capacity/")
            }
        return out

    def _encode_lanes(self):
        """Every encode width this server can have timed: the buckets
        (batch mode) plus the pool's admission lanes (continuous)."""
        lanes = set(self.engine.buckets)
        if self.pool is not None:
            lanes.update(self.pool.lane_widths)
        return sorted(lanes)

    # -- observability endpoints -------------------------------------------

    def metrics_text(self) -> str:
        """The Prometheus exposition body for ``GET /metrics``."""
        # scrape-time refresh of the distribution gauges, so neither mode
        # pays for them per request
        steps = _percentiles_raw(self._tel, "serve/decode_steps")
        if steps:
            self._tel.gauge("serve/decode_steps_p50", steps["p50"])
            self._tel.gauge("serve/decode_steps_p95", steps["p95"])
        spd = _percentiles_raw(self._tel, "serve/steps_per_dispatch")
        if spd:
            self._tel.gauge("serve/steps_per_dispatch", spd["p50"])
            self._tel.gauge("serve/steps_per_dispatch_p95", spd["p95"])
        enc = _percentiles_ms(self._tel, "serve/encode")
        if enc:
            self._tel.gauge("serve/encode_ms", enc["p50"])
            self._tel.gauge("serve/encode_ms_p95", enc["p95"])
        if self.capacity is not None:
            self.capacity.maybe_update()
        extra = self.heartbeat.payload() if self.heartbeat else None
        return promtext.render(self._tel, extra=extra, histograms=_HISTOGRAMS)

    def start_profile(self, duration_ms=None) -> Tuple[bool, str]:
        """Begin a bounded live profiler capture (``POST /profile``)."""
        ok, info = self.profiles.start(duration_ms)
        if ok:
            self._tel.count("serve/profile_windows")
        return ok, info

    def export_trace(self, path: Optional[str] = None) -> Optional[str]:
        """Write the Chrome trace with one lane per retained request
        (shutdown calls it when ``trace_export`` is set)."""
        from ..telemetry import exporters

        if path is None:
            path = self.config.trace_export
        if not path:
            return None
        return exporters.export_chrome_trace(
            self._tel, path,
            extra_events=self.tracer.trace_events(
                getattr(self._tel, "anchor_ns", 0), pid=telemetry.process_identity()[0]
            ),
        )

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "CaptionServer":
        self.batcher.start()
        self._httpd = _HTTPServer((self._host, self._requested_port), _Handler)
        self._httpd.app = self
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="sat-torch-serve-http", daemon=True
        )
        self._http_thread.start()
        if self.config.heartbeat_interval > 0:
            hb_dir = telemetry_dir(self.config)
            try:
                os.makedirs(hb_dir, exist_ok=True)
                self.heartbeat = Heartbeat(
                    os.path.join(hb_dir, "heartbeat.json"),
                    self.config.heartbeat_interval,
                    self._tel,
                    static={
                        "phase": "serve",
                        "port": self.port,
                        "buckets": list(self.engine.buckets),
                        "model_step": self.engine.step,
                    },
                ).start()
            except OSError:
                self.heartbeat = None  # health still served from /healthz
        if self.slo.objectives:
            # tick a few times per fast window so a burn is seen promptly
            self.slo.start(interval_s=max(0.1, min(5.0, self.config.slo_window_fast_s / 4)))
        self._ready = True
        self._tel.gauge("serve/ready", 1)
        return self

    def request_shutdown(self) -> None:
        """Programmatic twin of SIGTERM."""
        self._stop.set()

    def shutdown(self) -> None:
        """Readiness flips first, the batcher completes everything
        admitted, then the listener closes; the SLO engine, any capture,
        the ledger, the trace and last the heartbeat follow."""
        if self._httpd is None:
            return
        self._ready = False
        self._tel.gauge("serve/ready", 0)
        self.batcher.drain()
        self._httpd.shutdown()
        if self._http_thread is not None:
            self._http_thread.join(timeout=10.0)
            self._http_thread = None
        self._httpd.server_close()
        self._httpd = None
        self.slo.stop()
        self.profiles.stop_now()
        if self.metering is not None:
            self.metering.maybe_flush(force=True)
        self.export_trace()  # no-op unless trace_export is set
        if self.heartbeat is not None:
            self.heartbeat.stop()

    def serve_until_shutdown(self, shutdown=None, poll_s: float = 0.1) -> None:
        """Block until SIGTERM/SIGINT or ``request_shutdown()``, then
        drain.  ``shutdown`` takes an externally managed GracefulShutdown;
        by default one is installed here (signals only on the main
        thread)."""
        own = shutdown is None
        sd = GracefulShutdown() if own else shutdown
        try:
            if own:
                sd.__enter__()
            while not sd.stop_requested and not self._stop.is_set():
                time.sleep(poll_s)
        finally:
            if own:
                sd.__exit__(None, None, None)
            self.shutdown()


def serve(config: Config, model_file: Optional[str] = None, device=None) -> int:
    """CLI entry point: ``python -m sat_tpu_torch.cli --phase serve``.

    Lineage load → warm every bucket (batch mode) or the slot pool
    (continuous mode) → listen → drain on SIGTERM/SIGINT.  Telemetry is
    always on in this phase (``/stats``, ``/metrics`` and the logs read
    it).  A knob not ported yet raises before anything loads."""
    check_ported(config)
    tel = telemetry.get()
    if not tel.enabled:
        tel = telemetry.enable(capacity=config.telemetry_buffer)
    vocabulary = Vocabulary(config.vocabulary_size, config.vocabulary_file)
    state, source = load_serving_state(config, model_file=model_file, device=device)
    engine = ServeEngine(config, state, vocabulary, device=device, tel=tel)
    print(
        f"sat_tpu_torch: serving params from {source} (step {engine.step}) on {engine.device}",
        file=sys.stderr,
        flush=True,
    )
    if config.serve_mode == "batch":
        # continuous mode warms the slot pool instead, in the batcher's start
        engine.warmup()
    server = CaptionServer(config, engine)
    # flight recorder: an abnormal exit leaves a postmortem bundle
    bb = None
    if config.blackbox:
        from ..telemetry import blackbox as _blackbox

        tdir = telemetry_dir(config)
        bb = _blackbox.BlackBox(os.path.join(tdir, "blackbox"), tel)
        _blackbox.install(bb, telemetry_dir=tdir, config_snapshot=config.to_dict())
        bb.event("serve_start", port=server.port, model_step=engine.step)
    # SIGTERM/SIGINT handlers go in before the listener opens, so a
    # signal from the first reply on drains instead of killing
    with GracefulShutdown() as shutdown:
        server.start()
        if server.pool is not None:
            pool = server.pool
            geometry = (
                f"mode continuous, slot pool {pool.pages}x{pool.width} ({pool.slots} slots), "
                f"lanes {pool.lane_widths}, decode depths {list(pool.decode_depths)}"
            )
        else:
            geometry = (
                f"mode batch, buckets {engine.buckets}, max_batch {config.serve_max_batch}, "
                f"max_wait {config.serve_max_wait_ms}ms"
            )
        print(
            f"sat_tpu_torch: captioning server listening on "
            f"http://{config.serve_host}:{server.port}  ({geometry})",
            file=sys.stderr,
            flush=True,
        )
        try:
            server.serve_until_shutdown(shutdown)
        except Exception as e:
            if bb is not None:
                from ..telemetry import blackbox as _blackbox

                bb.event("uncaught_exception", error=repr(e))
                _blackbox.dump("uncaught_exception", error=repr(e))
            raise
    if bb is not None:
        bb.event("serve_drained")
    print("sat_tpu_torch: serve drained cleanly", file=sys.stderr, flush=True)
    return 0
