"""HTTP frontend for the captioning service — the port of ``sat_tpu.serve.server``.

A stdlib ``ThreadingHTTPServer``: request threads decode the image and
park on an Event while the batcher owns the device.

Endpoints:

* ``POST /caption`` — body: image bytes (JPEG/PNG), or a context grid
  framed by ``serve.handoff`` (``Content-Type: application/x-sat-grid``,
  the decode tier).  200 → ``{"captions": [{"caption", "log_prob",
  "prob"}, ...beam-ordered], "bucket", "slot", "model_step",
  "request_id"}`` (plus ``tenant`` and ``model`` under ``tenants``), the
  JAX server's payload (``bucket`` is the page width in continuous
  mode).  400 for an empty or undecodable body, a bad frame or an unknown
  ``X-Model``; 409 for a grid encoded at another model step; 429 when the
  queue (or the tenant's lane or quota) is full; 500 when the batch
  wedged; 503 while draining; 504 past the deadline (``X-Deadline-Ms`` or
  ``serve_deadline_ms``).  ``X-Tenant`` picks the tenant, ``X-Model`` a
  resident model; each 429/503 carries ``Retry-After`` and
  ``X-Shed-Scope: tenant|global``.
* ``POST /encode`` — image bytes → the framed ``[N, D]`` context grid
  (``application/x-sat-grid``) a decode tier captions.
* ``POST /reload``, ``/promote``, ``/rollback`` — the model lifecycle:
  200 or 409 with ``{"ok", "detail", "state", "model_step"}``.
* ``GET /quality_reference`` — the frozen quality reference (200), 409
  before one froze, 404 with the quality plane off.
* ``GET /healthz`` — readiness plus the heartbeat payload: 200 "ok",
  503 "degraded" (a wedged batch being re-warmed, or a burning SLO),
  "draining" or "stopped".  The top-level load signals a router polls:
  ``queue_depth``, ``in_flight``, ``serve_mode``, ``tier``, ``buckets``,
  ``lifecycle_state`` (and ``candidate_step``, ``tenants``).
* ``GET /stats`` — queue depth, bucket histogram, the ``serve/``
  counters, p50/p95/p99 per serve span, the SLO verdicts, profile
  captures, per-tenant cost, the capacity gauges and the ``lifecycle``
  block; ``encode_cache``, ``tenants`` and ``quality`` blocks when those
  planes are on; ``fused_attend`` launches and the device (port only);
  in continuous mode a ``slot_pool`` block.
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

The lifecycle controller is built at every config, as the JAX server's
is, so the admin endpoints answer at the defaults; its poller starts
only with ``model_reload > 0``.  Tenants (``tenants``) add quotas
checked before preprocessing, weighted lanes, ``tenant_*`` SLO lanes and
resident models loaded at boot through the lifecycle loader.

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
from ..lifecycle import LifecycleController
from ..lifecycle import canary as canary_mod
from ..lifecycle.loader import load_candidate
from ..ops.fused_attend import fused_attend
from ..resilience.preempt import GracefulShutdown
from ..telemetry import promtext, tracectx
from ..telemetry.capacity import CapacityModel, EncodeCacheSketch
from ..telemetry.exemplar import ExemplarRecorder
from ..telemetry.heartbeat import Heartbeat
from ..telemetry.metering import MeteringLedger
from ..telemetry.profwin import ProfileLatch
from ..telemetry.quality import QualityMonitor, QualityReference
from ..telemetry.slo import SLOEngine, objectives_from_config
from ..utils.summary import crc32c
from . import handoff
from .batcher import ContinuousBatcher, MicroBatcher, Rejected
from .engine import ServeEngine, load_serving_state
from .slot_pool import PagedSlotPool
from .tenants import TenantRegistry

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
        elif route == "/quality_reference":
            payload, status = app.quality_reference()
            self._reply(status, payload, rid)
        else:
            self._reply(404, {"error": f"no route {self.path}"}, rid)

    def do_POST(self) -> None:
        app = self.server.app
        rid = self._request_id()
        route, _, query = self.path.partition("?")
        if route in ("/reload", "/promote", "/rollback"):
            status, payload = app.admin_lifecycle(route[1:])
            self._reply(status, payload, rid)
            return
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
        if route not in ("/caption", "/encode"):
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
        if route == "/encode":
            # the encode tier: image bytes in, a framed context grid out
            status, out_body, ctype = app.handle_encode(body)
            self._send(status, out_body, ctype, rid)
            return
        status, payload = app.handle_caption(
            body, deadline_ms=self.headers.get("X-Deadline-Ms"), request_id=rid,
            tenant=self.headers.get("X-Tenant"), model=self.headers.get("X-Model"),
            content_type=self.headers.get("Content-Type"),
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
        # the tenant plane: X-Tenant → quota, scheduling weight, resident
        # model, SLO lane.  An empty spec is the single-tenant registry
        # (multi=False): no quotas, one lane, no per-tenant counters.
        self.tenants = TenantRegistry.parse(config.tenants)
        self._load_residents()
        weights = self.tenants.weights() if self.tenants.multi else None
        tdir = telemetry_dir(config)
        # the quality plane: streaming signal sketches and drift against a
        # frozen reference, and the exemplar recorder for outliers
        self.quality: Optional[QualityMonitor] = None
        self.exemplars: Optional[ExemplarRecorder] = None
        if config.serve_quality == "on":
            reference = None
            if config.serve_quality_reference:
                reference = QualityReference.load(config.serve_quality_reference)
            self.quality = QualityMonitor(
                window=config.serve_quality_window, reference=reference,
                margin_min=config.serve_quality_margin_min, unk_max=config.serve_quality_unk_max,
                tel=self._tel,
            )
            self.exemplars = ExemplarRecorder(
                config.serve_quality_exemplar_dir or os.path.join(tdir, "exemplars"),
                budget_mb=config.serve_quality_exemplar_mb,
            )
            # replay context: a replay boots from this meta
            self.exemplars.write_meta(
                {
                    "config": config.to_dict(),
                    "model_step": engine.step,
                    "vocab_crc32c": f"{crc32c(chr(10).join(engine.vocabulary.words).encode('utf-8')):08x}",
                }
            )
        self.pool: Optional[PagedSlotPool] = None
        if config.serve_mode == "continuous":
            self.pool = PagedSlotPool(
                engine, pages=config.serve_slot_pages, page_width=config.serve_page_width, tel=self._tel
            )
            self.batcher = ContinuousBatcher(
                engine, pool=self.pool, queue_depth=config.serve_queue_depth, tel=self._tel,
                on_wedge=self._on_wedge, wedge_timeout_ms=config.serve_wedge_timeout_ms,
                weights=weights, quality=self.quality, exemplars=self.exemplars,
            )
        else:
            self.batcher = MicroBatcher(
                engine, max_batch=config.serve_max_batch, max_wait_ms=config.serve_max_wait_ms,
                queue_depth=config.serve_queue_depth, tel=self._tel,
                on_wedge=self._on_wedge, wedge_timeout_ms=config.serve_wedge_timeout_ms,
                weights=weights, quality=self.quality, exemplars=self.exemplars,
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
                # the real cache, when on: its hit ratio beside the sketch's
                cache=engine.encode_cache,
            )
        self.slo = SLOEngine(
            self._tel,
            objectives_from_config(
                config, "serve",
                tenants=self.tenants.slo_lanes(config.slo_serve_p99_ms, config.slo_error_ratio),
            ),
            jsonl_path=os.path.join(tdir, "slo.jsonl"), cap_bytes=cap_bytes,
            fast_s=config.slo_window_fast_s, slow_s=config.slo_window_slow_s,
        )
        # the model lifecycle: built at every config, so /reload, /promote
        # and /rollback answer; its poller starts only with model_reload > 0
        self.lifecycle = LifecycleController(config, engine, self.batcher, tel=self._tel)

    def _load_residents(self) -> None:
        """Load every resident model the tenant spec names through the
        lifecycle loader (integrity, vocabulary and full-coverage guards),
        each checked against the incumbent.  A resident that fails is a
        boot error: a tenant pointed at a model that cannot serve must
        not fall back to the incumbent."""
        for alias, path in sorted(self.tenants.models.items()):
            staged = load_candidate(self.engine, self.config, path)
            self.engine.install_resident(
                alias, staged["variables"], staged["decoder_params"], staged["step"], staged["source"]
            )
            print(
                f"sat_tpu_torch: resident model {alias!r} loaded from {path} (step {staged['step']})",
                file=sys.stderr,
                flush=True,
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
        self, trace, status: int, payload: Dict[str, Any], bucket: Optional[int] = None,
        slot: str = canary_mod.INCUMBENT, tenant: Optional[str] = None, cost=None,
    ) -> Tuple[int, Dict[str, Any]]:
        """Every terminal /caption reply funnels through here: the access
        log gets its record, the SLO error-ratio counters tick (the
        tenant's and the canary's lanes too), the request's attributed
        cost is charged to its tenant, and the payload learns its
        request id."""
        total_ns = time.perf_counter_ns() - trace.t_start_ns
        with self._in_flight_lock:
            self._in_flight = max(0, self._in_flight - 1)
        self._tel.count("serve/http_requests")
        if status >= 500:
            self._tel.count("serve/http_5xx")
        if tenant is not None and self.tenants.multi:
            # the tenant's own SLO lane: its latency span and counters
            self._tel.count(f"serve/tenant_{tenant}_requests")
            if status >= 500:
                self._tel.count(f"serve/tenant_{tenant}_5xx")
            if status == 429:
                self._tel.count(f"serve/tenant_{tenant}_429")
            self._tel.record(f"serve/tenant_{tenant}_request", trace.t_start_ns, total_ns)
        if slot == canary_mod.CANARY:
            # the canary SLO engine scores canary-slot traffic alone
            self._tel.count("serve/canary_requests")
            if status >= 500:
                self._tel.count("serve/canary_5xx")
            self._tel.record("serve/canary_request", trace.t_start_ns, total_ns)
        if self.metering is not None:
            # host phases lift off the trace; device phases arrive on cost
            phases = trace.phases
            self.metering.charge(
                tenant if tenant is not None else "default", cost=cost,
                queue_ms=phases.get("queue_wait", (0, 0))[1] / 1e6,
                detok_ms=phases.get("detok", (0, 0))[1] / 1e6,
                error=status >= 500,
            )
        if self.capacity is not None:
            self.capacity.maybe_update()  # rate-limited
        self.tracer.finish(
            trace, status, total_ns, bucket=bucket, error=payload.get("error"), tenant=tenant, cost=cost
        )
        payload["request_id"] = trace.trace_id
        return status, payload

    def handle_encode(self, body: bytes) -> Tuple[int, bytes, str]:
        """``POST /encode``, the encode tier's request path: image bytes →
        a framed context grid (``serve.handoff``) a decode tier captions.
        Stateless: no slot, no queue.  Runs on the HTTP thread, which takes
        the engine's device and inference mode for the encode."""
        t0 = time.perf_counter_ns()

        def _err(status: int, payload: Dict[str, Any]):
            return status, json.dumps(payload).encode(), "application/json"

        if not self._ready:
            return _err(503, {"error": "server is draining; not accepting work"})
        try:
            image = self.engine.preprocess(body)
        except Exception as e:
            self._tel.count("serve/bad_input")
            return _err(400, {"error": "bad image", "detail": f"cannot decode image bytes: {e}"})
        try:
            grid = self.engine.encode_one(image)
        except Exception as e:
            self._tel.count("serve/encode_http_errors")
            return _err(500, {"error": f"encode failed: {e}"})
        self._tel.count("serve/encode_http")
        self._tel.record("serve/encode_request", t0, time.perf_counter_ns() - t0)
        return 200, handoff.encode_grid(grid, step=self.engine.step), handoff.GRID_CONTENT_TYPE

    def handle_caption(
        self, body: bytes, deadline_ms=None, request_id: Optional[str] = None,
        tenant: Optional[str] = None, model: Optional[str] = None, content_type: Optional[str] = None,
    ) -> Tuple[int, Dict[str, Any]]:
        t_req0 = time.perf_counter_ns()
        trace = self.tracer.begin(request_id)
        trace.t_start_ns = t_req0
        with self._in_flight_lock:
            self._in_flight += 1  # paired decrement in _finish_request
        # X-Tenant → the tenant's spec (bare and unknown keys map to the
        # default tenant); tname is None on the single-tenant registry
        spec = self.tenants.resolve(tenant)
        tname = spec.name if self.tenants.multi else None
        if tenant and tname is not None and not self.tenants.known(tenant):
            self._tel.count("serve/tenant_unknown")
        if not self._ready:
            return self._finish_request(
                trace, 503,
                {"error": "server is draining; not accepting work",
                 "retry_after_ms": self._retry_hint_ms(), "shed_scope": "global"},
                tenant=tname,
            )
        # the tenant's token bucket, checked before preprocessing: a dry
        # bucket is a tenant-scoped 429 whose hint is its own refill time
        if tname is not None and not self.tenants.try_admit(spec.name):
            self._tel.count("serve/shed")
            self._tel.count(f"serve/tenant_{spec.name}_shed")
            return self._finish_request(
                trace, 429,
                {"error": f"tenant {spec.name!r} admission quota exhausted ({spec.rps:g} rps); shed",
                 "retry_after_ms": self._tenant_retry_ms(spec.name), "shed_scope": "tenant"},
                tenant=tname,
            )
        image = context = key = None
        if (content_type or "").split(";", 1)[0].strip() == handoff.GRID_CONTENT_TYPE:
            # decode-tier ingress: a pre-encoded grid from an encode tier;
            # its frame (crc32c) and shape are checked before device work
            try:
                grid, header = handoff.decode_grid(body)
                if self.engine.ctx_row_shape is None:
                    raise handoff.HandoffError("replica has no warmed context aval yet")
                handoff.check_aval(grid, self.engine.ctx_row_shape, self.engine.ctx_row_dtype)
            except handoff.HandoffError as e:
                self._tel.count("serve/bad_handoff")
                return self._finish_request(trace, 400, {"error": "bad grid", "detail": str(e)}, tenant=tname)
            gstep = header.get("step")
            if gstep is not None and int(gstep) != self.engine.step:
                # the encoder ran another promote generation than this one
                self._tel.count("serve/stale_handoff")
                return self._finish_request(
                    trace, 409,
                    {"error": f"grid encoded at model step {gstep}; this replica serves step {self.engine.step}"},
                    tenant=tname,
                )
            context = grid
            self._tel.count("serve/grid_requests")
        else:
            try:
                image = self.engine.preprocess(body)
            except ValueError as e:
                # undecodable body: a client problem, counted
                self._tel.count("serve/bad_input")
                return self._finish_request(
                    trace, 400, {"error": "bad image", "detail": f"cannot decode image bytes: {e}"}, tenant=tname
                )
            if self._cache_sketch is not None:
                # would-be encode-cache probe over the raw POST bytes.  The JAX
                # server keys it by crc32c; utils.summary.crc32c holds the GIL
                # ~11 ms over a 60 KB JPEG, which serialized a 32-request burst
                # by ~0.35 s on the H100's host, so the key here is zlib's
                # crc32 (C, ~40 us): the same membership, the same hit ratio
                self._cache_sketch.observe(zlib.crc32(body))
            if self.engine.encode_cache is not None:
                # the real cache's content key: the preprocessed pixels.  The
                # JAX server takes crc32c of them; the key never leaves the
                # process, so zlib's crc32 keys the same rows without holding
                # the GIL for the ~13 ms crc32c takes over a 150 KB row
                key = zlib.crc32(image.tobytes())
        if deadline_ms is None or deadline_ms == "":
            budget_ms = self.config.serve_deadline_ms
        else:
            try:
                budget_ms = int(deadline_ms)
            except (TypeError, ValueError):
                return self._finish_request(
                    trace, 400, {"error": "X-Deadline-Ms must be integer milliseconds"}, tenant=tname
                )
        deadline_unix = time.time() + budget_ms / 1e3 if budget_ms > 0 else None
        # the param slot: an explicit X-Model (or the tenant's model) pins a
        # resident set; otherwise the lifecycle's sticky canary hash decides
        alias = (model or "").strip() or spec.model
        if alias:
            if not self.engine.has_resident(alias):
                return self._finish_request(
                    trace, 400,
                    {"error": f"unknown model {alias!r}", "models": list(self.engine.resident_aliases)},
                    tenant=tname,
                )
            slot = alias
        else:
            slot = self.lifecycle.route(trace.trace_id)
        try:
            req = self.batcher.submit(
                image, deadline_unix=deadline_unix, trace=trace, slot=slot, tenant=spec.name,
                raw=body, key=key, context=context,
            )
        except Rejected as e:
            # a refused request leaves replayable evidence with quality on
            self._record_terminal_exemplar(trace, e.status, "shed", tname, body)
            payload = {"error": e.reason}
            if e.status in (429, 503):
                payload["shed_scope"] = e.scope
                payload["retry_after_ms"] = (
                    self._tenant_retry_ms(spec.name) if e.scope == "tenant" else self._retry_hint_ms()
                )
            return self._finish_request(trace, e.status, payload, slot=slot, tenant=tname)
        wait_s = budget_ms / 1e3 + 5.0 if deadline_unix else self.DEFAULT_WAIT_S
        if not req.done.wait(timeout=wait_s):
            self._tel.count("serve/timeouts")
            self._record_terminal_exemplar(trace, 504, "timeout", tname, body)
            # abandoned work is still charged what it accrued
            return self._finish_request(
                trace, 504, {"error": "request timed out in service"}, slot=slot, tenant=tname, cost=req.cost
            )
        if req.error is not None:
            payload = {"error": req.error[1]}
            if req.error[0] in (429, 503):
                payload["retry_after_ms"] = self._retry_hint_ms()
                payload["shed_scope"] = "global"
            return self._finish_request(
                trace, req.error[0], payload, bucket=req.bucket, slot=slot, tenant=tname, cost=req.cost
            )
        self._tel.record("serve/request", t_req0, time.perf_counter_ns() - t_req0)
        payload = dict(req.result)
        payload["bucket"] = req.bucket
        payload["slot"] = slot
        if tname is not None:
            payload["tenant"] = tname
        if slot == canary_mod.CANARY:
            step = self.engine.candidate_step
            payload["model_step"] = step if step is not None else self.engine.step
        elif alias:
            payload["model"] = alias
            step = self.engine.resident_step(alias)
            payload["model_step"] = step if step is not None else self.engine.step
        else:
            payload["model_step"] = self.engine.step
            # during a canary window a sample of incumbent answers is
            # replayed on the candidate for the divergence gauge (bounded
            # queue; a grid request has no image to replay)
            if image is not None:
                try:
                    self.lifecycle.maybe_shadow(image, payload["captions"][0]["caption"])
                except (KeyError, IndexError, TypeError):
                    pass
        return self._finish_request(
            trace, 200, payload, bucket=req.bucket, slot=slot, tenant=tname, cost=req.cost
        )

    def _record_terminal_exemplar(self, trace, status: int, reason: str, tenant: Optional[str],
                                  body: bytes) -> None:
        """Shed and timed-out requests never reach the detok boundary, so
        the HTTP path records them (rate-limited by the recorder; a
        failure is counted and swallowed)."""
        if self.exemplars is None:
            return
        try:
            self.exemplars.record(
                reasons=[reason], request_id=trace.trace_id, tenant=tenant or "default",
                status=status, image_bytes=body,
            )
        except Exception:
            self._tel.count("serve/quality_errors")

    def _retry_hint_ms(self) -> int:
        """The backoff hint of a global 429/503: about one service period
        (the observed p50 request latency, else twice the batching
        window), clamped to 50 ms-10 s."""
        p = _percentiles_ms(self._tel, "serve/request")
        hint = p["p50"] if p else 2.0 * max(1.0, self.config.serve_max_wait_ms)
        return int(min(10_000.0, max(50.0, hint)))

    def _tenant_retry_ms(self, name: str) -> int:
        """The backoff hint of a tenant-scoped shed: that tenant's bucket
        refill time, never 0."""
        return max(1, int(self.tenants.retry_after_s(name) * 1000.0) + 1)

    def healthz(self) -> Tuple[Dict[str, Any], int]:
        payload = self.heartbeat.payload() if self.heartbeat else {}
        # two degrade causes: a wedged batch being re-warmed, and a
        # burning service SLO.  Tenant and quality lanes are diagnostic:
        # routing traffic away fixes neither a tenant's own flood nor a
        # model's drift, so they stay out of the health verdict.
        burning = self.slo.burning()
        service_burning = [n for n in burning if not n.startswith(("tenant_", "quality_"))]
        degraded = self._degraded or bool(service_burning)
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
                "lifecycle_state": self.lifecycle.state,
            }
        )
        candidate = self.engine.candidate_step
        if candidate is not None:
            payload["candidate_step"] = candidate
        if self.tenants.multi:
            payload["tenants"] = sorted(self.tenants.names())
        if burning:
            payload["slo_burning"] = burning
        return payload, (200 if self._ready and not degraded else 503)

    def admin_lifecycle(self, action: str) -> Tuple[int, Dict[str, Any]]:
        """``POST /reload | /promote | /rollback``: 200 on success, 409 when
        the machine is in the wrong state for the verb."""
        lc = self.lifecycle
        if action == "reload":
            ok, detail = lc.request_reload()
        elif action == "promote":
            ok, detail = lc.promote()
        elif action == "rollback":
            ok, detail = lc.rollback()
        else:
            return 404, {"error": f"no lifecycle action {action!r}"}
        return (200 if ok else 409), {"ok": ok, "detail": detail, "state": lc.state, "model_step": self.engine.step}

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
            "lifecycle": self.lifecycle.snapshot(),
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
        if self.engine.encode_cache is not None:
            # host LRU state and lifetime counters, and what a hit costs
            # on the device (the gather) beside the encode it skipped
            cache_block = self.engine.encode_cache.stats()
            gp = _percentiles_ms(self._tel, "serve/cache_gather")
            if gp:
                cache_block["gather_ms"] = gp
            out["encode_cache"] = cache_block
        if self.tenants.multi:
            out["tenants"] = self._tenant_block(counters)
        if self.metering is not None:
            # per-tenant attributed cost (one "default" row single-tenant)
            out["tenants_cost"] = self.metering.snapshot()
        if self.capacity is not None:
            self.capacity.maybe_update()
            out["capacity"] = {
                name.split("/", 1)[1]: value
                for name, value in self._tel.gauges().items()
                if name.startswith("capacity/")
            }
        if self.quality is not None:
            self.quality.maybe_publish(force=True)
            qblock = self.quality.snapshot()
            if self.exemplars is not None:
                qblock["exemplars"] = self.exemplars.stats()
            out["quality"] = qblock
        return out

    def _tenant_block(self, counters: Dict[str, Any]) -> Dict[str, Any]:
        """The /stats tenants block: each tenant's weight, quota and model,
        its queue depth, token balance, request/shed/5xx counters and
        latency percentiles; refreshes the ``serve/tenant_*`` gauges so the
        heartbeat and /metrics carry the same numbers."""
        depths = self.batcher.tenant_depths()
        admitted = self.batcher.tenant_admitted()
        block: Dict[str, Any] = {}
        for name, shape in self.tenants.describe().items():
            entry = dict(shape)
            entry["queue_depth"] = depths.get(name, 0)
            entry["admitted"] = admitted.get(name, 0)
            tokens = self.tenants.tokens(name)
            if tokens is not None and tokens != float("inf"):
                entry["tokens"] = round(tokens, 2)
                self._tel.gauge(f"serve/tenant_{name}_tokens", round(tokens, 2))
            self._tel.gauge(f"serve/tenant_{name}_queue_depth", depths.get(name, 0))
            for short, counter in (
                ("requests", f"serve/tenant_{name}_requests"),
                ("shed", f"serve/tenant_{name}_shed"),
                ("429", f"serve/tenant_{name}_429"),
                ("5xx", f"serve/tenant_{name}_5xx"),
            ):
                entry[short] = counters.get(counter, 0)
            step = self.engine.resident_step(shape["model"]) if shape["model"] else None
            if step is not None:
                entry["model_step"] = step
            p = _percentiles_ms(self._tel, f"serve/tenant_{name}_request")
            if p:
                entry["latency_ms"] = p
            block[name] = entry
        return block

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
        if self.tenants.multi:
            self._tenant_block(self._tel.counters())
        if self.engine.encode_cache is not None:
            # scrape-time refresh of the cache's residency gauges
            cstats = self.engine.encode_cache.stats()
            self._tel.gauge("serve/cache_entries", cstats["entries"])
            self._tel.gauge("serve/cache_bytes", cstats["bytes"])
            self._tel.gauge("serve/cache_hit_ratio", cstats["hit_ratio"])
            gp = _percentiles_ms(self._tel, "serve/cache_gather")
            if gp:
                self._tel.gauge("serve/cache_gather_ms_p95", gp["p95"])
        if self.capacity is not None:
            self.capacity.maybe_update()
        if self.quality is not None:
            self.quality.maybe_publish(force=True)
        extra = self.heartbeat.payload() if self.heartbeat else None
        return promtext.render(self._tel, extra=extra, histograms=_HISTOGRAMS)

    def quality_reference(self) -> Tuple[Dict[str, Any], int]:
        """``GET /quality_reference``: the frozen reference, for another
        replica's ``--quality_reference``; 404 with the quality plane off,
        409 before a reference froze."""
        if self.quality is None:
            return {"error": "quality plane off; boot with --serve_quality on"}, 404
        payload = self.quality.reference_payload()
        if payload is None:
            return {
                "error": (
                    f"no reference frozen yet; serve at least {self.quality.window} requests "
                    "or load one with --quality_reference"
                )
            }, 409
        return payload, 200

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
        self.lifecycle.start()
        if self.config.serve_tier == "encode":
            # an encode tier's whole request path is POST /encode: its
            # width-1 encode runs once before ready
            self.engine.warm_encode_one()
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
        # an in-flight canary aborts first (shutdown is not a verdict), so
        # the drain sees only real work
        self.lifecycle.stop()
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
    it)."""
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
        if server.tenants.multi:
            shapes = ", ".join(
                f"{s.name}(w={s.weight:g}" + (f", {s.rps:g}rps" if s.limited else "")
                + (f", model={s.model}" if s.model else "") + ")"
                for s in server.tenants.specs()
            )
            print(
                f"sat_tpu_torch: multi-tenant plane active — {shapes}; default tenant {server.tenants.default!r}",
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
