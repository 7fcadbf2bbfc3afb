"""HTTP frontend for the captioning service — the port of ``sat_tpu.serve.server``.

A stdlib ``ThreadingHTTPServer``: request threads decode the image and
park on an Event while the batcher owns the device.

* ``POST /caption`` — body: image bytes (JPEG/PNG).  200 →
  ``{"captions": [{"caption", "log_prob", "prob"}, ...beam-ordered],
  "bucket", "model_step"}``, the JAX server's payload (``bucket`` is the
  page width in continuous mode).  400 for an empty
  or undecodable body, 429 when the queue is full, 503 while draining,
  504 past the deadline (``X-Deadline-Ms`` or ``serve_deadline_ms``).
* ``GET /healthz`` — 200 ``{"status": "ok"}`` when ready, 503 otherwise.
* ``GET /stats`` — queue depth, requests served, batcher counters,
  ``fused_attend`` launches (unmasked and masked), the engine's
  ``encoder_quant`` and ``quantize_seconds`` and, in continuous mode, a
  ``slot_pool`` block.

``serve_mode="batch"`` dispatches whole padded batches
(:class:`MicroBatcher`); ``"continuous"`` seeds requests into a
:class:`PagedSlotPool` between fused decode windows
(:class:`ContinuousBatcher`).

Shutdown: SIGTERM/SIGINT (in :func:`serve`) or ``request_shutdown()``
flips readiness, drains the batcher, then closes the listener.
"""

from __future__ import annotations

import json
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

from ..config import Config
from ..data.vocabulary import Vocabulary
from ..ops.fused_attend import fused_attend
from .batcher import ContinuousBatcher, MicroBatcher, Rejected
from .engine import ServeEngine, check_ported, load_serving_state
from .slot_pool import PagedSlotPool


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "sat-torch-serve"

    def log_message(self, fmt, *args):  # per-request stderr noise: off
        pass

    def _reply(self, status: int, payload: Dict[str, Any]) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:
        app = self.server.app
        route = self.path.split("?", 1)[0]
        if route == "/healthz":
            payload, status = app.healthz()
            self._reply(status, payload)
        elif route == "/stats":
            self._reply(200, app.stats())
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    def do_POST(self) -> None:
        app = self.server.app
        if self.path.split("?", 1)[0] != "/caption":
            self._reply(404, {"error": f"no route {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            length = 0
        if length <= 0:
            self._reply(400, {"error": "empty body; POST image bytes"})
            return
        body = self.rfile.read(length)
        status, payload = app.handle_caption(body, self.headers.get("X-Deadline-Ms"))
        self._reply(status, payload)


class _HTTPServer(ThreadingHTTPServer):
    # listen backlog: a burst of connections beyond socketserver's default
    # of 5 waits in the kernel for the accept loop
    request_queue_size = 128
    daemon_threads = True


class CaptionServer:
    """The batcher plus the HTTP listener around a :class:`ServeEngine`."""

    # longest a request thread waits on an admitted request without a deadline
    DEFAULT_WAIT_S = 600.0

    def __init__(
        self,
        config: Config,
        engine: ServeEngine,
        port: Optional[int] = None,
        host: Optional[str] = None,
    ) -> None:
        self.config = config
        self.engine = engine
        self.pool: Optional[PagedSlotPool] = None
        if config.serve_mode == "continuous":
            self.pool = PagedSlotPool(
                engine, pages=config.serve_slot_pages, page_width=config.serve_page_width
            )
            self.batcher = ContinuousBatcher(
                engine, pool=self.pool, queue_depth=config.serve_queue_depth
            )
        else:
            self.batcher = MicroBatcher(engine)
        self._host = host if host is not None else config.serve_host
        self._requested_port = port if port is not None else config.serve_port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self._ready = False
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._served = 0

    @property
    def port(self) -> Optional[int]:
        return None if self._httpd is None else self._httpd.server_address[1]

    def handle_caption(self, body: bytes, deadline_ms=None) -> Tuple[int, Dict[str, Any]]:
        if not self._ready:
            return 503, {"error": "server is draining; not accepting work"}
        try:
            image = self.engine.preprocess(body)
        except ValueError as e:
            return 400, {"error": "bad image", "detail": f"cannot decode image bytes: {e}"}
        if deadline_ms is None or deadline_ms == "":
            budget_ms = self.config.serve_deadline_ms
        else:
            try:
                budget_ms = int(deadline_ms)
            except ValueError:
                return 400, {"error": "X-Deadline-Ms must be integer milliseconds"}
        deadline_unix = time.time() + budget_ms / 1e3 if budget_ms > 0 else None
        try:
            req = self.batcher.submit(image, deadline_unix=deadline_unix)
        except Rejected as e:
            return e.status, {"error": e.reason}
        wait_s = budget_ms / 1e3 + 5.0 if deadline_unix else self.DEFAULT_WAIT_S
        if not req.done.wait(timeout=wait_s):
            return 504, {"error": "request timed out in service"}
        if req.error is not None:
            return req.error[0], {"error": req.error[1]}
        with self._lock:
            self._served += 1
        payload = dict(req.result)
        payload["bucket"] = req.bucket
        payload["model_step"] = self.engine.step
        return 200, payload

    def healthz(self) -> Tuple[Dict[str, Any], int]:
        if self._ready:
            return {"status": "ok", "model_step": self.engine.step}, 200
        return {"status": "draining" if self._httpd else "stopped"}, 503

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            served = self._served
        counters = self.batcher.counter_snapshot()
        out = {
            "queue_depth": self.batcher.queue_depth(),
            "requests_served": served,
            "buckets": list(self.engine.buckets),
            "device": str(self.engine.device),
            "model_step": self.engine.step,
            "counters": counters,
            "kernels": {"fused_attend": {
                "launches": fused_attend.launches,
                "masked_launches": fused_attend.masked_launches,
            }},
            "engine": {
                "encoder_quant": self.engine.encoder_quant,
                "quantize_seconds": round(self.engine.quantize_seconds, 3),
            },
        }
        if self.pool is not None:
            out["slot_pool"] = {
                "slots": self.pool.slots,
                "pages": self.pool.pages,
                "page_width": self.pool.width,
                "occupancy": self.pool.occupancy(),
                "dispatches": counters.get("dispatches", 0),
                "steps": counters.get("steps", 0),
                "dispatches_per_k": {
                    str(k): counters.get(f"dispatch_k{k}", 0) for k in self.pool.decode_depths
                },
            }
        return out

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "CaptionServer":
        self.batcher.start()
        self._httpd = _HTTPServer((self._host, self._requested_port), _Handler)
        self._httpd.app = self
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="sat-torch-serve-http", daemon=True
        )
        self._http_thread.start()
        self._ready = True
        return self

    def request_shutdown(self) -> None:
        """Programmatic twin of SIGTERM."""
        self._stop.set()

    def shutdown(self) -> None:
        """Readiness flips first, the batcher completes everything
        admitted, then the listener closes."""
        if self._httpd is None:
            return
        self._ready = False
        self.batcher.drain()
        self._httpd.shutdown()
        if self._http_thread is not None:
            self._http_thread.join(timeout=10.0)
            self._http_thread = None
        self._httpd.server_close()
        self._httpd = None

    def serve_until_shutdown(self, poll_s: float = 0.1) -> None:
        """Block until ``request_shutdown()``, then drain."""
        try:
            while not self._stop.is_set():
                time.sleep(poll_s)
        finally:
            self.shutdown()


def serve(config: Config, model_file: Optional[str] = None, device=None) -> int:
    """CLI entry point: ``python -m sat_tpu_torch.cli --phase serve``.

    Lineage load → warm every bucket (batch mode) or the slot pool
    (continuous mode) → listen → drain on SIGTERM/SIGINT.  A knob not
    ported yet raises before anything loads."""
    check_ported(config)
    vocabulary = Vocabulary(config.vocabulary_size, config.vocabulary_file)
    state, source = load_serving_state(config, model_file=model_file, device=device)
    engine = ServeEngine(config, state, vocabulary, device=device)
    print(
        f"sat_tpu_torch: serving params from {source} (step {engine.step}) on {engine.device}",
        file=sys.stderr,
        flush=True,
    )
    if config.serve_mode == "batch":
        # continuous mode warms the slot pool instead, in the batcher's start
        engine.warmup()
    server = CaptionServer(config, engine).start()
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
    previous = {}
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            previous[sig] = signal.signal(sig, lambda *_: server.request_shutdown())
    try:
        server.serve_until_shutdown()
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
    print("sat_tpu_torch: serve drained cleanly", file=sys.stderr, flush=True)
    return 0
