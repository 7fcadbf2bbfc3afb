"""Health-weighted HTTP router over N captioning replicas — the port's copy
of ``sat_tpu.serve.router`` (docs/SERVING.md).

One ``CaptionServer`` caps goodput at one decode loop; the router is the
scale-out unit on top: a stdlib ``ThreadingHTTPServer`` (same concurrency
story as server.py — threads park on sockets, no async framework) that
fronts N replicas and owns four fleet-level decisions:

* **Fleet view** — a background poller folds each replica's ``/healthz``
  (one cheap fetch per tick: ``queue_depth``/``in_flight``/``serve_mode``
  are top-level there) plus a periodic ``/stats`` (request p50/p99, slot
  occupancy, recompile count) into one merged view, naming the slow
  replica with the SAME straggler rule as the train-side fleet plane
  (``telemetry.fleet.straggler_verdict``: worst strictly > median x
  factor, >= 2 reporters).
* **Weighted picks with hysteresis** — requests go to the replica with
  the least *effective* load ``(queue_depth + in_flight + 1) / weight``;
  degraded (wedge re-warm, burning SLO) and straggler replicas are
  weighted DOWN (``route_down_weight``), not blackholed — they still
  absorb load when the healthy replicas are deeper.  The previous pick
  is kept while it stays within ``route_hysteresis`` of the best, so
  near-ties don't flap the connection pools.
* **Coherent shedding at the edge** — a shed is ONE router-minted 429
  whose ``Retry-After`` comes from the fleet-wide p50 (median of replica
  request p50s), not N per-replica hints: clients back off against the
  fleet's service period, whichever replica happened to be full.
* **One retry, different replica** — connection-refused/reset and 5xx
  (and per-replica 429s) are retried on a different replica exactly
  once, with the inbound ``X-Request-Id`` propagated on both attempts so
  the per-replica ``access.jsonl`` traces stitch to this router's own
  hop records across the hop.

``POST /drain?replica=<name>`` takes replicas out one at a time for
deploys (409 while another drain is in flight), riding the existing
drain-to-completion machinery: locally spawned replicas get SIGTERM
(server.py's drain sequence), pre-started endpoints are held out of
rotation until observed idle.  A drained replica re-enters rotation when
its ``/healthz`` reports ready again (the redeployed process), or via
``POST /undrain``.

Torch-free by contract (tests/test_torch_scaffold.py): like the
``--supervise`` parent, the router must outlive exactly the failures a
wedged device runtime causes, so it never imports the device stack.
A CUDA context in the router would also take card memory that belongs
to the replicas.  The port's replicas answer ``/stats`` without
``compiles_since_ready`` (nothing is compiled ahead there); the fleet
view reads that field only where a replica reports it.
"""

from __future__ import annotations

import http.client
import json
import math
import os
import sys
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .. import telemetry
from ..config import Config
from ..resilience.preempt import GracefulShutdown
from ..telemetry import promtext, tracectx
from ..telemetry import run_id as _run_id
from ..telemetry.exporters import rotating_append
from ..telemetry.fleet import straggler_verdict
from .handoff import GRID_CONTENT_TYPE
from .replica import Endpoint, LocalFleet, parse_endpoints, probe_health
from .tenants import TenantRegistry

# statuses that justify the single cross-replica retry: the replica
# failed (5xx), refused (connection error maps to None), or shed (429 —
# another replica may have room, and if not the edge sheds coherently)
_RETRYABLE = frozenset({429})


# -- pure routing math (unit-tested without HTTP) ---------------------------


def replica_weight(
    degraded: bool, straggler: bool, down_weight: float
) -> float:
    """Routing weight in (0, 1]: healthy replicas weigh 1.0; each
    unhealth signal multiplies by ``down_weight`` — a degraded straggler
    is doubly discounted but never zero (down-weighted, not
    blackholed)."""
    weight = 1.0
    if degraded:
        weight *= down_weight
    if straggler:
        weight *= down_weight
    return weight


def effective_load(queue_depth: float, in_flight: float, weight: float) -> float:
    """Load a pick compares: outstanding work scaled by 1/weight.  The
    +1 is the request being placed — it makes an idle down-weighted
    replica rank below an idle healthy one instead of tying at 0."""
    if weight <= 0:
        return float("inf")  # sync-ok: host-side sentinel, no device value
    return (max(0.0, queue_depth) + max(0.0, in_flight) + 1.0) / weight


def pick_replica(
    loads: Dict[str, float], last: Optional[str], hysteresis: float
) -> Optional[str]:
    """Least-effective-load pick with stickiness: keep ``last`` while its
    load is within ``(1 + hysteresis)`` of the best, so near-ties don't
    flap picks (and connection reuse) between equally idle replicas."""
    if not loads:
        return None
    best = min(loads, key=loads.get)
    if last is not None and last in loads:
        if loads[last] <= loads[best] * (1.0 + hysteresis):
            return last
    return best


def tier_capable(tier: Optional[str], need: str) -> bool:
    """Whether a replica advertising ``tier`` can serve a ``need``
    (``encode``/``decode``) hop.  An unknown/None tier is treated as
    ``both`` — pre-tier replicas keep routing exactly as before."""
    return tier in (need, "both", None)


def merge_fleet(
    snapshots: Dict[str, Dict[str, Any]],
    drain_state: Dict[str, str],
    straggler_factor: float,
    down_weight: float,
) -> Dict[str, Any]:
    """Fold per-replica poll snapshots into the routing view (pure —
    the router unit tests drive every weighting edge case through
    here).  A replica is routable when it answered its last poll, calls
    itself ready, and is in rotation (not draining/drained); the
    straggler ruling runs over routable replicas' request p99s with the
    train-plane rule.  ``routable_encode``/``routable_decode`` carve the
    routable set by advertised tier for disaggregated fleets (a
    ``both`` replica appears in both)."""
    p99s = {
        name: snap["p99_ms"]
        for name, snap in snapshots.items()
        if snap.get("reachable")
        and snap.get("ready")
        and drain_state.get(name, "in") == "in"
        and snap.get("p99_ms") is not None
    }
    ruling = straggler_verdict(p99s, straggler_factor)
    replicas: Dict[str, Dict[str, Any]] = {}
    routable: List[str] = []
    routable_encode: List[str] = []
    routable_decode: List[str] = []
    p50s: List[float] = []
    for name, snap in snapshots.items():
        state = drain_state.get(name, "in")
        is_routable = bool(
            snap.get("reachable") and snap.get("ready") and state == "in"
        )
        is_straggler = bool(ruling["verdict"] and ruling.get("name") == name)
        weight = replica_weight(
            bool(snap.get("degraded")), is_straggler, down_weight
        )
        entry = dict(snap)
        entry.update(
            drain_state=state,
            routable=is_routable,
            straggler=is_straggler,
            weight=round(weight, 4),
            effective_load=(
                round(
                    effective_load(
                        snap.get("queue_depth", 0) or 0,
                        snap.get("in_flight", 0) or 0,
                        weight,
                    ),
                    4,
                )
                if is_routable
                else None
            ),
        )
        replicas[name] = entry
        if is_routable:
            routable.append(name)
            if tier_capable(snap.get("tier"), "encode"):
                routable_encode.append(name)
            if tier_capable(snap.get("tier"), "decode"):
                routable_decode.append(name)
            if snap.get("p50_ms") is not None:
                p50s.append(snap["p50_ms"])
    return {
        "replicas": replicas,
        "routable": routable,
        "routable_encode": routable_encode,
        "routable_decode": routable_decode,
        "straggler": ruling,
        "fleet_p50_ms": (
            round(float(np.median(p50s)), 3) if p50s else None  # sync-ok: host JSON scalars
        ),
        "queue_depth": int(
            sum(r.get("queue_depth", 0) or 0 for r in replicas.values())
        ),
        "in_flight": int(
            sum(r.get("in_flight", 0) or 0 for r in replicas.values())
        ),
    }


def fleet_tenants_cost(
    replicas: Dict[str, Dict[str, Any]]
) -> Dict[str, Dict[str, float]]:
    """Fan the per-replica ``tenants_cost`` blocks (cumulative metering
    snapshots polled off each replica's /stats) into one fleet-wide
    per-tenant view: every numeric field sums across replicas, because
    each replica's snapshot is cumulative for *its* share of the
    tenant's traffic.  Pure dict arithmetic — stays torch-free."""
    fleet: Dict[str, Dict[str, float]] = {}
    for snap in replicas.values():
        block = snap.get("tenants_cost")
        if not isinstance(block, dict):
            continue
        for tenant, row in block.items():
            if not isinstance(row, dict):
                continue
            agg = fleet.setdefault(str(tenant), {})
            for key, value in row.items():
                if isinstance(value, (int, float)) and not isinstance(
                    value, bool
                ):
                    agg[key] = round(agg.get(key, 0) + value, 3)
    return fleet


def fleet_quality(
    replicas: Dict[str, Dict[str, Any]]
) -> Dict[str, Any]:
    """Fan the per-replica ``quality`` blocks (telemetry/quality.py
    snapshots polled off each replica's /stats) into one fleet view.
    Counts (requests, outliers) sum; drift takes the WORST replica —
    PSI is a per-reference distance, so averaging replicas would let a
    healthy majority mask one drifting model.  Pure dict arithmetic,
    torch-free, like :func:`fleet_tenants_cost`."""
    out: Dict[str, Any] = {}
    requests = outliers = 0
    psi_max = None
    worst = ""
    per_replica: Dict[str, Any] = {}
    for name, snap in replicas.items():
        block = snap.get("quality")
        if not isinstance(block, dict):
            continue
        requests += int(block.get("requests", 0) or 0)
        outliers += int(block.get("outliers", 0) or 0)
        psi = block.get("psi_max")
        if isinstance(psi, (int, float)) and not isinstance(psi, bool):
            if psi_max is None or psi > psi_max:
                psi_max, worst = float(psi), name  # sync-ok: host JSON scalar
        per_replica[name] = {
            "psi_max": psi,
            "requests": block.get("requests", 0),
            "outliers": block.get("outliers", 0),
            "reference": block.get("reference") or None,
        }
    if not per_replica:
        return out
    out = {
        "requests": requests,
        "outliers": outliers,
        "psi_max": round(psi_max, 6) if psi_max is not None else None,
        "worst_replica": worst or None,
        "replicas": per_replica,
    }
    return out


def _percentiles_ms(tel, name: str) -> Optional[Dict[str, Any]]:
    """p50/p95/p99 (ms) of a router span; host telemetry ring only."""
    data = np.asarray(tel.durations_ns(name), np.float64)  # sync-ok: host telemetry ring
    if data.size == 0:
        return None
    data = np.sort(data) / 1e6
    def pct(p: float) -> float:
        idx = min(data.size - 1, int(p / 100.0 * data.size))
        return round(float(data[idx]), 3)  # sync-ok: host numpy percentile
    return {
        "count": int(data.size),
        "p50": pct(50),
        "p95": pct(95),
        "p99": pct(99),
    }


def _empty_snapshot() -> Dict[str, Any]:
    return {
        "reachable": False,
        "ready": False,
        "status": "unknown",
        "degraded": False,
        "tier": None,
        "queue_depth": 0,
        "in_flight": 0,
        "serve_mode": None,
        "p50_ms": None,
        "p99_ms": None,
        "slot_busy": None,
        "compiles_since_ready": None,
        "failures": 0,
    }


class _RouterHTTPServer(ThreadingHTTPServer):
    # listen backlog, as the replicas' server takes: with socketserver's
    # default of 5 the kernel resets the connections of a burst that
    # overflows it before the accept loop drains them
    request_queue_size = 128
    daemon_threads = True


class _ConnPool:
    """Keep-alive upstream connections to one replica: checkout/checkin
    a stack of ``http.client`` connections, drop broken ones on the
    floor (the checkout mints a fresh connection when the stack is
    empty).  Reconnects are counted — a flapping replica shows up as a
    reconnect storm in /stats before it shows up anywhere else."""

    def __init__(self, endpoint: Endpoint, timeout_s: float) -> None:
        self.endpoint = endpoint
        self.timeout_s = timeout_s
        self._idle: List[http.client.HTTPConnection] = []
        self._lock = threading.Lock()
        self.connects = 0

    def checkout(self) -> Tuple[http.client.HTTPConnection, bool]:
        """Returns ``(conn, reused)``: a reused idle connection may be a
        stale keep-alive whose peer died since checkin — a socket-level
        failure on its first use is retryable on a fresh connection, a
        failure on a brand-new socket is the replica actually down."""
        with self._lock:
            if self._idle:
                return self._idle.pop(), True
            self.connects += 1
        return http.client.HTTPConnection(
            self.endpoint.host, self.endpoint.port, timeout=self.timeout_s
        ), False

    def checkin(self, conn: http.client.HTTPConnection) -> None:
        with self._lock:
            self._idle.append(conn)

    def discard(self, conn: http.client.HTTPConnection) -> None:
        try:
            conn.close()
        except Exception:
            pass

    def close_all(self) -> None:
        with self._lock:
            idle, self._idle = self._idle, []
        for conn in idle:
            self.discard(conn)


class _RouterHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "sat-route"

    def log_message(self, fmt, *args):  # stderr per-request noise: off
        pass

    def _send(
        self,
        status: int,
        body: bytes,
        ctype: str,
        rid: str,
        headers: Optional[Dict[str, str]] = None,
    ) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.send_header(tracectx.TRACE_HEADER, rid)
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _reply(self, status, payload, rid, headers=None) -> None:
        self._send(
            status, json.dumps(payload).encode(), "application/json", rid,
            headers=headers,
        )

    def do_GET(self) -> None:
        app = self.server.app
        rid = tracectx.ensure_id(self.headers.get(tracectx.TRACE_HEADER))
        route = self.path.split("?", 1)[0]
        if route == "/healthz":
            payload, status = app.healthz()
            self._reply(status, payload, rid)
        elif route == "/stats":
            self._reply(200, app.stats(), rid)
        elif route == "/metrics":
            self._send(
                200, app.metrics_text().encode(), promtext.CONTENT_TYPE, rid
            )
        else:
            self._reply(404, {"error": f"no route {self.path}"}, rid)

    def do_POST(self) -> None:
        app = self.server.app
        rid = tracectx.ensure_id(self.headers.get(tracectx.TRACE_HEADER))
        route, _, query = self.path.partition("?")
        if route in ("/drain", "/undrain"):
            params = urllib.parse.parse_qs(query)
            name = (params.get("replica") or [""])[0]
            status, payload = (
                app.start_drain(name)
                if route == "/drain"
                else app.undrain(name)
            )
            self._reply(status, payload, rid)
            return
        if route in ("/reload", "/promote", "/rollback"):
            params = urllib.parse.parse_qs(query)
            name = (params.get("replica") or [""])[0]
            status, payload = app.admin_lifecycle(route[1:], name or None)
            self._reply(status, payload, rid)
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
        status, payload_bytes, ctype, headers = app.proxy_caption(
            body,
            rid,
            content_type=self.headers.get("Content-Type"),
            deadline_ms=self.headers.get("X-Deadline-Ms"),
            tenant=self.headers.get("X-Tenant"),
            model=self.headers.get("X-Model"),
        )
        self._send(status, payload_bytes, ctype, rid, headers=headers)


class Router:
    """Fleet view + weighted proxy + drain sequencing over N replicas."""

    def __init__(
        self,
        config: Config,
        endpoints: List[Endpoint],
        fleet: Optional[LocalFleet] = None,
        host: Optional[str] = None,
        port: Optional[int] = None,
    ) -> None:
        if not endpoints:
            raise ValueError("Router needs at least one replica endpoint")
        self.config = config
        self.endpoints = {e.name: e for e in endpoints}
        self.fleet = fleet
        # tenant plane at the edge: the router enforces each tenant's
        # token-bucket quota BEFORE a pick so over-quota floods are shed
        # here (tenant-scoped 429) instead of consuming replica queue
        # space N different ways downstream.  "" = single-tenant: no
        # bucket, no per-tenant counters, bit-identical routing.
        self.tenants = TenantRegistry.parse(config.tenants)
        self._tel = telemetry.get()
        self._host = host if host is not None else config.serve_host
        self._requested_port = port if port is not None else config.route_port
        timeout_s = config.route_upstream_timeout_s
        self._pools = {
            e.name: _ConnPool(e, timeout_s) for e in endpoints
        }
        self._snap_lock = threading.Lock()
        # seed each snapshot with the endpoint's declared tier so tier
        # routing is right from the first request even before /healthz
        # confirms (the poll overwrites with the replica's own answer)
        self._snapshots: Dict[str, Dict[str, Any]] = {
            name: dict(_empty_snapshot(), tier=e.tier)
            for name, e in self.endpoints.items()
        }
        self._drain_lock = threading.Lock()
        self._drain_state: Dict[str, str] = {
            name: "in" for name in self.endpoints
        }
        self._drain_log: List[Dict[str, Any]] = []
        self._view: Dict[str, Any] = merge_fleet(
            self._snapshots,
            self._drain_state,
            config.straggler_factor,
            config.route_down_weight,
        )
        self._pick_lock = threading.Lock()
        self._last_pick: Optional[str] = None
        # requests THIS router has in flight per replica right now: the
        # polled view refreshes only every poll interval, so without
        # local bookkeeping a burst between ticks herds onto whichever
        # replica the stale view ranked best (and hysteresis pins it)
        self._outstanding: Dict[str, int] = {
            name: 0 for name in self.endpoints
        }
        self._tick = 0
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self._poll_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._t_start = time.time()
        tdir = config.telemetry_dir or os.path.join(
            config.summary_dir, "telemetry"
        )
        self._access_path = os.path.join(tdir, "access.jsonl")
        self._access_cap = int(config.telemetry_log_cap_mb * 1e6)

    # -- fleet view (poller thread) ----------------------------------------

    @property
    def port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd else None

    def view(self) -> Dict[str, Any]:
        with self._snap_lock:
            return self._view

    def _rebuild_view(self) -> None:
        """Called with fresh snapshot data; swaps the routing view
        atomically under the snapshot lock."""
        with self._drain_lock:
            drain_state = dict(self._drain_state)
        with self._snap_lock:
            self._view = merge_fleet(
                self._snapshots,
                drain_state,
                self.config.straggler_factor,
                self.config.route_down_weight,
            )

    def poll_once(self) -> None:
        """One poller tick: /healthz per replica (cheap — the load
        signals are top-level there), /stats every Nth tick for the
        latency/occupancy detail, then drain progression + view swap."""
        self._tick += 1
        with_stats = (
            (self._tick - 1) % self.config.route_stats_every
        ) == 0  # first tick and every Nth after (every tick when N=1)
        for name, endpoint in self.endpoints.items():
            health = probe_health(endpoint, timeout_s=2.0)
            with self._snap_lock:
                snap = dict(self._snapshots[name])
            if health is None:
                snap["reachable"] = False
                snap["ready"] = False
                snap["status"] = "unreachable"
                snap["failures"] = snap.get("failures", 0) + 1
            else:
                snap.update(
                    reachable=True,
                    ready=bool(health.get("ready")),
                    status=str(health.get("status", "")),
                    degraded=health.get("status") == "degraded",
                    queue_depth=int(health.get("queue_depth", 0) or 0),
                    in_flight=int(health.get("in_flight", 0) or 0),
                    serve_mode=health.get("serve_mode"),
                    tier=health.get("tier") or endpoint.tier,
                    failures=0,
                )
                if with_stats:
                    self._merge_stats(endpoint, snap)
            with self._snap_lock:
                self._snapshots[name] = snap
        self._advance_drains()
        self._rebuild_view()

    def _merge_stats(self, endpoint: Endpoint, snap: Dict[str, Any]) -> None:
        """Fold the heavier /stats detail into a snapshot (best-effort:
        a replica that answers /healthz but not /stats keeps routing on
        its load signals alone)."""
        conn = http.client.HTTPConnection(
            endpoint.host, endpoint.port, timeout=2.0
        )
        try:
            conn.request("GET", "/stats")
            resp = conn.getresponse()
            stats = json.loads(resp.read())
        except (OSError, ValueError):
            return
        finally:
            conn.close()
        if not isinstance(stats, dict):
            return
        lat = (stats.get("latency_ms") or {}).get("serve/request") or {}
        if "p50" in lat:
            snap["p50_ms"] = float(lat["p50"])  # sync-ok: host JSON scalar
        if "p99" in lat:
            snap["p99_ms"] = float(lat["p99"])  # sync-ok: host JSON scalar
        pool = stats.get("slot_pool")
        if isinstance(pool, dict):
            snap["slot_busy"] = pool.get("busy")
        if "compiles_since_ready" in stats:
            snap["compiles_since_ready"] = stats["compiles_since_ready"]
        cost = stats.get("tenants_cost")
        if isinstance(cost, dict):
            snap["tenants_cost"] = cost
        cap = stats.get("capacity")
        if isinstance(cap, dict) and "headroom_pct" in cap:
            snap["capacity_headroom_pct"] = cap["headroom_pct"]
        quality = stats.get("quality")
        if isinstance(quality, dict):
            snap["quality"] = quality

    def _advance_drains(self) -> None:
        """Drain progression: a locally spawned replica is drained when
        its process exits (SIGTERM ran the drain-to-completion
        sequence); an endpoint replica when it is observed idle or gone.
        A drained replica whose /healthz reports ready again (the
        redeploy) re-enters rotation."""
        with self._drain_lock:
            states = dict(self._drain_state)
        for name, state in states.items():
            with self._snap_lock:
                snap = self._snapshots[name]
            if state == "draining":
                proc = self.fleet.by_name(name) if self.fleet else None
                if proc is not None:
                    done = not proc.alive
                else:
                    done = (not snap["reachable"]) or (
                        snap["queue_depth"] == 0
                        and snap["in_flight"] == 0
                        and not snap["ready"]
                    )
                if done:
                    self._set_drain_state(name, "drained")
            elif state == "drained":
                if snap["reachable"] and snap["ready"]:
                    # the redeployed process is up: back into rotation
                    self._set_drain_state(name, "in")

    def _set_drain_state(self, name: str, state: str) -> None:
        with self._drain_lock:
            self._drain_state[name] = state
            self._drain_log.append(
                {
                    "replica": name,
                    "state": state,
                    "time_unix": round(time.time(), 3),
                }
            )

    def _poll_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception as e:  # poller must never die
                print(
                    f"sat_tpu_torch: router poll tick failed ({e!r})",
                    file=sys.stderr,
                    flush=True,
                )
            self._stop.wait(self.config.route_poll_interval_s)

    def _mark_unreachable(self, name: str) -> None:
        """A forward just failed at the socket: reflect it immediately so
        the next pick (including this request's retry) excludes the
        replica instead of waiting out a poll interval."""
        with self._snap_lock:
            snap = dict(self._snapshots[name])
            snap["reachable"] = False
            snap["ready"] = False
            snap["status"] = "unreachable"
            snap["failures"] = snap.get("failures", 0) + 1
            self._snapshots[name] = snap
        self._rebuild_view()

    # -- picks + proxy (HTTP worker threads) -------------------------------

    def _loads(
        self,
        view: Dict[str, Any],
        exclude: Optional[str] = None,
        tier: Optional[str] = None,
    ) -> Dict[str, float]:
        """Per-replica effective load for a pick: the polled view's
        (queue + in_flight + 1)/weight PLUS our own outstanding proxied
        requests scaled the same way, so picks balance within a poll
        interval instead of herding on the stale snapshot.  ``tier``
        restricts candidates to the encode-/decode-capable subset."""
        with self._pick_lock:
            outstanding = dict(self._outstanding)
        candidates = (
            view["routable"]
            if tier is None
            else view.get(f"routable_{tier}", view["routable"])
        )
        loads = {}
        for name in candidates:
            if name == exclude:
                continue
            entry = view["replicas"][name]
            weight = max(float(entry["weight"]), 1e-9)  # sync-ok: host JSON scalar
            loads[name] = (
                entry["effective_load"] + outstanding.get(name, 0) / weight
            )
        return loads

    def _note_outstanding(self, name: str, delta: int) -> None:
        with self._pick_lock:
            self._outstanding[name] = max(
                0, self._outstanding.get(name, 0) + delta
            )

    def pick(
        self,
        exclude: Optional[str] = None,
        tier: Optional[str] = None,
    ) -> Optional[str]:
        view = self.view()
        loads = self._loads(view, exclude=exclude, tier=tier)
        with self._pick_lock:
            # a retry pick is load-greedy (no stickiness): the sticky
            # choice is exactly the replica that just failed
            last = self._last_pick if exclude is None else None
            # stickiness exists to damp rank flapping from the polled
            # view's noisy terms; our own outstanding counts are exact,
            # so the band must not apply once the sticky replica owes
            # more proxied work than the least-loaded candidate — under
            # a burst it would otherwise run (1 + hysteresis)x ahead
            # before the pick moved on
            if last is not None and last in loads:
                best = min(loads, key=loads.get)
                if (self._outstanding.get(last, 0)
                        > self._outstanding.get(best, 0)):
                    last = None
            choice = pick_replica(
                loads, last, self.config.route_hysteresis
            )
            if choice is not None and exclude is None:
                self._last_pick = choice
            return choice

    def _fleet_retry_after_s(self) -> int:
        """The coherent shed hint: about one fleet service period —
        ceil of the fleet-wide p50 — clamped to [1, 30] s (RFC 7231
        whole seconds; never 0, never 'go away for minutes')."""
        p50 = self.view().get("fleet_p50_ms")
        if not p50:
            return 1
        return int(min(30, max(1, math.ceil(p50 / 1000.0))))

    def _forward(
        self,
        name: str,
        body: bytes,
        rid: str,
        content_type: Optional[str],
        deadline_ms: Optional[str],
        tenant: Optional[str] = None,
        model: Optional[str] = None,
        path: str = "/caption",
    ) -> Tuple[int, bytes, str, Dict[str, str]]:
        """One upstream attempt over the keep-alive pool.  Raises
        OSError/HTTPException on socket-level failure (the retryable
        class); HTTP statuses — including replica 429/503 — return."""
        headers = {
            tracectx.TRACE_HEADER: rid,
            "Content-Type": content_type or "application/octet-stream",
            "Content-Length": str(len(body)),
        }
        if deadline_ms:
            headers["X-Deadline-Ms"] = deadline_ms
        if tenant:
            headers["X-Tenant"] = tenant
        if model:
            headers["X-Model"] = model
        pool = self._pools[name]
        while True:
            conn, reused = pool.checkout()
            try:
                conn.request("POST", path, body=body, headers=headers)
                resp = conn.getresponse()
                data = resp.read()
                ctype = resp.getheader("Content-Type") or "application/json"
                extra = {}
                for header in ("Retry-After", "X-Shed-Scope"):
                    value = resp.getheader(header)
                    if value:
                        extra[header] = value
                pool.checkin(conn)
                return resp.status, data, ctype, extra
            except (OSError, http.client.HTTPException):
                pool.discard(conn)
                if not reused:
                    raise
                # stale keep-alive: the peer restarted (or dropped the
                # idle socket) since checkin.  The request never reached
                # a live server, so one same-replica retry on a FRESH
                # connection is safe — and for a single-replica tier it
                # is the only retry there is.
                self._tel.count("route/stale_conn_retries")

    def _forward_attempts(
        self,
        path: str,
        body: bytes,
        rid: str,
        content_type: Optional[str],
        deadline_ms: Optional[str],
        tenant: Optional[str],
        model: Optional[str],
        tier: Optional[str] = None,
    ) -> Tuple[int, bytes, str, Dict[str, str], List[str], int]:
        """One hop's pick→forward with at most one retry on a DIFFERENT
        replica (refused/5xx/replica-shed), optionally restricted to a
        tier-capable subset.  Returns ``(status, body, ctype, headers,
        attempts, upstream_ns)``; status 0 means no replica answered."""
        upstream_ns = 0
        attempts: List[str] = []
        status, data, ctype, extra = 0, b"", "application/json", {}
        first = self.pick(tier=tier)
        for name in (first, None):
            if name is None:  # retry pick, different replica
                name = self.pick(
                    exclude=attempts[0] if attempts else None, tier=tier
                )
                if name is None or name in attempts:
                    break
                self._tel.count("route/retries")
            attempts.append(name)
            tu0 = time.perf_counter_ns()
            self._note_outstanding(name, +1)
            try:
                status, data, ctype, extra = self._forward(
                    name, body, rid, content_type, deadline_ms,
                    tenant=tenant, model=model, path=path,
                )
            except (OSError, http.client.HTTPException):
                self._tel.count("route/upstream_errors")
                self._mark_unreachable(name)
                status, data = 0, b""
                continue  # connection-level failure: try the other one
            finally:
                self._note_outstanding(name, -1)
                upstream_ns += time.perf_counter_ns() - tu0
            if status >= 500 or status in _RETRYABLE:
                self._tel.count("route/upstream_5xx" if status >= 500
                                else "route/upstream_sheds")
                if status == 429 and extra.get("X-Shed-Scope") == "tenant":
                    # a tenant-quota 429 is about the TENANT, not the
                    # replica: another replica enforces the same quota,
                    # so the retry would only double-charge the bucket
                    break
                continue
            break
        return status, data, ctype, extra, attempts, upstream_ns

    def _proxy_disagg(
        self,
        t0: int,
        body: bytes,
        rid: str,
        content_type: Optional[str],
        deadline_ms: Optional[str],
        tenant: Optional[str],
        model: Optional[str],
        tname: Optional[str],
    ) -> Tuple[int, bytes, str, Dict[str, str]]:
        """Disaggregated image path: hop 1 picks an encode-capable
        replica and POSTs ``/encode`` (image → grid frame); hop 2 picks
        a decode-capable replica and POSTs the grid to ``/caption``.
        Each hop gets the standard one-retry-different-replica; a
        missing tier sheds a 429 (capacity will return — the chaos
        campaign asserts this path mints no 5xx) instead of a 502."""
        view = self.view()
        if not view["routable_encode"]:
            return self._shed_tier(t0, rid, "encode")
        if not view["routable_decode"]:
            return self._shed_tier(t0, rid, "decode")
        self._tel.count("route/handoffs")
        e_status, e_data, e_ctype, e_extra, e_attempts, e_ns = (
            self._forward_attempts(
                "/encode", body, rid, content_type, deadline_ms,
                tenant, model, tier="encode",
            )
        )
        if e_status == 0:
            return self._finish(
                t0, rid, 502, e_attempts[-1] if e_attempts else None, e_ns,
                json.dumps(
                    {
                        "error": "no encode replica answered",
                        "request_id": rid,
                        "attempted": e_attempts,
                    }
                ).encode(),
                "application/json",
                {"Retry-After": str(self._fleet_retry_after_s())},
            )
        if e_status == 429:
            if e_extra.get("X-Shed-Scope") == "tenant":
                if tname is not None:
                    self._tel.count(f"route/tenant_{tname}_shed")
                return self._finish(
                    t0, rid, e_status, e_attempts[-1], e_ns, e_data,
                    e_ctype, e_extra,
                )
            return self._shed(t0, rid, replica=e_attempts[-1],
                              upstream_ns=e_ns)
        if e_status != 200:
            # encode replica's own verdict (e.g. 400 bad image): pass it
            # through — the decode hop can't fix a bad input
            return self._finish(
                t0, rid, e_status, e_attempts[-1], e_ns, e_data, e_ctype,
                e_extra, retried=len(e_attempts) > 1,
            )
        d_status, d_data, d_ctype, d_extra, d_attempts, d_ns = (
            self._forward_attempts(
                "/caption", e_data, rid, GRID_CONTENT_TYPE, deadline_ms,
                tenant, model, tier="decode",
            )
        )
        upstream_ns = e_ns + d_ns
        attempts = e_attempts + d_attempts
        if d_status == 0:
            return self._finish(
                t0, rid, 502, d_attempts[-1] if d_attempts else None,
                upstream_ns,
                json.dumps(
                    {
                        "error": "no decode replica answered",
                        "request_id": rid,
                        "attempted": attempts,
                    }
                ).encode(),
                "application/json",
                {"Retry-After": str(self._fleet_retry_after_s())},
            )
        if d_status == 429:
            if d_extra.get("X-Shed-Scope") == "tenant":
                if tname is not None:
                    self._tel.count(f"route/tenant_{tname}_shed")
                return self._finish(
                    t0, rid, d_status, d_attempts[-1], upstream_ns, d_data,
                    d_ctype, d_extra,
                )
            return self._shed(t0, rid, replica=d_attempts[-1],
                              upstream_ns=upstream_ns)
        headers = dict(d_extra)
        if e_attempts:
            headers["X-Routed-Encode-Replica"] = e_attempts[-1]
        return self._finish(
            t0, rid, d_status, d_attempts[-1], upstream_ns, d_data,
            d_ctype, headers, retried=len(attempts) > 2,
        )

    def _shed_tier(
        self, t0: int, rid: str, tier: str
    ) -> Tuple[int, bytes, str, Dict[str, str]]:
        """Tier-starved shed: the fleet is up but no routable replica
        can run this hop (e.g. the encode tier is mid-respawn).  A 429
        with the fleet hint — capacity returns on the respawn, so
        clients back off rather than fail over a 5xx."""
        self._tel.count("route/sheds")
        self._tel.count(f"route/tier_{tier}_starved")
        secs = self._fleet_retry_after_s()
        body = json.dumps(
            {
                "error": f"no routable {tier}-capable replica; retry later",
                "retry_after_ms": secs * 1000,
                "shed_scope": "tier",
                "tier": tier,
                "request_id": rid,
            }
        ).encode()
        return self._finish(
            t0, rid, 429, None, 0, body, "application/json",
            {"Retry-After": str(secs), "X-Shed-Scope": "tier"},
        )

    def proxy_caption(
        self,
        body: bytes,
        rid: str,
        content_type: Optional[str] = None,
        deadline_ms: Optional[str] = None,
        tenant: Optional[str] = None,
        model: Optional[str] = None,
    ) -> Tuple[int, bytes, str, Dict[str, str]]:
        """Route one /caption: weighted pick, at most one retry on a
        DIFFERENT replica for refused/5xx/shed, coherent 429 at the
        edge.  With a tenant registry, each tenant's token-bucket quota
        is enforced BEFORE the pick — an over-quota request is a
        tenant-scoped 429 (``X-Shed-Scope: tenant``, ``Retry-After``
        from THAT bucket's refill) that never consumes replica queue
        space.  Returns (status, body, content_type, extra_headers)."""
        t0 = time.perf_counter_ns()
        self._tel.count("route/requests")
        tname: Optional[str] = None
        if self.tenants.multi:
            spec = self.tenants.resolve(tenant)
            tname = spec.name
            if tenant and not self.tenants.known(tenant):
                self._tel.count("route/tenant_unknown")
            self._tel.count(f"route/tenant_{tname}_requests")
            if not self.tenants.try_admit(tname):
                return self._shed_tenant(t0, rid, spec)
        view = self.view()
        if not view["routable"]:
            self._tel.count("route/no_replicas")
            return self._finish(
                t0, rid, 503, None, 0,
                json.dumps(
                    {"error": "no routable replicas", "request_id": rid}
                ).encode(),
                "application/json",
                {"Retry-After": str(self._fleet_retry_after_s())},
            )
        shed_depth = self.config.route_shed_depth
        if shed_depth > 0 and all(
            (view["replicas"][n]["queue_depth"] or 0) >= shed_depth
            for n in view["routable"]
        ):
            # proactive edge shed: every replica's queue is already at
            # the configured depth — one coherent 429, no forwarding
            return self._shed(t0, rid)
        # tiered fleet? image requests go two-hop (encode tier mints the
        # grid, decode tier captions it); grid-carrying requests — from
        # a client or our own second hop — go straight to decode
        base_ctype = (content_type or "").split(";", 1)[0].strip()
        grid_in = base_ctype == GRID_CONTENT_TYPE
        tiered = len(view["routable_encode"]) != len(view["routable"]) or (
            len(view["routable_decode"]) != len(view["routable"])
        )
        if grid_in:
            if not view["routable_decode"]:
                return self._shed_tier(t0, rid, "decode")
            hop_tier: Optional[str] = "decode" if tiered else None
        elif tiered:
            return self._proxy_disagg(
                t0, body, rid, content_type, deadline_ms, tenant, model,
                tname,
            )
        else:
            hop_tier = None
        status, data, ctype, extra, attempts, upstream_ns = (
            self._forward_attempts(
                "/caption", body, rid, content_type, deadline_ms,
                tenant, model, tier=hop_tier,
            )
        )
        if status == 0:
            # both attempts (or the only routable replica) refused
            return self._finish(
                t0, rid, 502, attempts[-1] if attempts else None,
                upstream_ns,
                json.dumps(
                    {
                        "error": "no replica answered",
                        "request_id": rid,
                        "attempted": attempts,
                    }
                ).encode(),
                "application/json",
                {"Retry-After": str(self._fleet_retry_after_s())},
            )
        if status == 429:
            if extra.get("X-Shed-Scope") == "tenant":
                # the replica shed ONE tenant's quota/queue: pass it
                # through verbatim (scope + that tenant's Retry-After) —
                # re-minting a fleet-coherent 429 would tell a
                # well-behaved tenant the whole fleet is saturated
                if tname is not None:
                    self._tel.count(f"route/tenant_{tname}_shed")
                return self._finish(
                    t0, rid, status, attempts[-1], upstream_ns, data,
                    ctype, extra,
                )
            # coherent edge shed: ONE 429 with the fleet-wide hint, not
            # whichever per-replica Retry-After the last attempt carried
            return self._shed(t0, rid, replica=attempts[-1],
                              upstream_ns=upstream_ns)
        return self._finish(
            t0, rid, status, attempts[-1], upstream_ns, data, ctype, extra,
            retried=len(attempts) > 1,
        )

    def _shed(
        self,
        t0: int,
        rid: str,
        replica: Optional[str] = None,
        upstream_ns: int = 0,
    ) -> Tuple[int, bytes, str, Dict[str, str]]:
        self._tel.count("route/sheds")
        secs = self._fleet_retry_after_s()
        body = json.dumps(
            {
                "error": "fleet saturated; retry later",
                "retry_after_ms": secs * 1000,
                "shed_scope": "global",
                "request_id": rid,
            }
        ).encode()
        return self._finish(
            t0, rid, 429, replica, upstream_ns, body, "application/json",
            {"Retry-After": str(secs), "X-Shed-Scope": "global"},
        )

    def _shed_tenant(
        self, t0: int, rid: str, spec
    ) -> Tuple[int, bytes, str, Dict[str, str]]:
        """Tenant-scoped edge shed: the bucket is dry, so the hint is
        THAT bucket's refill time — not the fleet p50, which says
        nothing about when this tenant's quota frees up."""
        self._tel.count("route/sheds")
        self._tel.count(f"route/tenant_{spec.name}_shed")
        retry_s = self.tenants.retry_after_s(spec.name)
        secs = int(min(30, max(1, math.ceil(retry_s))))
        body = json.dumps(
            {
                "error": (
                    f"tenant {spec.name!r} admission quota exhausted "
                    f"({spec.rps:g} rps); shed"
                ),
                "retry_after_ms": max(1, int(retry_s * 1000.0) + 1),
                "shed_scope": "tenant",
                "tenant": spec.name,
                "request_id": rid,
            }
        ).encode()
        return self._finish(
            t0, rid, 429, None, 0, body, "application/json",
            {"Retry-After": str(secs), "X-Shed-Scope": "tenant"},
        )

    def _finish(
        self,
        t0: int,
        rid: str,
        status: int,
        replica: Optional[str],
        upstream_ns: int,
        data: bytes,
        ctype: str,
        extra: Dict[str, str],
        retried: bool = False,
    ) -> Tuple[int, bytes, str, Dict[str, str]]:
        """Every proxied reply funnels through here: hop spans (request /
        upstream / overhead — overhead is what the router itself cost),
        counters, and the router's own access.jsonl hop record keyed by
        the SAME trace id the replica logged."""
        total_ns = time.perf_counter_ns() - t0
        self._tel.record("route/request", t0, total_ns)
        if upstream_ns:
            self._tel.record("route/upstream", t0, upstream_ns)
        self._tel.record(
            "route/overhead", t0, max(0, total_ns - upstream_ns)
        )
        if status >= 500:
            self._tel.count("route/http_5xx")
        record = {
            "run_id": _run_id(),
            "trace_id": rid,
            "hop": "route",
            "wall_time": round(time.time(), 6),
            "status": int(status),
            "total_ms": round(total_ns / 1e6, 3),
            "upstream_ms": round(upstream_ns / 1e6, 3),
            "replica": replica,
            "retried": retried,
        }
        try:
            rotating_append(
                self._access_path, json.dumps(record), self._access_cap
            )
        except Exception:
            pass  # tracing must never fail a request
        headers = dict(extra)
        if retried:
            headers["X-Routed-Retry"] = "1"
        if replica:
            headers["X-Routed-Replica"] = replica
        return status, data, ctype, headers

    # -- lifecycle admin fan-out --------------------------------------------

    def admin_lifecycle(
        self, action: str, name: Optional[str] = None
    ) -> Tuple[int, Dict[str, Any]]:
        """POST /reload | /promote | /rollback, optionally scoped with
        ``?replica=<name>``: forward the verb to one replica or to every
        routable one and aggregate.  200 when every targeted replica
        answered 200; 502 otherwise (partial results included — a fleet
        where only some replicas promoted needs operator eyes, not a
        retry loop)."""
        if name is not None:
            if name not in self.endpoints:
                return 404, {
                    "error": f"unknown replica {name!r}",
                    "replicas": sorted(self.endpoints),
                }
            targets = [name]
        else:
            targets = list(self.view()["routable"])
            if not targets:
                return 503, {"error": "no routable replicas"}
        self._tel.count(f"route/lifecycle_{action}")
        results: Dict[str, Dict[str, Any]] = {}
        all_ok = True
        for target in targets:
            endpoint = self.endpoints[target]
            # promote/rollback block on the replica until the verdict
            # lands (canary drain + swap), so this hop outlives the
            # replica's own decision timeout
            conn = http.client.HTTPConnection(
                endpoint.host, endpoint.port, timeout=240.0
            )
            try:
                conn.request(
                    "POST", f"/{action}", headers={"Content-Length": "0"}
                )
                resp = conn.getresponse()
                raw = resp.read()
                try:
                    body = json.loads(raw)
                except ValueError:
                    body = {"raw": raw.decode("utf-8", "replace")}
                results[target] = {"status": resp.status, "body": body}
                if resp.status != 200:
                    all_ok = False
            except (OSError, http.client.HTTPException) as e:
                results[target] = {"status": 0, "error": str(e)}
                all_ok = False
            finally:
                conn.close()
        return (200 if all_ok else 502), {
            "action": action,
            "replicas": results,
            "ok": all_ok,
        }

    # -- drain sequencing ---------------------------------------------------

    def start_drain(self, name: str) -> Tuple[int, Dict[str, Any]]:
        if name not in self.endpoints:
            return 404, {
                "error": f"unknown replica {name!r}",
                "replicas": sorted(self.endpoints),
            }
        with self._drain_lock:
            active = [
                n for n, s in self._drain_state.items() if s == "draining"
            ]
            if active:
                # one at a time: the deploy runbook replaces capacity
                # before removing more (docs/SERVING.md)
                return 409, {
                    "error": f"drain of {active[0]!r} still in progress",
                    "draining": active[0],
                }
            if self._drain_state[name] != "in":
                return 409, {
                    "error": f"replica {name!r} is already "
                    f"{self._drain_state[name]}",
                }
        self._set_drain_state(name, "draining")
        self._rebuild_view()  # stop routing to it before the SIGTERM
        self._tel.count("route/drains")
        proc = self.fleet.by_name(name) if self.fleet else None
        if proc is not None:
            proc.drain()
            mechanism = "sigterm"
        else:
            mechanism = "hold-out"  # pre-started endpoint: out of
            # rotation until observed idle; lifecycle stays external
        return 200, {"replica": name, "state": "draining",
                     "mechanism": mechanism}

    def undrain(self, name: str) -> Tuple[int, Dict[str, Any]]:
        if name not in self.endpoints:
            return 404, {"error": f"unknown replica {name!r}"}
        with self._drain_lock:
            state = self._drain_state[name]
            if state == "in":
                return 409, {"error": f"replica {name!r} is in rotation"}
        self._set_drain_state(name, "in")
        self._rebuild_view()
        return 200, {"replica": name, "state": "in"}

    # -- observability endpoints -------------------------------------------

    def healthz(self) -> Tuple[Dict[str, Any], int]:
        view = self.view()
        routable = view["routable"]
        total = len(self.endpoints)
        if len(routable) == total:
            status = "ok"
        elif routable:
            status = "partial"
        else:
            status = "down"
        modes = {
            view["replicas"][n].get("serve_mode") for n in routable
        } - {None}
        payload = {
            "ready": bool(routable),
            "status": status,
            "role": "router",
            "uptime_s": round(time.time() - self._t_start, 1),
            "replicas_routable": len(routable),
            "replicas_total": total,
            "replicas_encode": len(view["routable_encode"]),
            "replicas_decode": len(view["routable_decode"]),
            # same top-level load signals a stacked router would poll
            "queue_depth": view["queue_depth"],
            "in_flight": view["in_flight"],
            "serve_mode": (
                modes.pop() if len(modes) == 1 else ("mixed" if modes else None)
            ),
            "fleet_p50_ms": view["fleet_p50_ms"],
        }
        if view["straggler"].get("verdict"):
            payload["straggler"] = view["straggler"]
        if self.tenants.multi:
            payload["tenants"] = sorted(self.tenants.names())
        return payload, (200 if routable else 503)

    def stats(self) -> Dict[str, Any]:
        view = self.view()
        counters = self._tel.counters()
        latency = {}
        for name in ("route/request", "route/upstream", "route/overhead"):
            p = _percentiles_ms(self._tel, name)
            if p:
                latency[name] = p
        with self._drain_lock:
            drain_log = list(self._drain_log)
        tenants_block = None
        if self.tenants.multi:
            tenants_block = {}
            for spec in self.tenants.specs():
                tokens = self.tenants.tokens(spec.name)
                tenants_block[spec.name] = {
                    "weight": spec.weight,
                    "rps": spec.rps,
                    "tokens": (
                        round(tokens, 3) if tokens is not None else None
                    ),
                    "requests": counters.get(
                        f"route/tenant_{spec.name}_requests", 0
                    ),
                    "shed": counters.get(
                        f"route/tenant_{spec.name}_shed", 0
                    ),
                }
        return {
            "role": "router",
            "ready": bool(view["routable"]),
            "replicas": view["replicas"],
            "routable": view["routable"],
            "routable_encode": view["routable_encode"],
            "routable_decode": view["routable_decode"],
            "straggler": view["straggler"],
            "fleet_p50_ms": view["fleet_p50_ms"],
            "queue_depth": view["queue_depth"],
            "in_flight": view["in_flight"],
            "counters": {
                k: v for k, v in counters.items() if k.startswith("route/")
            },
            "latency_ms": latency,
            "reconnects": {
                name: pool.connects for name, pool in self._pools.items()
            },
            "drain_log": drain_log,
            **({"tenants": tenants_block} if tenants_block else {}),
            **(
                {"tenants_cost": fleet_cost}
                if (fleet_cost := fleet_tenants_cost(view["replicas"]))
                else {}
            ),
            **(
                {"quality": fq}
                if (fq := fleet_quality(view["replicas"]))
                else {}
            ),
        }

    def metrics_text(self) -> str:
        view = self.view()
        self._tel.gauge("route/replicas_routable", len(view["routable"]))
        self._tel.gauge(
            "route/replicas_encode", len(view["routable_encode"])
        )
        self._tel.gauge(
            "route/replicas_decode", len(view["routable_decode"])
        )
        self._tel.gauge("route/fleet_queue_depth", view["queue_depth"])
        self._tel.gauge("route/fleet_in_flight", view["in_flight"])
        self._tel.gauge(
            "route/straggler", 1 if view["straggler"].get("verdict") else 0
        )
        # fleet-wide per-tenant cost + the tightest replica headroom ride
        # the router scrape so one dashboard covers the whole fleet
        for tenant, row in fleet_tenants_cost(view["replicas"]).items():
            self._tel.gauge(
                f"route/tenant_{tenant}_device_ms", row.get("device_ms", 0.0)
            )
        headrooms = [
            snap["capacity_headroom_pct"]
            for snap in view["replicas"].values()
            if isinstance(snap.get("capacity_headroom_pct"), (int, float))
        ]
        if headrooms:
            self._tel.gauge("route/fleet_headroom_pct", min(headrooms))
        # fleet quality: worst-replica drift + summed outliers, so the
        # router scrape pages on one drifting model in a healthy fleet
        fq = fleet_quality(view["replicas"])
        if fq:
            if fq.get("psi_max") is not None:
                self._tel.gauge("route/fleet_quality_psi_max", fq["psi_max"])
            self._tel.gauge("route/fleet_quality_outliers", fq["outliers"])
        return promtext.render(self._tel)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "Router":
        self.poll_once()  # a populated view before the first request
        self._poll_thread = threading.Thread(
            target=self._poll_loop, name="sat-route-poll", daemon=True
        )
        self._poll_thread.start()
        self._httpd = _RouterHTTPServer(
            (self._host, self._requested_port), _RouterHandler
        )
        self._httpd.app = self
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="sat-route-http",
            daemon=True,
        )
        self._http_thread.start()
        self._tel.gauge("route/ready", 1)
        return self

    def request_shutdown(self) -> None:
        self._stop.set()

    def shutdown(self) -> None:
        if self._httpd is None:
            return
        self._stop.set()
        self._tel.gauge("route/ready", 0)
        self._httpd.shutdown()
        if self._http_thread is not None:
            self._http_thread.join(timeout=10.0)
            self._http_thread = None
        self._httpd.server_close()
        self._httpd = None
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=5.0)
            self._poll_thread = None
        for pool in self._pools.values():
            pool.close_all()

    def serve_until_shutdown(self, shutdown=None, poll_s: float = 0.1) -> None:
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


def route(config: Config) -> int:
    """CLI entry point: ``python -m sat_tpu_torch.cli --phase route``.

    Torch never loads in this process (enforced by the import test):
    the replicas own the card; the router outlives them."""
    tel = telemetry.get()
    if not tel.enabled:
        tel = telemetry.enable(capacity=config.telemetry_buffer)
    fleet: Optional[LocalFleet] = None
    if config.route_replicas:
        endpoints = parse_endpoints(config.route_replicas)
        print(
            f"sat_tpu_torch: router fronting {len(endpoints)} pre-started "
            f"replica(s): {', '.join(e.address for e in endpoints)}",
            file=sys.stderr,
            flush=True,
        )
    else:
        fleet = LocalFleet(
            config,
            config.route_num_replicas,
            root=os.path.join(config.summary_dir, "fleet"),
            host=config.serve_host,
            base_port=config.route_replica_base_port,
        )
        print(
            f"sat_tpu_torch: spawned {config.route_num_replicas} local "
            f"replica(s) on ports "
            f"{[e.port for e in fleet.endpoints]}; waiting for readiness",
            file=sys.stderr,
            flush=True,
        )
        try:
            fleet.wait_ready()
        except Exception:
            fleet.stop_all()
            raise
        endpoints = fleet.endpoints
    router = Router(config, endpoints, fleet=fleet).start()
    print(
        f"sat_tpu_torch: fleet router listening on "
        f"http://{config.serve_host}:{router.port} "
        f"({len(endpoints)} replica(s), poll "
        f"{config.route_poll_interval_s:g}s, hysteresis "
        f"{config.route_hysteresis:g}, down-weight "
        f"{config.route_down_weight:g})",
        file=sys.stderr,
        flush=True,
    )
    if router.tenants.multi:
        plan = ", ".join(
            f"{s.name}(w={s.weight:g}"
            + (f", {s.rps:g}rps" if s.rps > 0 else "")
            + ")"
            for s in router.tenants.specs()
        )
        print(
            f"sat_tpu_torch: router tenant plane: {plan}; default "
            f"{router.tenants.default!r}",
            file=sys.stderr,
            flush=True,
        )
    try:
        router.serve_until_shutdown()
    finally:
        if fleet is not None:
            fleet.stop_all()
    print("sat_tpu_torch: router drained cleanly", file=sys.stderr, flush=True)
    return 0
