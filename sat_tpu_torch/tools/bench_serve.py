"""Serving load generator: closed-loop throughput + open-loop latency —
the port of ``scripts/bench_serve.py``, with its flags, modes, rows and
exit codes.

Boots the port's serving stack on the card against a procedurally
initialized flagship model (``Config``'s widths; ``--extra-set`` changes
them) — fresh params saved through the checkpoint/lineage path, so the
bench exercises the same lineage load, bucket warmup, micro-batcher and
HTTP frontend production traffic hits — then drives it two ways:

* **closed loop**: ``--concurrency`` workers each issue ``--requests``
  back-to-back POSTs; measures sustained throughput (the batcher should
  ride the top bucket) and per-request latency percentiles.
* **open loop**: Poisson arrivals at ``--rate`` req/s (seeded, so runs
  compare like-for-like); measures the latency distribution under an
  arrival process that does not self-throttle, plus how much the
  admission queue shed (429s are counted, not errors — shedding under
  overload is the contract).

Prints BENCH-contract JSON lines on stdout ({"metric", "value", "unit",
...extras} + telemetry.bench_stamp(), each with ``device_kind`` and the
kernel launches of its phase), accepted by ``tools/check_regression.py``.
Batch mode decodes through B1 (the unmasked fused attention kernel),
continuous mode through B2 (its row-masked body):

* ``serve_closed_loop_throughput`` (req_per_s, higher is better)
* ``serve_open_loop_p99_latency_ms`` (ms, lower is better)
* ``serve_continuous_goodput`` (req_per_s, higher is better) — open
  loop at ``--cont-rate`` (≈ the batch path's padded-bucket capacity)
  against ``--serve_mode continuous`` (paged slot pool, step-level
  admission); a batch-mode run at the SAME rate is measured first and
  reported as ``batch_ref_goodput`` / ``batch_ref_p99_ms`` extras, so
  the row demonstrates continuous beating batch on both captions/s and
  p99 at high offered load
* ``serve_admission_latency_ms`` (ms, lower is better) — p95 submit →
  slot-seeded time in continuous mode (what the whole-batch gather +
  hold-open window used to cost).  Sampled ONLY over the open-loop
  load phase (warm-pass and single-stream admissions are sliced off)
  and reported next to the detok-thread queueing p95
  (``detok_queue_p95_ms``) so decode-lane wins are not masked by
  post-harvest string work sitting in the detok queue
* ``serve_single_stream_latency_ms`` (ms, lower is better) — one
  closed-loop client against the continuous server: the empty-queue
  regime where the adaptive policy picks the DEEPEST fused-decode lane
  (docs/SERVING.md "Fused decode window"), so per-request latency is
  dominated by K-step device dispatches instead of per-step host
  round-trips.  A second continuous arm pinned to
  ``serve_decode_depth=1`` runs the same client and rides the row as
  ``k1_p50_ms`` / ``k1_goodput`` extras — the K-ladder A/B.  Every K
  lane asserts zero steady-state recompiles (exit 1 otherwise).
* ``--tenants`` switches to the multi-tenant isolation campaign
  (docs/SERVING.md "Multi-tenant serving"): one continuous-mode server
  with a victim/peer/flood registry — ``tenant_isolation_p99_ratio``
  (ratio, lower is better: victim p99 under a 5x-quota flood over its
  flood-free baseline) and ``tenant_fair_share_error`` (fraction, lower
  is better: |observed − weighted| completion share across two
  backlogged lanes).  Exit 1 on any recompile, victim-lane shed/error
  or flood 5xx.
* ``--fleet`` switches to the fleet campaign (docs/SERVING.md fleet
  section): max(--fleet-sizes) subprocess replicas spawned once, then a
  matched open-loop Poisson load through the health-weighted router at
  each fleet size — ``fleet_goodput_rps`` (req_per_s, higher is better,
  with per-size goodput/scaling extras), ``fleet_open_loop_p99_latency_ms``
  (ms, lower is better) and ``fleet_router_overhead_ms`` (the router's
  own p50 per-request cost).  A final disaggregated arm spawns an
  encode-tier + decode-tier pair and runs the same load two-hop through
  the router (``fleet_disagg_goodput_rps``, req_per_s, higher is
  better — the feature-grid handoff priced against the n=1 arm).
* ``--encode-cache`` switches to the content-addressed encode-cache
  campaign (docs/SERVING.md "Encode cache & tiered fleets"): a hit/cold
  bitwise caption-parity phase, then an all-unique control arm and a
  Zipf repeat-traffic arm on one cache-on server —
  ``encode_cache_hit_ratio`` (ratio, higher is better; acceptance
  floor 0.6 on the Zipf arm, ~0 on unique) and
  ``cache_serve_goodput_rps`` (req_per_s, higher is better).  Exit 1
  on any recompile, any parity mismatch, or a dead/false ratio.
* ``--metering`` switches to the cost-attribution campaign
  (docs/OBSERVABILITY.md "Cost attribution and tenant metering"):
  ``metering_overhead_pct`` (pct, lower is better: the full
  per-request metering path — sketch observe, encode/decode cost
  shares, occupancy stamp, the terminal ``charge()`` — microbenched
  and priced against the live arm's request p50; hard gate 0.5, exit
  1 over) and ``encode_cache_would_hit_ratio`` (ratio, higher is
  better: the would-be encode-cache probe under Zipf-weighted repeat
  traffic, with an all-unique control arm riding as the ~0 extra —
  ROADMAP item 2's evidence).  Both live arms also assert the
  accounting identity (attributed device-ms within ±5% of measured
  busy) and zero steady-state recompiles.

The load generator keeps one persistent HTTP/1.1 connection per worker
(keep-alive; reconnects are counted in the BENCH rows) so high-rate runs
measure the server, not TCP connect overhead.  Both single-server modes
run against one warmed engine.  The port compiles only its kernel
(``ops.build``), so the JAX script's "zero steady-state recompiles" is
zero ``kernel/builds`` after warm-up (exit 1 otherwise — per replica, read
from its ``/metrics``, in fleet mode).

Usage: python -m sat_tpu_torch.tools.bench_serve [--concurrency 8]
       [--requests 25] [--rate 50] [--open-requests 200]
       [--buckets 1,4,16] [--max-batch 16] [--max-wait-ms 5]
       [--workdir DIR] [--extra-set KEY=VALUE ...]
       (the card, or the CPU with SAT_TORCH_DEVICE=cpu)
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import random
import shutil
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

from .benchlib import bench_device, device_kind, make_log

log = make_log("bench_serve")


def _builds(tel) -> int:
    """The port's compile events: kernels built in this process
    (``kernel/builds``, ``ops.build``); it compiles nothing else, so a
    build after warm-up is the steady-state recompile the JAX script
    rejects."""
    return tel.counters().get("kernel/builds", 0)


def _replica_builds(port: int) -> int:
    """A replica's ``kernel/builds`` from its ``/metrics`` (its ``/stats``
    has no compile fields: nothing is compiled ahead in the port)."""
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10.0) as r:
        text = r.read().decode()
    for line in text.splitlines():
        if line.startswith('sat_counter_total{name="kernel/builds"}'):
            return int(float(line.rsplit(" ", 1)[1]))
    return 0


def _launches() -> tuple:
    """(B1, B2) launches of this process so far."""
    from ..ops.fused_attend import fused_attend

    return fused_attend.launches, fused_attend.masked_launches


SENTENCES = [
    "a man riding a horse on the beach.",
    "a group of people standing around a kitchen.",
    "two dogs playing with a red ball in the grass.",
    "a plate of food with rice and vegetables.",
    "a bus driving down a city street.",
    "a cat sitting on top of a wooden table.",
]


def _make_jpegs(n: int, size: int) -> list:
    """Structurally DIVERSE images — each index gets its own rng, solid
    region and channel, so the encoded contexts differ enough for
    input-dependent seal steps (near-identical noise images collapse to
    one caption length through the encoder, hiding the straggler regime
    continuous batching exists for)."""
    import cv2

    out = []
    for i in range(n):
        rng = np.random.default_rng(100 + i)
        img = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
        c = i % 3
        extent = size // 4 + (3 * i) % (3 * size // 4)
        if i % 2 == 0:
            img[:extent, :, c] = 30 * (i + 1) % 255
        else:
            img[:, :extent, c] = max(0, 250 - 25 * i)
        ok, buf = cv2.imencode(".jpg", img)
        assert ok
        out.append(bytes(buf))
    return out


def _make_ckpt(args, workdir):
    """A fresh flagship model (``Config``'s widths: VGG16 at 224 px, the
    512 widths, bfloat16; ``--extra-set`` overrides them) drawn from seed
    0 and saved through checkpoint+lineage; returns the serve Config
    pointing at it — shared by the in-process servers below and the
    subprocess replica fleet (--fleet), which both load the same
    LAST_GOOD step through the lineage path."""
    import torch

    from .. import telemetry
    from ..config import Config
    from ..data.vocabulary import Vocabulary
    from ..resilience import lineage
    from ..train.checkpoint import save_checkpoint
    from ..train.step import create_train_state
    from .benchlib import parse_sets

    vocab_file = os.path.join(workdir, "vocabulary.csv")
    vocabulary = Vocabulary(size=50)
    vocabulary.build(SENTENCES)
    vocabulary.save(vocab_file)

    buckets = tuple(int(b) for b in args.buckets.split(","))
    config = Config(
        phase="serve",
        vocabulary_size=vocabulary.size,
        vocabulary_file=vocab_file,
        save_dir=os.path.join(workdir, "models"),
        summary_dir=os.path.join(workdir, "summary"),
        serve_buckets=buckets,
        serve_max_batch=args.max_batch,
        serve_max_wait_ms=args.max_wait_ms,
        serve_queue_depth=args.queue_depth,
        heartbeat_interval=0.0,
    )
    config = parse_sets(config, args.extra_set)
    os.makedirs(config.save_dir, exist_ok=True)

    tel = telemetry.enable(capacity=1 << 18)
    # drawn on the host: the checkpoint is only written, the engines load it
    state = create_train_state(config, torch.Generator().manual_seed(0), "cpu")
    if args.eos_bias != 0.0:
        # shape the synthetic model toward realistic caption-length
        # variance: a mild EOS-logit bias makes different inputs seal at
        # different steps (short captions + stragglers — the regime
        # continuous batching exists for).  Raw random params run every
        # beam to max_caption_length, hiding early retirement entirely.
        eos = vocabulary.word2idx["."]
        with torch.no_grad():
            state.params["decoder"]["decode"]["fc_2"]["bias"][eos] += args.eos_bias
    path = save_checkpoint(state, config)
    lineage.mark_last_good(config.save_dir, int(state.step))
    log(f"fresh params saved to {path}")
    return config, vocabulary, tel


def _boot(args, workdir):
    """_make_ckpt + the real in-process serving stack: engine warmup and
    a CaptionServer on an ephemeral port."""
    from ..serve.engine import ServeEngine, load_serving_state
    from ..serve.server import CaptionServer

    config, vocabulary, tel = _make_ckpt(args, workdir)
    state, source = load_serving_state(config)
    engine = ServeEngine(config, state, vocabulary, tel=tel)
    engine.warmup()
    server = CaptionServer(config, engine, port=0).start()
    log(f"server up on port {server.port} on {engine.device} "
        f"(buckets {engine.buckets}, warm {engine.warm_seconds:.2f}s, "
        f"kernel builds {_builds(tel)})")
    return server, engine, tel


class _KeepAliveClient:
    """Persistent HTTP/1.1 connections per port, checked out per request
    so concurrent workers never share a socket.  The old client opened a
    fresh TCP connection per POST — at high open-loop rates that
    measured the client's connect overhead, not the server.  ``connects``
    counts every fresh TCP connect (steady state: one per concurrent
    worker; anything above that is a reconnect after a dropped/broken
    keep-alive and is reported in the BENCH rows)."""

    def __init__(self):
        self._idle = {}  # port -> stack of idle connections
        self._lock = threading.Lock()
        self.connects = 0

    def post(self, port, data, timeout=60.0, host="127.0.0.1",
             headers=None):
        """One POST /caption; returns (status, latency_s); status 0 on a
        connection-level failure (refused/reset — the chaos scenario
        distinguishes these from HTTP 5xx).  ``headers`` adds request
        headers (the tenant arm sets ``X-Tenant`` per lane)."""
        t0 = time.perf_counter()
        with self._lock:
            stack = self._idle.setdefault(port, [])
            conn = stack.pop() if stack else None
            if conn is None:
                self.connects += 1
        if conn is None:
            conn = http.client.HTTPConnection(host, port, timeout=timeout)
        try:
            conn.request(
                "POST", "/caption", body=data,
                headers={"Content-Type": "image/jpeg", **(headers or {})},
            )
            resp = conn.getresponse()
            resp.read()
            status = resp.status
            with self._lock:
                self._idle.setdefault(port, []).append(conn)
        except (OSError, http.client.HTTPException):
            try:
                conn.close()
            except Exception:
                pass
            status = 0
        return status, time.perf_counter() - t0

    def close_all(self):
        with self._lock:
            pools, self._idle = self._idle, {}
        for stack in pools.values():
            for conn in stack:
                try:
                    conn.close()
                except Exception:
                    pass


_CLIENT = _KeepAliveClient()


def _post(port, data, timeout=60.0, headers=None):
    """One POST over the shared keep-alive pool; (status, latency_s)."""
    return _CLIENT.post(port, data, timeout=timeout, headers=headers)


def _get_json(port, path, timeout=10.0):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=timeout
    ) as r:
        return json.loads(r.read())


def _pcts(lat_s):
    data = np.sort(np.asarray(lat_s, np.float64)) * 1e3
    def pct(p):
        return round(float(data[min(len(data) - 1,
                                    int(p / 100.0 * len(data)))]), 3)
    return {"p50": pct(50), "p95": pct(95), "p99": pct(99)}


def closed_loop(port, jpegs, concurrency, requests, headers=None):
    """concurrency workers x requests sequential POSTs each."""
    lats, codes = [], []
    lock = threading.Lock()
    connects0 = _CLIENT.connects

    def worker(wid):
        local_l, local_c = [], []
        for i in range(requests):
            status, lat = _post(port, jpegs[(wid + i) % len(jpegs)],
                                headers=headers)
            local_c.append(status)
            if status == 200:
                local_l.append(lat)
        with lock:
            lats.extend(local_l)
            codes.extend(local_c)

    threads = [threading.Thread(target=worker, args=(w,), daemon=True)
               for w in range(concurrency)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    ok = sum(1 for c in codes if c == 200)
    return {
        "wall_s": wall,
        "ok": ok,
        "shed": sum(1 for c in codes if c == 429),
        "throughput": ok / wall if wall > 0 else 0.0,
        # fresh TCP connects this loop forced: steady state is one per
        # worker; the excess is keep-alive reconnects
        "tcp_connects": _CLIENT.connects - connects0,
        "reconnects": max(0, _CLIENT.connects - connects0 - concurrency),
        **_pcts(lats or [0.0]),
    }


def open_loop(port, jpegs, rate, total, timeout=60.0, headers=None):
    """Poisson arrivals at ``rate`` req/s; each request on its own
    thread so slow responses never throttle the arrival process."""
    rng = random.Random(0)
    lats, codes = [], []
    lock = threading.Lock()
    threads = []
    connects0 = _CLIENT.connects

    def fire(i):
        status, lat = _post(port, jpegs[i % len(jpegs)], timeout=timeout,
                            headers=headers)
        with lock:
            codes.append(status)
            if status == 200:
                lats.append(lat)

    t0 = time.perf_counter()
    for i in range(total):
        time.sleep(rng.expovariate(rate))
        t = threading.Thread(target=fire, args=(i,), daemon=True)
        t.start()
        threads.append(t)
    for t in threads:
        t.join(timeout=max(180.0, 2 * timeout))
    wall = time.perf_counter() - t0
    ok = sum(1 for c in codes if c == 200)
    return {
        "wall_s": wall,
        "ok": ok,
        "shed": sum(1 for c in codes if c == 429),
        "errors": sum(1 for c in codes if c == 0 or c >= 500),
        "offered_rate": rate,
        # keep-alive reconnects aren't separable from pool growth in an
        # open loop (concurrency is unbounded), so report raw connects
        "tcp_connects": _CLIENT.connects - connects0,
        **_pcts(lats or [0.0]),
    }


def fleet_bench(args, workdir) -> int:
    """--fleet: goodput scaling across an N-replica fleet behind the
    router (serve/router.py).

    Spawns max(--fleet-sizes) serve replicas ONCE (``--phase serve``
    subprocesses, each its own CUDA context on the card), then for each
    fleet size n runs the SAME open-loop Poisson load against an
    in-process Router fronting the first n endpoints.  Offered load is
    matched across arms and sits well ABOVE the largest arm's capacity:
    every arm is backlogged from its first dispatch (the bounded
    admission queue absorbs the burst), so goodput tracks fleet
    capacity — the acceptance story is near-linear scaling (>=1.7x at
    2, >=3x at 4).  The fleet arms run unit-batch geometry (one
    dispatch, one floor, one request): each replica is then a serial
    fixed-service-time queue, so scaling isolates the router's
    spreading/queueing behaviour instead of micro-batch fill dynamics
    (under-filled ramp/tail batches at short arms, which the
    single-server modes already characterize).

    Replicas are armed with a per-dispatched-batch service-time floor
    (``SAT_FI_SLOW_SERVE_MS``, --fleet-service-floor-ms) so each one is
    occupancy-bound the way a replica with a card of its own is.  Without
    it, N replicas time-slice this machine's one card (and its cores) and
    goodput measures that contention instead of router/queueing
    behaviour.  The floor rides the existing inert-by-default fault
    plan (resilience/faultinject.py) and is recorded in the
    BENCH rows.  Emits ``fleet_goodput_rps`` and
    ``fleet_open_loop_p99_latency_ms`` BENCH rows (gated by
    check_regression.py) plus ``fleet_router_overhead_ms`` (the router's
    own p50 cost per request), and asserts zero steady-state recompiles
    on EVERY replica across the whole campaign."""
    from .. import telemetry
    from ..serve.replica import LocalFleet
    from ..serve.router import Router

    config, vocabulary, tel = _make_ckpt(args, workdir)
    sizes = sorted({int(s) for s in args.fleet_sizes.split(",")})
    floor_ms = int(args.fleet_service_floor_ms)
    fleet_env = (
        {"SAT_FI_SLOW_SERVE_MS": str(floor_ms)} if floor_ms > 0 else None
    )
    # unit-batch geometry: one floor per request makes each replica a
    # serial fixed-service-time queue (no partial-batch fill dynamics),
    # and the floor keeps per-request decode time a minor term so N
    # co-hosted replicas don't just measure their contention for the card
    config = config.replace(serve_buckets=(1,), serve_max_batch=1)
    fleet = LocalFleet(
        config, max(sizes), root=os.path.join(workdir, "fleet"),
        env=fleet_env,
    )
    results, recompiles = {}, {}
    overhead_ns = []
    try:
        log(f"spawned {max(sizes)} replicas on ports "
            f"{[e.port for e in fleet.endpoints]}; waiting for readiness")
        fleet.wait_ready(timeout_s=600)
        log("fleet ready")
        jpegs = _make_jpegs(8, config.image_size)
        base_compiles = {}
        for e in fleet.endpoints:
            _post(e.port, jpegs[0])  # first-touch host costs per replica
            base_compiles[e.name] = _replica_builds(e.port)
        route_cfg = config.replace(
            phase="route",
            route_poll_interval_s=0.2,  # fresh view between arms
            # the saturated n=1 arm's tail queues for most of that arm's
            # wall time before its replica even dispatches it; the
            # default per-attempt proxy timeout would clip it into 5xx
            route_upstream_timeout_s=240.0,
        )
        # largest arm first: replica-side latency percentiles carry each
        # arm's saturated queue waits, so ascending order would hand the
        # n=2/n=4 routers a merged view where the replica that just
        # served the n=1 arm alone looks like a straggler (p99 ~= that
        # arm's wall time) and gets down-weighted despite being idle.
        # Descending order keeps every arm's history symmetric across
        # the replicas it fronts (and the n=1 arm cannot skew).
        for n in sorted(sizes, reverse=True):
            router = Router(
                route_cfg, fleet.endpoints[:n], port=0
            ).start()
            try:
                _post(router.port, jpegs[0])  # warm the edge + pools
                mark = len(tel.durations_ns("route/overhead"))
                # generous client timeout: the saturated n=1 arm's tail
                # waits out most of the arm's wall time by design
                res = open_loop(
                    router.port, jpegs, args.fleet_rate,
                    args.fleet_requests, timeout=150.0,
                )
                over = np.asarray(
                    tel.durations_ns("route/overhead")[mark:], np.float64
                )
                res["router_overhead_p50_ms"] = (
                    round(float(np.median(over)) / 1e6, 3)
                    if over.size else 0.0
                )
                overhead_ns.extend(over.tolist())
                res["goodput"] = (
                    res["ok"] / res["wall_s"] if res["wall_s"] else 0.0
                )
                stats = _get_json(router.port, "/stats")
                res["router_reconnects"] = sum(
                    stats.get("reconnects", {}).values()
                )
                res["retries"] = stats.get("counters", {}).get(
                    "route/retries", 0
                )
                results[n] = res
                log(f"fleet n={n} @ {args.fleet_rate}/s: {res['ok']} ok, "
                    f"{res['shed']} shed, {res['errors']} errors in "
                    f"{res['wall_s']:.1f}s -> {res['goodput']:.1f} req/s "
                    f"(p50 {res['p50']}ms p99 {res['p99']}ms, router "
                    f"overhead p50 {res['router_overhead_p50_ms']}ms)")
            finally:
                router.shutdown()
        for e in fleet.endpoints:
            recompiles[e.name] = _replica_builds(e.port) - base_compiles[e.name]
        log(f"per-replica steady-state kernel builds: {recompiles}")
        # each replica's B1/B2 launches so far, from its /stats
        replica_launches = {}
        for e in fleet.endpoints:
            k = _get_json(e.port, "/stats").get("kernels", {}).get("fused_attend", {})
            replica_launches[e.name] = [k.get("launches", 0), k.get("masked_launches", 0)]

        # --- disaggregated arm: encode tier + decode tier ----------------
        # the same open-loop load through a two-replica tiered fleet
        # (docs/SERVING.md "Encode cache & tiered fleets"): the router
        # two-hops every image request (/encode on the encode tier, the
        # framed grid to /caption on the decode tier).  The service
        # floor arms only the batcher drain, so the arm is decode-bound
        # — goodput should track the n=1 arm (one floored decode
        # replica) and the row prices the handoff overhead against it.
        disagg_res = None
        disagg = LocalFleet(
            config, 2, root=os.path.join(workdir, "fleet_disagg"),
            env=fleet_env, tiers=["encode", "decode"],
        )
        try:
            log(f"disagg fleet (encode+decode tiers) on ports "
                f"{[e.port for e in disagg.endpoints]}")
            disagg.wait_ready(timeout_s=600)
            d_base = {}
            for e in disagg.endpoints:
                d_base[e.name] = _replica_builds(e.port)
            router = Router(route_cfg, disagg.endpoints, port=0).start()
            try:
                _post(router.port, jpegs[0])  # warm both hops
                disagg_res = open_loop(
                    router.port, jpegs, args.fleet_rate,
                    args.fleet_requests, timeout=150.0,
                )
                disagg_res["goodput"] = (
                    disagg_res["ok"] / disagg_res["wall_s"]
                    if disagg_res["wall_s"] else 0.0
                )
                stats = _get_json(router.port, "/stats")
                disagg_res["handoffs"] = stats.get("counters", {}).get(
                    "route/handoffs", 0
                )
            finally:
                router.shutdown()
            for e in disagg.endpoints:
                recompiles[f"disagg_{e.name}"] = _replica_builds(e.port) - d_base[e.name]
            log(f"disagg arm @ {args.fleet_rate}/s: {disagg_res['ok']} "
                f"ok, {disagg_res['shed']} shed, {disagg_res['errors']} "
                f"errors -> {disagg_res['goodput']:.1f} req/s "
                f"({disagg_res['handoffs']} handoffs, p99 "
                f"{disagg_res['p99']}ms)")
        finally:
            disagg.stop_all()
    finally:
        _CLIENT.close_all()
        fleet.stop_all()

    g1 = results[min(sizes)]["goodput"]
    n_top = max(sizes)
    scaling = {
        n: round(results[n]["goodput"] / g1, 3) if g1 else 0.0
        for n in sizes
    }
    log(f"goodput scaling vs n={min(sizes)}: {scaling}")
    common = {
        "device_kind": args.device_kind,
        "replica_launches": replica_launches,
        "fleet_sizes": sizes,
        "offered_rate_per_s": args.fleet_rate,
        "arrivals_per_arm": args.fleet_requests,
        "service_floor_ms": floor_ms,
        "per_replica_recompiles": recompiles,
        "buckets": ",".join(str(b) for b in config.serve_buckets),
        "max_batch": config.serve_max_batch,
        **telemetry.bench_stamp(),
    }
    top = results[n_top]
    print(json.dumps({
        "metric": "fleet_goodput_rps",
        "value": round(top["goodput"], 2),
        "unit": "req_per_s",
        "replicas": n_top,
        "goodput_by_n": {
            str(n): round(r["goodput"], 2) for n, r in results.items()
        },
        "scaling_by_n": {str(n): s for n, s in scaling.items()},
        "completed": top["ok"], "shed": top["shed"],
        "errors": top["errors"],
        "tcp_connects": top["tcp_connects"],
        "router_reconnects": top["router_reconnects"],
        **common,
    }), flush=True)
    print(json.dumps({
        "metric": "fleet_open_loop_p99_latency_ms",
        "value": top["p99"],
        "unit": "ms",
        "replicas": n_top,
        "p50_ms": top["p50"], "p95_ms": top["p95"],
        "p99_by_n": {str(n): r["p99"] for n, r in results.items()},
        **common,
    }), flush=True)
    if disagg_res is not None:
        print(json.dumps({
            "metric": "fleet_disagg_goodput_rps",
            "value": round(disagg_res["goodput"], 2),
            "unit": "req_per_s",
            "tiers": ["encode", "decode"],
            "completed": disagg_res["ok"], "shed": disagg_res["shed"],
            "errors": disagg_res["errors"],
            "p50_ms": disagg_res["p50"], "p99_ms": disagg_res["p99"],
            "handoffs": disagg_res["handoffs"],
            "single_replica_goodput": (
                round(results[min(sizes)]["goodput"], 2)
                if min(sizes) in results else None
            ),
            **common,
        }), flush=True)
    over_all = np.asarray(overhead_ns, np.float64)
    print(json.dumps({
        "metric": "fleet_router_overhead_ms",
        "value": (
            round(float(np.median(over_all)) / 1e6, 3)
            if over_all.size else 0.0
        ),
        "unit": "ms",
        "percentile": "p50",
        "samples": int(over_all.size),
        **common,
    }), flush=True)
    # recompiling under load is the one hard failure; shed/scaling are
    # reported for the regression gate to judge
    return 0 if all(v == 0 for v in recompiles.values()) else 1


def tenants_bench(args, workdir) -> int:
    """--tenants: SLO isolation + fair-share on the multi-tenant plane
    (docs/SERVING.md "Multi-tenant serving").

    One continuous-mode server with a three-tenant registry: ``victim``
    (weight 4, unlimited — the paying tenant whose p99 the plane
    protects), ``peer`` (weight 1, unlimited — the fair-share
    counterparty) and ``flood`` (weight 1, quota ``--tenant-flood-rps``
    — the abuser).  Three phases:

    * **alone**: victim open loop at ``--tenant-rate`` — the flood-free
      p99 baseline;
    * **under flood**: the SAME victim load while flood offers
      ``--tenant-flood-rate`` (several times its quota) from background
      threads.  ``tenant_isolation_p99_ratio`` = victim p99 under
      flood / alone (1.0 = perfect isolation; the DRR scheduler +
      token-bucket admission keep it near 1);
    * **fair share**: victim and peer drive matched closed loops
      (both lanes continuously backlogged), so completions split by
      DRR weight.  ``tenant_fair_share_error`` = |observed victim
      share - 4/5|, noise-floored at 0.05 for the percent-delta
      regression gate (exact weighted fairness reads as the floor).

    Exits nonzero on any steady-state recompile, any victim
    error/shed (its lane must stay clean while the flood sheds), or a
    flood 5xx (overload must shed 429, not error)."""
    from .. import telemetry
    from ..serve.engine import ServeEngine, load_serving_state
    from ..serve.server import CaptionServer

    config, vocabulary, tel = _make_ckpt(args, workdir)
    registry = os.path.join(workdir, "tenants.json")
    weights = {"victim": 4.0, "peer": 1.0, "flood": 1.0}
    with open(registry, "w") as f:
        json.dump({
            "default": "victim",
            "tenants": [
                {"name": "victim", "weight": weights["victim"]},
                {"name": "peer", "weight": weights["peer"]},
                {"name": "flood", "weight": weights["flood"],
                 "rps": args.tenant_flood_rps,
                 "burst": 2.0 * args.tenant_flood_rps},
            ],
        }, f)
    config = config.replace(
        serve_mode="continuous",
        serve_slot_pages=args.slot_pages,
        serve_page_width=args.page_width,
        tenants=registry,
    )
    state, _ = load_serving_state(config)
    engine = ServeEngine(config, state, vocabulary, tel=tel)
    engine.warmup()
    server = CaptionServer(config, engine, port=0).start()
    try:
        port = server.port
        jpegs = _make_jpegs(8, config.image_size)
        log(f"tenant server up on port {port} (slot pool "
            f"{args.slot_pages}x{args.page_width}, weights {weights}, "
            f"flood quota {args.tenant_flood_rps} rps)")
        _post(port, jpegs[0])  # warm pass (first-touch host costs)
        compiles0 = _builds(tel)
        launches0 = _launches()

        vic = {"X-Tenant": "victim"}
        alone = open_loop(port, jpegs, args.tenant_rate,
                          args.tenant_requests, headers=vic)
        log(f"victim alone @ {args.tenant_rate}/s: {alone['ok']} ok "
            f"(p50 {alone['p50']}ms p99 {alone['p99']}ms)")

        # flood offers several times its quota for the WHOLE victim arm:
        # an open-loop driver (fire-and-forget threads, like open_loop)
        # so slow admitted requests never self-throttle the offered rate
        stop = threading.Event()
        flood_codes, flock = [], threading.Lock()

        def flood_fire():
            status, _lat = _post(port, jpegs[0],
                                 headers={"X-Tenant": "flood"})
            with flock:
                flood_codes.append(status)

        def flood_driver():
            rng = random.Random(7)
            while not stop.is_set():
                time.sleep(rng.expovariate(args.tenant_flood_rate))
                threading.Thread(target=flood_fire, daemon=True).start()

        driver = threading.Thread(target=flood_driver, daemon=True)
        driver.start()
        under = open_loop(port, jpegs, args.tenant_rate,
                          args.tenant_requests, headers=vic)
        stop.set()
        driver.join(timeout=60)
        time.sleep(2.0)  # let in-flight flood requests land
        with flock:
            flood_shed = sum(1 for c in flood_codes if c == 429)
            flood_5xx = sum(1 for c in flood_codes if c == 0 or c >= 500)
            flood_total = len(flood_codes)
        raw_ratio = (
            under["p99"] / alone["p99"] if alone["p99"] else 0.0
        )
        # noise-floored like the fair-share row: tail-over-tail on a
        # shared CPU host swings 1.1-2.5x run to run, which a
        # percent-delta gate would misread as a regression.  Ratios
        # under the floor are healthy isolation; a broken plane (no
        # quota, no DRR weighting) reads 4-11x and clears it by far
        ratio = round(max(raw_ratio, 3.0), 3)
        log(f"victim under flood @ {args.tenant_rate}/s: {under['ok']} ok, "
            f"{under['shed']} shed (p99 {under['p99']}ms vs "
            f"{alone['p99']}ms alone -> raw ratio {raw_ratio:.3f}, "
            f"floored {ratio}); flood: "
            f"{flood_total} offered, {flood_shed} shed, "
            f"{flood_5xx} 5xx")

        # fair share: a time-boxed contended interval.  Fixed-size
        # closed loops can't measure fairness (every loop completes all
        # its requests eventually — the split is 50/50 by construction);
        # instead both lanes run enough blocking clients to stay
        # backlogged for the same wall-clock window, and DRR splits the
        # completions by weight
        share_stop = threading.Event()
        share_ok = {"victim": 0, "peer": 0}
        share_lock = threading.Lock()

        def share_worker(tenant, wid):
            while not share_stop.is_set():
                status, _lat = _post(port, jpegs[wid % len(jpegs)],
                                     headers={"X-Tenant": tenant})
                if status == 200 and not share_stop.is_set():
                    with share_lock:
                        share_ok[tenant] += 1

        workers = [
            threading.Thread(target=share_worker, args=(t, w), daemon=True)
            for t in ("victim", "peer")
            for w in range(args.tenant_concurrency)
        ]
        for t in workers:
            t.start()
        time.sleep(args.tenant_share_seconds)
        share_stop.set()
        for t in workers:
            t.join(timeout=120)
        expected = weights["victim"] / (weights["victim"] + weights["peer"])
        total_ok = share_ok["victim"] + share_ok["peer"]
        observed = share_ok["victim"] / total_ok if total_ok else 0.0
        raw_err = abs(observed - expected)
        # noise-floored for the regression gate: the gate compares
        # percent deltas, and a near-zero baseline would turn count
        # jitter (0.01 -> 0.03) into a fake 200% regression.  Errors
        # under the floor are indistinguishable from scheduling noise;
        # real unfairness (a broken DRR reads ~0.2+) clears it by far
        share_err = round(max(raw_err, 0.05), 4)
        log(f"fair share over {args.tenant_share_seconds}s contended: "
            f"victim {share_ok['victim']} ok vs peer {share_ok['peer']} "
            f"ok -> observed share {observed:.3f} (weighted target "
            f"{expected:.3f}, error {share_err})")

        recompiles = _builds(tel) - compiles0
        victim_bad = (
            alone["errors"] + under["errors"] + under["shed"]
            + alone["shed"]
        )
        log(f"steady-state kernel builds during tenant load: {recompiles}")

        common = {
            "weights": weights,
            "flood_quota_rps": args.tenant_flood_rps,
            "flood_offered_rate_per_s": args.tenant_flood_rate,
            "victim_rate_per_s": args.tenant_rate,
            "victim_arrivals_per_arm": args.tenant_requests,
            "slot_pages": args.slot_pages,
            "page_width": args.page_width,
            "steady_state_compiles": recompiles,
            "fused_attend_masked_launches": _launches()[1] - launches0[1],
            "device_kind": args.device_kind,
            **telemetry.bench_stamp(),
        }
        print(json.dumps({
            "metric": "tenant_isolation_p99_ratio",
            "value": ratio,
            "unit": "ratio",
            "victim_alone_p99_ms": alone["p99"],
            "victim_under_flood_p99_ms": under["p99"],
            "raw_p99_ratio": round(raw_ratio, 3),
            "noise_floor": 3.0,
            "victim_alone_p50_ms": alone["p50"],
            "victim_under_flood_p50_ms": under["p50"],
            "victim_errors": victim_bad,
            "flood_offered": flood_total,
            "flood_shed": flood_shed,
            "flood_5xx": flood_5xx,
            **common,
        }), flush=True)
        print(json.dumps({
            "metric": "tenant_fair_share_error",
            "value": share_err,
            "unit": "fraction",
            "observed_victim_share": round(observed, 4),
            "expected_victim_share": round(expected, 4),
            "raw_share_error": round(raw_err, 4),
            "noise_floor": 0.05,
            "victim_completed": share_ok["victim"],
            "peer_completed": share_ok["peer"],
            "contended_seconds": args.tenant_share_seconds,
            "clients_per_tenant": args.tenant_concurrency,
            **common,
        }), flush=True)
        ok = recompiles == 0 and victim_bad == 0 and flood_5xx == 0
        if not ok:
            log(f"FAIL: isolation invariant violated "
                f"(recompiles={recompiles}, victim_bad={victim_bad}, "
                f"flood_5xx={flood_5xx})")
        return 0 if ok else 1
    finally:
        _CLIENT.close_all()
        server.shutdown()


def metering_bench(args, workdir) -> int:
    """--metering: what the cost-attribution plane itself costs, and the
    would-be encode-cache probe (docs/OBSERVABILITY.md "Cost attribution
    and tenant metering").

    * **charge-path microbench** — times the FULL per-request metering
      path in isolation (a sketch observe, one encode share, four
      fused-window decode shares, the occupancy stamp, then the terminal
      ``charge()`` with its three counter ticks and rate-limited ledger
      flush) and prices it against the live arm's request p50:
      ``metering_overhead_pct``.  Hard gate: raw overhead <= 0.5%
      (exit 1 over) — attribution must be free relative to the work it
      meters.
    * **would-be encode-cache probe** — two open-loop arms on fresh
      servers (each boot gets a fresh sliding sketch): UNIQUE traffic
      first (every arrival a distinct image, warm pass included — a
      content-addressed encode cache would buy nothing, so the probe
      must read ~0), then ZIPF traffic (arrivals drawn rank-weighted
      from a small base, p ∝ 1/rank^--zipf-s — the repeat-heavy regime
      ROADMAP item 2 hypothesizes).  ``encode_cache_would_hit_ratio``
      reports the Zipf arm's /stats gauge with the unique arm's riding
      as the control extra.

    Every live arm also asserts the accounting identity — attributed
    device-ms within ±5% of measured busy over the arm's own window
    (deltas from after the warm pass, so boot costs stay out) — and
    zero steady-state recompiles."""
    from .. import telemetry
    from ..serve.engine import ServeEngine, load_serving_state
    from ..serve.server import CaptionServer
    from ..telemetry.capacity import EncodeCacheSketch
    from ..telemetry.metering import (
        MeteringLedger,
        RequestCost,
        measured_busy_ms,
    )

    config, vocabulary, tel = _make_ckpt(args, workdir)
    config = config.replace(
        serve_mode="continuous",
        serve_slot_pages=args.slot_pages,
        serve_page_width=args.page_width,
        serve_metering=True,
    )
    state, _ = load_serving_state(config)
    engine = ServeEngine(config, state, vocabulary, tel=tel)
    engine.warmup()
    launches0 = _launches()

    # --- charge-path microbench (pure host, no server) ---------------
    mb_ledger = MeteringLedger(
        path=os.path.join(workdir, "microbench_metering.jsonl"),
        cap_bytes=1 << 20,
        tel=tel,
    )
    mb_sketch = EncodeCacheSketch()
    n_mb = 20000
    t0 = time.perf_counter()
    for i in range(n_mb):
        mb_sketch.observe(i % 64)
        cost = RequestCost()
        cost.add_encode(3_000_000)
        for _ in range(4):  # a typical ride: four fused windows
            cost.add_decode(2_000_000, steps=8)
        cost.set_occupancy(40_000_000)
        mb_ledger.charge("mb%d" % (i % 4), cost, queue_ms=0.4,
                         detok_ms=0.2)
    charge_us = (time.perf_counter() - t0) / n_mb * 1e6
    log(f"charge-path microbench: {charge_us:.2f}us/request over "
        f"{n_mb} charges (4 tenants, 4 decode windows each)")

    total = args.metering_requests

    def serve_arm(name, jpegs, warm):
        """One open-loop arm on a FRESH server (fresh sketch + ledger);
        returns the loop dict plus identity/compile/probe readings over
        the arm's own window."""
        server = CaptionServer(config, engine, port=0).start()
        try:
            port = server.port
            _post(port, warm)  # warm pass (first-touch host costs)
            compiles0 = _builds(tel)
            attr0 = server.metering.attributed_device_ms()
            busy0 = measured_busy_ms(tel)
            loop = open_loop(port, jpegs, args.metering_rate, total)
            time.sleep(1.1)  # let the rate-limited capacity tick land
            stats = _get_json(port, "/stats")
            cap = stats.get("capacity", {})
            attributed = server.metering.attributed_device_ms() - attr0
            measured = measured_busy_ms(tel) - busy0
            err_pct = (
                abs(attributed - measured) / measured * 100.0
                if measured else 0.0
            )
            recompiles = _builds(tel) - compiles0
            log(f"{name} arm: {loop['ok']} ok, {loop['shed']} shed "
                f"(p50 {loop['p50']}ms p99 {loop['p99']}ms); attributed "
                f"{attributed:.1f}ms vs measured {measured:.1f}ms busy "
                f"-> identity error {err_pct:.2f}%; would-hit "
                f"{cap.get('encode_cache_would_hit_ratio')}; "
                f"steady-state compiles {recompiles}")
            return {
                "loop": loop,
                "would_hit": float(
                    cap.get("encode_cache_would_hit_ratio", 0.0)
                ),
                "headroom_pct": cap.get("headroom_pct"),
                "identity_error_pct": round(err_pct, 3),
                "attributed_device_ms": round(attributed, 3),
                "measured_busy_ms": round(measured, 3),
                "recompiles": recompiles,
            }
        finally:
            _CLIENT.close_all()
            server.shutdown()

    # unique control first: warm image + every arrival all DISTINCT,
    # so a content-addressed encode cache would buy nothing
    unique_imgs = _make_jpegs(total + 1, config.image_size)
    uniq = serve_arm("unique", unique_imgs[1:], warm=unique_imgs[0])

    # zipf arm: arrivals drawn rank-weighted from a small base — the
    # repeat-heavy regime where caching WOULD pay (warm pass reuses the
    # hottest rank, like real traffic would)
    base = _make_jpegs(16, config.image_size)
    rng = np.random.default_rng(11)
    p = 1.0 / (np.arange(len(base)) + 1.0) ** args.zipf_s
    p = p / p.sum()
    picks = rng.choice(len(base), size=total, p=p)
    zipf_seq = [base[int(r)] for r in picks]
    zipf = serve_arm("zipf", zipf_seq, warm=base[0])

    raw_overhead = (
        charge_us / 1e3 / zipf["loop"]["p50"] * 100.0
        if zipf["loop"]["p50"] else 0.0
    )
    # noise-floored like the tenant rows: the raw number is ~0.005% and
    # a percent-delta regression gate would turn scheduler jitter on a
    # shared box into fake regressions; anything under the floor is
    # free, and the HARD gate below judges the raw value
    overhead = round(max(raw_overhead, 0.05), 4)
    identity_ok = (
        uniq["identity_error_pct"] <= 5.0
        and zipf["identity_error_pct"] <= 5.0
    )
    recompiles = uniq["recompiles"] + zipf["recompiles"]

    common = {
        "requests_per_arm": total,
        "offered_rate_per_s": args.metering_rate,
        "slot_pages": args.slot_pages,
        "page_width": args.page_width,
        "identity_error_pct_unique": uniq["identity_error_pct"],
        "identity_error_pct_zipf": zipf["identity_error_pct"],
        "steady_state_compiles": recompiles,
        "fused_attend_masked_launches": _launches()[1] - launches0[1],
        "device_kind": args.device_kind,
        **telemetry.bench_stamp(),
    }
    print(json.dumps({
        "metric": "metering_overhead_pct",
        "value": overhead,
        "unit": "pct",
        "raw_overhead_pct": round(raw_overhead, 5),
        "noise_floor": 0.05,
        "gate_pct": 0.5,
        "charge_path_us": round(charge_us, 3),
        "microbench_charges": n_mb,
        "request_p50_ms": zipf["loop"]["p50"],
        "attributed_device_ms": zipf["attributed_device_ms"],
        "measured_busy_ms": zipf["measured_busy_ms"],
        **common,
    }), flush=True)
    print(json.dumps({
        "metric": "encode_cache_would_hit_ratio",
        "value": round(zipf["would_hit"], 4),
        "unit": "ratio",
        "unique_traffic_ratio": round(uniq["would_hit"], 4),
        "zipf_s": args.zipf_s,
        "zipf_base_images": len(base),
        "headroom_pct": zipf["headroom_pct"],
        **common,
    }), flush=True)

    ok = (
        raw_overhead <= 0.5
        and identity_ok
        and recompiles == 0
        and zipf["would_hit"] > 0.0
        and uniq["would_hit"] <= 0.05
    )
    if not ok:
        log(f"FAIL: metering invariant violated (overhead "
            f"{raw_overhead:.4f}%, identity unique "
            f"{uniq['identity_error_pct']}% / zipf "
            f"{zipf['identity_error_pct']}%, recompiles {recompiles}, "
            f"would-hit zipf {zipf['would_hit']} / unique "
            f"{uniq['would_hit']})")
    return 0 if ok else 1


def _post_caption(port, data, timeout=60.0):
    """One POST /caption via urllib, returning (status, parsed JSON) —
    the parity phases need the caption STRINGS, not just latencies."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/caption", data=data,
        headers={"Content-Type": "image/jpeg"}, method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, {}


def encode_cache_bench(args, workdir) -> int:
    """--encode-cache: the content-addressed encode cache under repeat
    traffic (docs/SERVING.md "Encode cache & tiered fleets").

    One cache-on continuous-mode server, three phases:

    * **parity** — every base image captioned cold (a cache miss each),
      then again (a hit each): the hit captions must be BITWISE equal
      to the cold ones.  The cache stores the encoder's own output grid
      and the decode path is shared, so ANY drift is a correctness bug
      — exit 1 on the first mismatch.
    * **unique control** — open loop where every arrival is a distinct
      image: content addressing buys nothing, the hit ratio must read
      ~0 (the cache is flushed first so the arm is self-contained).
    * **zipf arm** — the same open loop with arrivals drawn
      rank-weighted (p ∝ 1/(rank+1)^--zipf-s) from a small base: the
      repeat-heavy regime the cache exists for.  The arm's
      ``encode_cache_hit_ratio`` must clear the 0.6 acceptance floor,
      and ``cache_serve_goodput_rps`` reports its goodput with the
      unique arm riding as the control extra.

    The ring is warmed at boot (insert + gather per lane width), so
    every phase also asserts ZERO steady-state kernel builds — one build
    under load exits 1."""
    from .. import telemetry
    from ..serve.engine import ServeEngine, load_serving_state
    from ..serve.server import CaptionServer

    config, vocabulary, tel = _make_ckpt(args, workdir)
    config = config.replace(
        serve_mode="continuous",
        serve_slot_pages=args.slot_pages,
        serve_page_width=args.page_width,
        encode_cache="on",
        encode_cache_mb=args.encode_cache_mb,
    )
    state, _ = load_serving_state(config)
    engine = ServeEngine(config, state, vocabulary, tel=tel)
    engine.warmup()
    cache = engine.encode_cache
    server = CaptionServer(config, engine, port=0).start()
    try:
        port = server.port
        base = _make_jpegs(16, config.image_size)
        log(f"cache server up on port {port} (ring {cache.rows} rows, "
            f"warm widths {cache.warm_widths})")
        _post(port, base[0])  # warm pass (first-touch host costs)
        compiles0 = _builds(tel)
        launches0 = _launches()

        # --- parity: cold (miss) captions vs hit captions, bitwise ------
        cache.flush()
        cold, hot = [], []
        for img in base:
            status, body = _post_caption(port, img)
            assert status == 200, f"cold caption -> {status}"
            cold.append(body["captions"][0]["caption"])
        s_after_cold = cache.stats()
        for img in base:
            status, body = _post_caption(port, img)
            assert status == 200, f"hit caption -> {status}"
            hot.append(body["captions"][0]["caption"])
        s_after_hot = cache.stats()
        mismatches = sum(1 for c, h in zip(cold, hot) if c != h)
        hits_taken = s_after_hot["hits"] - s_after_cold["hits"]
        log(f"parity: {len(base)} cold -> {len(base)} hot captions, "
            f"{mismatches} mismatches ({hits_taken} served from cache)")
        if mismatches or hits_taken < len(base):
            log(f"FAIL: hit-path parity broken (mismatches={mismatches}, "
                f"cache hits {hits_taken}/{len(base)})")
            return 1

        total = args.cache_requests

        def arm(name, jpegs):
            """Flush, run one open loop, return (loop, arm hit ratio,
            arm stats deltas) — the ratio is computed over the arm's OWN
            lookups so phases never cross-contaminate."""
            cache.flush()
            s0 = cache.stats()
            loop = open_loop(port, jpegs, args.cache_rate, total)
            s1 = cache.stats()
            served = {
                k: s1[k] - s0[k]
                for k in ("hits", "misses", "coalesced", "evictions")
            }
            looked = (
                served["hits"] + served["misses"] + served["coalesced"]
            )
            ratio = (
                (served["hits"] + served["coalesced"]) / looked
                if looked else 0.0
            )
            loop["goodput"] = (
                loop["ok"] / loop["wall_s"] if loop["wall_s"] else 0.0
            )
            log(f"{name} arm @ {args.cache_rate}/s: {loop['ok']} ok, "
                f"{loop['shed']} shed -> {loop['goodput']:.1f} req/s "
                f"(p50 {loop['p50']}ms p99 {loop['p99']}ms); cache "
                f"{served['hits']} hit / {served['misses']} miss / "
                f"{served['coalesced']} coalesced -> ratio {ratio:.3f}")
            return loop, round(ratio, 4), served

        # unique control first: every arrival distinct
        uniq_loop, uniq_ratio, _ = arm(
            "unique", _make_jpegs(total, config.image_size)
        )

        # zipf arm: rank-weighted repeats over the small base
        rng = np.random.default_rng(11)
        p = 1.0 / (np.arange(len(base)) + 1.0) ** args.zipf_s
        p = p / p.sum()
        zipf_seq = [base[int(r)] for r in rng.choice(
            len(base), size=total, p=p)]
        zipf_loop, zipf_ratio, zipf_served = arm("zipf", zipf_seq)

        recompiles = _builds(tel) - compiles0
        gather_ns = np.sort(np.asarray(
            tel.durations_ns("serve/cache_gather"), np.float64))
        gather_p95 = (
            round(float(gather_ns[min(gather_ns.size - 1,
                                      int(0.95 * gather_ns.size))]) / 1e6, 3)
            if gather_ns.size else None
        )
        stats_block = _get_json(port, "/stats").get("encode_cache", {})
        log(f"steady-state kernel builds across all arms: {recompiles}; "
            f"cache gather p95 {gather_p95}ms")

        common = {
            "requests_per_arm": total,
            "offered_rate_per_s": args.cache_rate,
            "encode_cache_mb": args.encode_cache_mb,
            "cache_rows": cache.rows,
            "zipf_s": args.zipf_s,
            "zipf_base_images": len(base),
            "steady_state_compiles": recompiles,
            "fused_attend_masked_launches": _launches()[1] - launches0[1],
            "device_kind": args.device_kind,
            "parity_mismatches": mismatches,
            **telemetry.bench_stamp(),
        }
        print(json.dumps({
            "metric": "encode_cache_hit_ratio",
            "value": zipf_ratio,
            "unit": "ratio",
            "unique_traffic_ratio": uniq_ratio,
            "zipf_hits": zipf_served["hits"],
            "zipf_misses": zipf_served["misses"],
            "zipf_coalesced": zipf_served["coalesced"],
            "zipf_evictions": zipf_served["evictions"],
            "cache_entries": stats_block.get("entries"),
            "cache_bytes": stats_block.get("bytes"),
            "gather_p95_ms": gather_p95,
            **common,
        }), flush=True)
        print(json.dumps({
            "metric": "cache_serve_goodput_rps",
            "value": round(zipf_loop["goodput"], 2),
            "unit": "req_per_s",
            "completed": zipf_loop["ok"], "shed": zipf_loop["shed"],
            "p50_ms": zipf_loop["p50"], "p95_ms": zipf_loop["p95"],
            "p99_ms": zipf_loop["p99"],
            "unique_goodput_rps": round(uniq_loop["goodput"], 2),
            "unique_p50_ms": uniq_loop["p50"],
            "unique_p99_ms": uniq_loop["p99"],
            **common,
        }), flush=True)

        ok = (
            recompiles == 0
            and mismatches == 0
            and zipf_ratio >= 0.6
            and uniq_ratio <= 0.05
        )
        if not ok:
            log(f"FAIL: cache invariant violated (recompiles="
                f"{recompiles}, parity mismatches {mismatches}, zipf "
                f"ratio {zipf_ratio} < 0.6 or unique ratio {uniq_ratio} "
                f"> 0.05)")
        return 0 if ok else 1
    finally:
        _CLIENT.close_all()
        server.shutdown()


def _post_admin(port, action, timeout=240.0):
    """POST a lifecycle admin verb; (status, payload).  Long timeout:
    /promote blocks on the replica until the swap lands."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/{action}", data=b"", method="POST"
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def lifecycle_bench(args, workdir) -> int:
    """--lifecycle: cost of a full reload -> canary -> promote cycle on
    a live continuous-mode server.

    Arm A is a steady open loop against the incumbent alone; a retrained
    checkpoint then lands (sidecar + LAST_GOOD) and arm B runs the SAME
    open loop mid-canary, so ``canary_overhead_pct`` is the p50 price of
    dual-slot serving (hash routing + a second live slot pool).  The
    operator promote that follows measures ``swap_blackout_ms`` — the
    admission gap while in-flight pools drain before the param-slot
    flip.  Exits nonzero on any steady-state recompile or any dropped
    (5xx / connection-failed) request across the whole cycle: the
    zero-downtime invariant IS the bench contract."""
    from .. import telemetry
    from ..data.vocabulary import vocab_fingerprint
    from ..resilience import lineage
    from ..serve.engine import ServeEngine, load_serving_state
    from ..serve.server import CaptionServer

    base_config, vocabulary, tel = _make_ckpt(args, workdir)
    config = base_config.replace(
        serve_mode="continuous",
        serve_slot_pages=args.slot_pages,
        serve_page_width=args.page_width,
        model_reload=0.0,          # the bench drives /reload itself
        canary_fraction=args.canary_fraction,
        canary_window_s=600.0,     # never auto-expires under the bench
        promote_policy="manual",   # the bench decides when to promote
        canary_shadow_rate=0.0,
    )
    state, _ = load_serving_state(config)
    engine = ServeEngine(config, state, vocabulary, tel=tel)
    engine.warmup()
    server = CaptionServer(config, engine, port=0).start()
    try:
        port = server.port
        jpegs = _make_jpegs(8, config.image_size)
        log(f"lifecycle server up on port {port} (slot pool "
            f"{args.slot_pages}x{args.page_width}, canary fraction "
            f"{args.canary_fraction})")
        _post(port, jpegs[0])  # warm pass (first-touch host costs)
        base_step = engine.step
        compiles0 = _builds(tel)
        launches0 = _launches()

        arm_a = open_loop(
            port, jpegs, args.lifecycle_rate, args.lifecycle_requests
        )
        log(f"arm A (incumbent only) @ {args.lifecycle_rate}/s: "
            f"{arm_a['ok']} ok, {arm_a['shed']} shed "
            f"(p50 {arm_a['p50']}ms p99 {arm_a['p99']}ms)")

        # a "retrain" lands: same geometry, nudged decoder params
        new_step = base_step + 100
        flat = dict(np.load(os.path.join(
            config.save_dir, f"{base_step}.npz")))
        for k in list(flat):
            if k.startswith("params/decoder/") and flat[k].dtype.kind == "f":
                flat[k] = flat[k] + np.asarray(1e-3, flat[k].dtype)
        flat["global_step"] = np.asarray(new_step, np.int64)
        cand_path = os.path.join(config.save_dir, f"{new_step}.npz")
        with open(cand_path, "wb") as f:
            np.savez(f, **flat)
        lineage.write_sidecar(cand_path, vocab=vocab_fingerprint(
            config.vocabulary_file, config.vocabulary_size))
        lineage.mark_last_good(config.save_dir, new_step)

        status, body = _post_admin(port, "reload")
        if status != 200:
            log(f"FAIL: /reload -> {status}: {body}")
            return 1
        deadline = time.time() + 120.0
        while time.time() < deadline:
            if _get_json(port, "/stats")["lifecycle"]["state"] == "CANARY":
                break
            time.sleep(0.05)
        else:
            log("FAIL: canary never armed")
            return 1
        log(f"canary armed for step {new_step}")

        arm_b = open_loop(
            port, jpegs, args.lifecycle_rate, args.lifecycle_requests
        )
        log(f"arm B (mid-canary) @ {args.lifecycle_rate}/s: "
            f"{arm_b['ok']} ok, {arm_b['shed']} shed "
            f"(p50 {arm_b['p50']}ms p99 {arm_b['p99']}ms)")

        status, body = _post_admin(port, "promote")
        if status != 200 or body.get("model_step") != new_step:
            log(f"FAIL: /promote -> {status}: {body}")
            return 1
        stats = _get_json(port, "/stats")
        last = stats["lifecycle"].get("last_cycle") or {}
        blackout_ms = last.get("blackout_ms")
        # post-promote sanity: the new incumbent answers
        post_status, _ = _post(port, jpegs[0])

        recompiles = _builds(tel) - compiles0
        http_5xx = tel.counters().get("serve/http_5xx", 0)
        errors = arm_a["errors"] + arm_b["errors"]
        overhead_pct = (
            round((arm_b["p50"] / arm_a["p50"] - 1.0) * 100.0, 2)
            if arm_a["p50"] else None
        )
        log(f"promoted step {new_step}: swap blackout {blackout_ms}ms, "
            f"canary p50 overhead {overhead_pct}%, steady-state "
            f"recompiles {recompiles}, 5xx {http_5xx}")

        common = {
            "slot_pages": args.slot_pages,
            "page_width": args.page_width,
            "canary_fraction": args.canary_fraction,
            "offered_rate_per_s": args.lifecycle_rate,
            "requests_per_arm": args.lifecycle_requests,
            "steady_state_compiles": recompiles,
            "fused_attend_masked_launches": _launches()[1] - launches0[1],
            "device_kind": args.device_kind,
            "http_5xx": http_5xx,
            **telemetry.bench_stamp(),
        }
        print(json.dumps({
            "metric": "swap_blackout_ms",
            "value": blackout_ms,
            "unit": "ms",
            "promoted_step": new_step,
            "drain_mode": "continuous",
            **common,
        }), flush=True)
        print(json.dumps({
            "metric": "canary_overhead_pct",
            "value": overhead_pct,
            "unit": "pct",
            "incumbent_p50_ms": arm_a["p50"],
            "canary_p50_ms": arm_b["p50"],
            "incumbent_p99_ms": arm_a["p99"],
            "canary_p99_ms": arm_b["p99"],
            **common,
        }), flush=True)
        ok = (
            recompiles == 0 and http_5xx == 0 and errors == 0
            and blackout_ms is not None and post_status == 200
        )
        if not ok:
            log("FAIL: zero-downtime invariant violated "
                f"(recompiles={recompiles}, 5xx={http_5xx}, "
                f"errors={errors}, blackout={blackout_ms}, "
                f"post_promote={post_status})")
        return 0 if ok else 1
    finally:
        server.shutdown()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sat_tpu_torch.tools.bench_serve",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--requests", type=int, default=25,
                    help="closed loop: requests per worker")
    ap.add_argument("--rate", type=float, default=50.0,
                    help="open loop: Poisson arrival rate, req/s")
    ap.add_argument("--cont-rate", type=float, default=8.5,
                    help="batch-vs-continuous comparison: Poisson rate "
                         "near the batch path's padded-bucket capacity")
    ap.add_argument("--open-requests", type=int, default=200,
                    help="open loop: total arrivals")
    ap.add_argument("--buckets", default="1,4,16")
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--queue-depth", type=int, default=128)
    ap.add_argument("--slot-pages", type=int, default=4,
                    help="continuous mode: pages in the slot pool")
    ap.add_argument("--page-width", type=int, default=4,
                    help="continuous mode: slots per page")
    ap.add_argument("--quant-ab", choices=("none", "bf16", "int8"),
                    default="none",
                    help="A/B the PTQ encoder (sat_tpu_torch/nn/quant.py): after "
                         "the fp32 loops, reload the SAME checkpoint with "
                         "--encoder_quant and re-run the closed loop, "
                         "emitting serve_encode_ms / *_<mode> row pairs")
    ap.add_argument("--eos-bias", type=float, default=0.006,
                    help="EOS-logit bias on the fresh params: sits on the "
                         "seal-step cliff so the diverse bench images give "
                         "mixed caption lengths — most seal in 2-3 steps, "
                         "a few run to max_caption_length (0 disables)")
    ap.add_argument("--fleet", action="store_true",
                    help="fleet mode: goodput scaling across N router-"
                         "fronted replicas instead of the single-server "
                         "arms (fleet_goodput_rps / "
                         "fleet_open_loop_p99_latency_ms rows)")
    ap.add_argument("--fleet-sizes", default="1,2,4",
                    help="fleet mode: replica counts per arm (max is "
                         "spawned once; arms front prefixes)")
    ap.add_argument("--fleet-rate", type=float, default=10.0,
                    help="fleet mode: matched open-loop Poisson rate per "
                         "arm; well above the LARGEST arm's capacity so "
                         "every arm is backlogged from its first dispatch "
                         "(full micro-batches throughout) and goodput "
                         "tracks fleet capacity at every size")
    ap.add_argument("--fleet-requests", type=int, default=24,
                    help="fleet mode: total arrivals per arm (bounded by "
                         "the saturated n=1 arm's wall time against the "
                         "client/proxy timeouts)")
    ap.add_argument("--fleet-service-floor-ms", type=int, default=4000,
                    help="fleet mode: per-dispatched-batch service-time "
                         "floor armed on every replica via "
                         "SAT_FI_SLOW_SERVE_MS.  Makes each replica "
                         "occupancy-bound (like a device-backed one) so "
                         "goodput scales with fleet size even when all "
                         "replicas share this host's CPUs; 0 disables "
                         "and measures raw CPU-decode contention")
    ap.add_argument("--tenants", action="store_true",
                    help="tenant mode: per-tenant SLO isolation + DRR "
                         "fair-share on one continuous-mode server "
                         "(tenant_isolation_p99_ratio / "
                         "tenant_fair_share_error rows; exit 1 on any "
                         "recompile, victim-lane shed/error or flood 5xx)")
    ap.add_argument("--tenant-rate", type=float, default=6.0,
                    help="tenant mode: victim open-loop Poisson rate for "
                         "the alone and under-flood arms")
    ap.add_argument("--tenant-requests", type=int, default=80,
                    help="tenant mode: victim arrivals per arm")
    ap.add_argument("--tenant-flood-rate", type=float, default=30.0,
                    help="tenant mode: offered flood rate, several times "
                         "the flood tenant's admission quota")
    ap.add_argument("--tenant-flood-rps", type=float, default=1.0,
                    help="tenant mode: the flood tenant's token-bucket "
                         "quota (rps; burst = 2x).  Small relative to "
                         "the box's capacity: the admitted remainder is "
                         "the flood's LEGAL share, and the isolation "
                         "ratio should price only that")
    ap.add_argument("--tenant-concurrency", type=int, default=18,
                    help="tenant mode: blocking clients PER TENANT in "
                         "the fair-share phase — must exceed the "
                         "victim's weighted share of the slot pool, or "
                         "its lane drains and work-conservation hands "
                         "the peer extra seats")
    ap.add_argument("--tenant-share-seconds", type=float, default=12.0,
                    help="tenant mode: wall-clock length of the "
                         "fair-share contended window")
    ap.add_argument("--metering", action="store_true",
                    help="metering mode: cost-attribution overhead + "
                         "would-be encode-cache probe "
                         "(metering_overhead_pct / "
                         "encode_cache_would_hit_ratio rows; exit 1 on "
                         "raw overhead > 0.5%%, identity error > 5%%, "
                         "any recompile, or a dead/false probe)")
    ap.add_argument("--metering-rate", type=float, default=6.0,
                    help="metering mode: open-loop Poisson rate per arm")
    ap.add_argument("--metering-requests", type=int, default=60,
                    help="metering mode: arrivals per arm")
    ap.add_argument("--zipf-s", type=float, default=1.1,
                    help="metering mode: Zipf exponent for the repeat-"
                         "heavy arm (rank r drawn with p proportional "
                         "to 1/(r+1)^s over the 16 base images)")
    ap.add_argument("--encode-cache", action="store_true",
                    help="cache mode: content-addressed encode cache "
                         "under Zipf vs unique traffic "
                         "(encode_cache_hit_ratio / "
                         "cache_serve_goodput_rps rows; exit 1 on any "
                         "recompile, hit/cold caption mismatch, Zipf "
                         "ratio < 0.6 or unique ratio > 0.05)")
    ap.add_argument("--cache-rate", type=float, default=6.0,
                    help="cache mode: open-loop Poisson rate per arm")
    ap.add_argument("--cache-requests", type=int, default=80,
                    help="cache mode: arrivals per arm")
    ap.add_argument("--encode-cache-mb", type=int, default=8,
                    help="cache mode: device ring budget (MB); a "
                         "flagship grid (196 x 512 float32) is 0.4 MB, so "
                         "the default holds about 20 rows, more than the "
                         "Zipf arm's 16 base images")
    ap.add_argument("--lifecycle", action="store_true",
                    help="lifecycle mode: a full reload -> canary -> "
                         "promote cycle on a live continuous-mode server "
                         "(swap_blackout_ms / canary_overhead_pct rows; "
                         "exit 1 on any recompile or dropped request)")
    ap.add_argument("--lifecycle-rate", type=float, default=8.0,
                    help="lifecycle mode: open-loop Poisson rate for the "
                         "incumbent-only and mid-canary arms")
    ap.add_argument("--lifecycle-requests", type=int, default=120,
                    help="lifecycle mode: arrivals per arm")
    ap.add_argument("--canary-fraction", type=float, default=0.25,
                    help="lifecycle mode: request fraction hash-routed "
                         "to the candidate during arm B")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--extra-set", action="append", default=[], metavar="KEY=VALUE",
                    help="Config overrides over the flagship model (the port's "
                         "addition; the tests' small widths)")
    args = ap.parse_args(argv)
    # the card, unless SAT_TORCH_DEVICE=cpu asks for the CPU (the serve
    # stack and the fleet's replicas read the same request)
    args.device_kind = device_kind(bench_device())

    workdir = args.workdir or tempfile.mkdtemp(prefix="bench_serve_")
    made_workdir = args.workdir is None
    if (args.fleet or args.lifecycle or args.tenants or args.metering
            or args.encode_cache):
        try:
            if args.fleet:
                return fleet_bench(args, workdir)
            if args.tenants:
                return tenants_bench(args, workdir)
            if args.metering:
                return metering_bench(args, workdir)
            if args.encode_cache:
                return encode_cache_bench(args, workdir)
            return lifecycle_bench(args, workdir)
        finally:
            if made_workdir:
                shutil.rmtree(workdir, ignore_errors=True)
    server = None
    try:
        from .. import telemetry

        server, engine, tel = _boot(args, workdir)
        jpegs = _make_jpegs(8, engine.config.image_size)
        port = server.port

        # one warm pass so steady-state numbers exclude first-touch costs
        _post(port, jpegs[0])
        compiles0 = _builds(tel)
        launches0 = _launches()
        enc_mark = len(tel.durations_ns("serve/encode"))

        closed = closed_loop(port, jpegs, args.concurrency, args.requests)
        log(f"closed loop: {closed['ok']} ok in {closed['wall_s']:.1f}s -> "
            f"{closed['throughput']:.1f} req/s "
            f"(p50 {closed['p50']}ms p99 {closed['p99']}ms)")

        opened = open_loop(port, jpegs, args.rate, args.open_requests)
        log(f"open loop @ {args.rate}/s: {opened['ok']} ok, "
            f"{opened['shed']} shed in {opened['wall_s']:.1f}s "
            f"(p50 {opened['p50']}ms p99 {opened['p99']}ms)")

        recompiles = _builds(tel) - compiles0
        batch_launches = tuple(b - a for a, b in zip(launches0, _launches()))
        log(f"steady-state kernel builds during load: {recompiles}; B1 launches "
            f"{batch_launches[0]}, B2 {batch_launches[1]}")

        counters = tel.counters()
        hist = {k[len("serve/bucket_"):]: v for k, v in counters.items()
                if k.startswith("serve/bucket_")}
        common = {
            "buckets": args.buckets,
            "max_batch": args.max_batch,
            "max_wait_ms": args.max_wait_ms,
            "bucket_histogram": hist,
            "warm_seconds": round(engine.warm_seconds, 3),
            "steady_state_compiles": recompiles,
            "fused_attend_launches": batch_launches[0],
            "device_kind": args.device_kind,
            **telemetry.bench_stamp(),
        }
        print(json.dumps({
            "metric": "serve_closed_loop_throughput",
            "value": round(closed["throughput"], 2),
            "unit": "req_per_s",
            "concurrency": args.concurrency,
            "requests_per_worker": args.requests,
            "p50_ms": closed["p50"], "p95_ms": closed["p95"],
            "p99_ms": closed["p99"],
            "tcp_connects": closed["tcp_connects"],
            "reconnects": closed["reconnects"],
            **common,
        }), flush=True)
        print(json.dumps({
            "metric": "serve_open_loop_p99_latency_ms",
            "value": opened["p99"],
            "unit": "ms",
            "offered_rate_per_s": args.rate,
            "completed": opened["ok"], "shed": opened["shed"],
            "p50_ms": opened["p50"], "p95_ms": opened["p95"],
            "tcp_connects": opened["tcp_connects"],
            **common,
        }), flush=True)

        def _enc_ms(start):
            """Encode-lane percentiles from the serve/encode spans the
            engine records (telemetry is on for the whole bench)."""
            ns = np.asarray(tel.durations_ns("serve/encode")[start:],
                            np.float64)
            if not ns.size:
                return None
            s = np.sort(ns) / 1e6
            def pct(p):
                return round(float(s[min(s.size - 1,
                                         int(p / 100.0 * s.size))]), 3)
            return {"count": int(s.size), "p50": pct(50), "p95": pct(95)}

        enc = _enc_ms(enc_mark)
        if enc:
            print(json.dumps({
                "metric": "serve_encode_ms",
                "value": enc["p50"],
                "unit": "ms",
                "percentile": "p50",
                "p95_ms": enc["p95"],
                "encodes": enc["count"],
                "encoder_quant": "off",
                **common,
            }), flush=True)

        # --- batch vs continuous at the SAME near-capacity rate ----------
        # deep saturation is the batch path's best case (every bucket
        # rides full, encode fully amortized); the regime continuous
        # batching exists for is offered load near the batch path's
        # padded-bucket capacity, where whole-batch windows hold every
        # request while lanes admit exactly what arrived
        ref = open_loop(port, jpegs, args.cont_rate, args.open_requests)
        ref_goodput = ref["ok"] / ref["wall_s"] if ref["wall_s"] else 0.0
        log(f"batch reference @ {args.cont_rate}/s: {ref['ok']} ok in "
            f"{ref['wall_s']:.1f}s -> {ref_goodput:.1f} req/s goodput "
            f"(p50 {ref['p50']}ms p99 {ref['p99']}ms)")

        server.shutdown()
        server = None
        from ..serve.server import CaptionServer

        cont_config = engine.config.replace(
            serve_mode="continuous",
            serve_slot_pages=args.slot_pages,
            serve_page_width=args.page_width,
        )
        server = CaptionServer(cont_config, engine, port=0).start()
        port = server.port
        log(f"continuous server up on port {port} (slot pool "
            f"{args.slot_pages}x{args.page_width}, pool warm "
            f"{server.pool.warm_seconds:.2f}s)")
        _post(port, jpegs[0])  # warm pass (first-touch host costs)
        cont_compiles0 = _builds(tel)
        cont0 = _launches()
        steps_before = len(tel.durations_ns("serve/decode_steps"))

        def _span_pcts(name, start, scale=1e6):
            """p50/p95 over tel spans recorded after mark `start` (ms by
            default; scale=1 for raw-count spans like
            serve/steps_per_dispatch, whose duration field carries the
            fused steps-run count, not a time)."""
            vals = np.asarray(tel.durations_ns(name)[start:], np.float64)
            if not vals.size:
                return None
            s = np.sort(vals) / scale

            def pct(p):
                return round(float(s[min(s.size - 1,
                                         int(p / 100.0 * s.size))]), 3)
            return {"count": int(s.size), "p50": pct(50), "p95": pct(95)}

        # --- single-stream latency: the fused window's best case ---------
        # one closed-loop client keeps the admission queue empty, so the
        # adaptive policy runs every dispatch at the ladder's deepest K
        # and the per-step host round-trip leaves the critical path.
        spd_before = len(tel.durations_ns("serve/steps_per_dispatch"))
        single = closed_loop(port, jpegs, 1, args.requests)
        single_spd = _span_pcts("serve/steps_per_dispatch", spd_before,
                                scale=1.0)
        log(f"single stream (ladder "
            f"{list(cont_config.serve_decode_depth)}): {single['ok']} ok, "
            f"p50 {single['p50']}ms p99 {single['p99']}ms, steps/dispatch "
            f"p50 {single_spd['p50'] if single_spd else '?'}")

        # admission + detok-queue spans are sliced from HERE so the rows
        # below sample only the near-capacity open-loop phase (warm-pass
        # and single-stream admissions would dilute the burst regime)
        admit_before = len(tel.durations_ns("serve/admission_wait"))
        detokq_before = len(tel.durations_ns("serve/detok_queue"))
        cont = open_loop(port, jpegs, args.cont_rate, args.open_requests)
        cont_goodput = cont["ok"] / cont["wall_s"] if cont["wall_s"] else 0.0
        log(f"continuous open loop @ {args.cont_rate}/s: {cont['ok']} ok, "
            f"{cont['shed']} shed in {cont['wall_s']:.1f}s -> "
            f"{cont_goodput:.1f} req/s goodput "
            f"(p50 {cont['p50']}ms p99 {cont['p99']}ms; batch @ same rate: "
            f"{ref_goodput:.1f} req/s, p99 {ref['p99']}ms)")

        cont_launches = tuple(b - a for a, b in zip(cont0, _launches()))
        cont_recompiles = (
            _builds(tel) - cont_compiles0
        )
        log(f"continuous steady-state kernel builds during load: "
            f"{cont_recompiles}")
        admit = _span_pcts("serve/admission_wait", admit_before)
        admit_p95 = admit["p95"] if admit else 0.0
        detok_queue = _span_pcts("serve/detok_queue", detokq_before)
        load_spd = _span_pcts("serve/steps_per_dispatch", spd_before,
                              scale=1.0)
        steps = np.asarray(
            tel.durations_ns("serve/decode_steps")[steps_before:], np.float64
        )
        cont_common = dict(common)
        cont_common.update(
            slot_pages=args.slot_pages,
            page_width=args.page_width,
            pool_warm_seconds=round(server.pool.warm_seconds, 3),
            fused_attend_launches=cont_launches[0],
            fused_attend_masked_launches=cont_launches[1],
            steady_state_compiles=cont_recompiles,
            decode_depths=list(cont_config.serve_decode_depth),
            decode_steps_p50=(
                float(np.percentile(steps, 50)) if steps.size else None
            ),
        )
        print(json.dumps({
            "metric": "serve_continuous_goodput",
            "value": round(cont_goodput, 2),
            "unit": "req_per_s",
            "offered_rate_per_s": args.cont_rate,
            "completed": cont["ok"], "shed": cont["shed"],
            "p50_ms": cont["p50"], "p95_ms": cont["p95"],
            "p99_ms": cont["p99"],
            "batch_ref_goodput": round(ref_goodput, 2),
            "batch_ref_p50_ms": ref["p50"],
            "batch_ref_p99_ms": ref["p99"],
            **cont_common,
        }), flush=True)
        print(json.dumps({
            "metric": "serve_admission_latency_ms",
            "value": admit_p95,
            "unit": "ms",
            "percentile": "p95",
            "admitted": admit["count"] if admit else 0,
            "admission_p50_ms": admit["p50"] if admit else None,
            "detok_queue_p50_ms": detok_queue["p50"] if detok_queue else None,
            "detok_queue_p95_ms": detok_queue["p95"] if detok_queue else None,
            "load_steps_per_dispatch_p50": (
                load_spd["p50"] if load_spd else None
            ),
            **cont_common,
        }), flush=True)

        # --- K-ladder A/B: same geometry, fused window pinned off --------
        # serve_decode_depth=(1,) is exactly the pre-fused engine (one
        # decode step per host dispatch); the delta against the ladder
        # arm above is the fused window's contribution, with admission
        # p95 under the SAME near-capacity load as the no-worse check.
        server.shutdown()
        server = None
        k1_config = cont_config.replace(serve_decode_depth=(1,))
        server = CaptionServer(k1_config, engine, port=0).start()
        log(f"K=1 arm up on port {server.port} (pool warm "
            f"{server.pool.warm_seconds:.2f}s)")
        _post(server.port, jpegs[0])  # warm pass
        k1_compiles0 = _builds(tel)
        k10 = _launches()
        k1_single = closed_loop(server.port, jpegs, 1, args.requests)
        k1_admit_before = len(tel.durations_ns("serve/admission_wait"))
        k1_open = open_loop(server.port, jpegs, args.cont_rate,
                            args.open_requests)
        k1_recompiles = _builds(tel) - k1_compiles0
        k1_launches = tuple(b - a for a, b in zip(k10, _launches()))
        k1_goodput = (
            k1_open["ok"] / k1_open["wall_s"] if k1_open["wall_s"] else 0.0
        )
        k1_admit = _span_pcts("serve/admission_wait", k1_admit_before)
        log(f"K=1 single stream: p50 {k1_single['p50']}ms p99 "
            f"{k1_single['p99']}ms; open loop goodput "
            f"{k1_goodput:.1f} req/s, admission p95 "
            f"{k1_admit['p95'] if k1_admit else 0.0}ms; steady-state "
            f"compiles {k1_recompiles}")

        print(json.dumps({
            "metric": "serve_single_stream_latency_ms",
            "value": single["p50"],
            "unit": "ms",
            "percentile": "p50",
            "p95_ms": single["p95"], "p99_ms": single["p99"],
            "requests": single["ok"],
            "steps_per_dispatch_p50": (
                single_spd["p50"] if single_spd else None
            ),
            "steps_per_dispatch_p95": (
                single_spd["p95"] if single_spd else None
            ),
            "k1_p50_ms": k1_single["p50"],
            "k1_p95_ms": k1_single["p95"],
            "k1_p99_ms": k1_single["p99"],
            "k1_goodput": round(k1_goodput, 2),
            "k1_admission_p95_ms": k1_admit["p95"] if k1_admit else None,
            "k1_steady_state_compiles": k1_recompiles,
            "k1_fused_attend_masked_launches": k1_launches[1],
            **cont_common,
        }), flush=True)

        # --- quantized-encoder A/B over the SAME checkpoint --------------
        q_recompiles = 0
        if args.quant_ab != "none":
            server.shutdown()
            server = None
            from ..serve.engine import ServeEngine, load_serving_state

            qconfig = engine.config.replace(encoder_quant=args.quant_ab)
            qstate, _ = load_serving_state(qconfig)
            qengine = ServeEngine(
                qconfig, qstate, engine.vocabulary, tel=tel
            )
            qengine.warmup()
            server = CaptionServer(qconfig, qengine, port=0).start()
            log(f"quant arm ({args.quant_ab}) up on port {server.port} "
                f"(quantize {qengine.quantize_seconds:.2f}s, "
                f"warm {qengine.warm_seconds:.2f}s)")
            _post(server.port, jpegs[0])  # warm pass
            q_compiles0 = _builds(tel)
            q0 = _launches()
            q_enc_mark = len(tel.durations_ns("serve/encode"))
            qclosed = closed_loop(
                server.port, jpegs, args.concurrency, args.requests
            )
            q_launches = tuple(b - a for a, b in zip(q0, _launches()))
            q_recompiles = (
                _builds(tel) - q_compiles0
            )
            log(f"quant closed loop: {qclosed['ok']} ok -> "
                f"{qclosed['throughput']:.1f} req/s "
                f"(p99 {qclosed['p99']}ms); steady-state compiles "
                f"{q_recompiles}")
            q_enc = _enc_ms(q_enc_mark)
            q_common = dict(common)
            q_common.update(
                encoder_quant=args.quant_ab,
                quantize_seconds=round(qengine.quantize_seconds, 3),
                steady_state_compiles=q_recompiles,
                fused_attend_launches=q_launches[0],
            )
            if q_enc:
                print(json.dumps({
                    "metric": f"serve_encode_ms_{args.quant_ab}",
                    "value": q_enc["p50"],
                    "unit": "ms",
                    "percentile": "p50",
                    "p95_ms": q_enc["p95"],
                    "encodes": q_enc["count"],
                    "fp32_encode_p50_ms": enc["p50"] if enc else None,
                    **q_common,
                }), flush=True)
            print(json.dumps({
                "metric": f"serve_closed_loop_throughput_{args.quant_ab}",
                "value": round(qclosed["throughput"], 2),
                "unit": "req_per_s",
                "p50_ms": qclosed["p50"], "p95_ms": qclosed["p95"],
                "p99_ms": qclosed["p99"],
                "fp32_throughput": round(closed["throughput"], 2),
                **q_common,
            }), flush=True)

        # shedding under overload is fine; recompiling under load is not
        # — in ANY lane, including every fused-decode K lane
        return 0 if (
            recompiles == 0 and cont_recompiles == 0
            and k1_recompiles == 0 and q_recompiles == 0
        ) else 1
    finally:
        if server is not None:
            server.shutdown()
        if made_workdir:
            shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
