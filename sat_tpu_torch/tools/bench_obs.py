"""Observability-layer cost accounting: tracing + exposition overhead — the
port of ``scripts/bench_obs.py`` over the port's ``telemetry``.

The contract: the request-scoped tracing layer and the Prometheus
exposition must be cheap enough to leave on for every request of every
serving process — tracing + exposition under 1% of a 30 ms step-scale
unit of work, and per-request tracing under 2% of a nominal closed-loop
request.  This bench puts numbers on both on the host alone (everything
measured is pure host work, same rationale as bench_telemetry.py; no
device, no torch, rows with ``device_kind`` "host-only"):

* ``tracing``: the full per-request trace lifecycle the serve path pays —
  ``begin`` (id sanitize/mint), five phase ``mark``s, and ``finish``
  (record build + rotating access.jsonl append + retention ring).
* ``exposition``: one ``promtext.render`` over a recorder populated with
  a realistic serve-shaped registry (the per-scrape cost; scrapes are
  15s-cadence in production, so this is *way* off the hot path, but the
  gate keeps a regression from making scrapes disruptive).

Prints BENCH-contract JSON lines on stdout accepted by
``check_regression.py``.  Exit 0 when both gates hold, 1 otherwise.

Usage: python -m sat_tpu_torch.tools.bench_obs [--iters 2000] [--step-ms 30]
       [--request-ms 30] [--workdir DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time


from .. import telemetry
from ..telemetry import promtext, tracectx
from .benchlib import make_log

# gates: tracing+exposition < 1% of a step-scale unit
# of work; per-request tracing < 2% of a closed-loop request
STEP_GATE_PCT = 1.0
REQUEST_GATE_PCT = 2.0

log = make_log("bench_obs")


def _trace_lifecycle(tracer: tracectx.RequestTracer, iters: int) -> float:
    """Seconds per full request-trace lifecycle (begin + 5 marks +
    finish with the access.jsonl append)."""
    t_start = time.perf_counter()
    for i in range(iters):
        trace = tracer.begin(f"bench-{i:08d}")
        t0 = trace.t_start_ns
        for phase in tracectx.PHASES:
            trace.mark(phase, t0, 1_000_000)
        tracer.finish(trace, 200, 30_000_000, bucket=16)
    return (time.perf_counter() - t_start) / iters


def _populate(tel, requests: int = 512) -> None:
    """Give the recorder a serve-shaped registry so render() iterates a
    realistic name population."""
    for name in ("serve/request", "serve/queue_wait", "serve/preprocess",
                 "serve/dispatch", "serve/detok"):
        for _ in range(64):
            tel.record(name, time.perf_counter_ns(), 1_000_000)
    for i in range(requests):
        tel.count("serve/http_requests")
        tel.count("serve/completed")
    for b in (1, 4, 16, 32):
        tel.count(f"serve/bucket_{b}", 7)
    tel.gauge("serve/queue_depth", 3)
    tel.gauge("serve/ready", 1)
    for i in range(8):
        tel.gauge(f"slo/objective_{i}_burn", 0.4)


def _render_cost(tel, iters: int) -> float:
    t_start = time.perf_counter()
    for _ in range(iters):
        text = promtext.render(tel, extra={"steps_per_s": 3.2})
    assert text.endswith("sat_up 1\n")
    return (time.perf_counter() - t_start) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sat_tpu_torch.tools.bench_obs",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=2000,
                    help="request-trace lifecycles / renders per measurement")
    ap.add_argument("--step-ms", type=float, default=30.0,
                    help="step-scale work unit the combined overhead is "
                         "judged against")
    ap.add_argument("--request-ms", type=float, default=30.0,
                    help="nominal closed-loop request latency the tracing "
                         "cost is judged against")
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args(argv)

    workdir = args.workdir or tempfile.mkdtemp(prefix="bench_obs_")
    made_workdir = args.workdir is None
    try:
        tel = telemetry.enable(capacity=65536)
        _populate(tel)

        tracer = tracectx.RequestTracer(
            path=os.path.join(workdir, "access.jsonl"),
            cap_bytes=8 * 1024 * 1024,
        )
        _trace_lifecycle(tracer, 200)  # warm (interning, first open)
        trace_s = _trace_lifecycle(tracer, args.iters)
        trace_us = trace_s * 1e6

        _render_cost(tel, 20)  # warm
        render_s = _render_cost(tel, max(200, args.iters // 10))
        render_us = render_s * 1e6
        telemetry.disable()

        # combined per-unit-of-work cost: one traced request + one
        # amortized scrape share (15 s cadence vs ~33 req/s at 30 ms —
        # charge 1/500th of a render per request, rounded up to 1/100th
        # to stay conservative)
        combined_us = trace_us + render_us / 100.0
        step_pct = 100.0 * (combined_us / 1e3) / args.step_ms
        request_pct = 100.0 * (trace_us / 1e3) / args.request_ms
        log(f"trace lifecycle {trace_us:.2f} us, render {render_us:.2f} us "
            f"-> {step_pct:.4f}% of a {args.step_ms:.0f} ms step, "
            f"{request_pct:.4f}% of a {args.request_ms:.0f} ms request")

        rows = [
            {
                "metric": "obs_tracing_exposition_overhead",
                "value": round(step_pct, 4),
                "unit": "%_of_step",
                "vs_baseline": STEP_GATE_PCT,
                "trace_lifecycle_us": round(trace_us, 3),
                "render_us": round(render_us, 3),
                "step_ms_assumed": args.step_ms,
                "device_kind": "host-only",
                **telemetry.bench_stamp(),
            },
            {
                "metric": "obs_request_tracing_overhead",
                "value": round(request_pct, 4),
                "unit": "%_of_request",
                "vs_baseline": REQUEST_GATE_PCT,
                "trace_lifecycle_us": round(trace_us, 3),
                "request_ms_assumed": args.request_ms,
                "device_kind": "host-only",
                **telemetry.bench_stamp(),
            },
        ]
        for row in rows:
            print(json.dumps(row), flush=True)
        ok = step_pct <= STEP_GATE_PCT and request_pct <= REQUEST_GATE_PCT
        if not ok:
            log(f"GATE FAIL: step {step_pct:.3f}% (bar {STEP_GATE_PCT}%) "
                f"request {request_pct:.3f}% (bar {REQUEST_GATE_PCT}%)")
        return 0 if ok else 1
    finally:
        telemetry.disable()
        if made_workdir:
            shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
