"""Telemetry cost accounting: instrumented-vs-bare step-loop overhead — the
port of ``scripts/bench_telemetry.py`` over the port's ``telemetry``.

The telemetry layer is claimed cheap enough to leave on for every step
of every run (≤ 0.5% of step time), and free when off.  This bench puts
numbers on both claims on the host alone — the instrumentation
is pure host work, so a synthetic step loop that performs exactly the
per-step telemetry call sequence the train loop performs (one data-wait
record, one dispatch span, one step gauge, one step record; plus the
log-boundary extras every ``log_every`` steps) measures the same cost the
real loop pays:

* ``off``: the call sequence against the null implementation — what every
  *uninstrumented* run pays for the hooks existing at all.
* ``on``: the same sequence against a live ring-buffer recorder.
* ``export``: one Chrome-trace + breakdown export of the recorded run
  (end-of-run cost, never on the hot path — reported, not gated).

Prints BENCH-contract JSON lines on stdout ({"metric", "value", "unit",
"vs_baseline", ...extras}).  ``value`` is the telemetry-on hot-path
overhead in percent of a ``--step-ms`` device step (0.5 is the acceptance
bar).  It touches no device and imports no torch (its rows say
``device_kind`` "host-only"): it runs on a host with no card at all.

Usage: python -m sat_tpu_torch.tools.bench_telemetry [--step-ms 30] [--iters 50000]
       [--log-every 10] [--workdir DIR]
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
from ..telemetry import exporters
from .benchlib import make_log

log = make_log("bench_telemetry")


def _step_sequence(tel, iters: int, log_every: int) -> float:
    """Run the train loop's per-step telemetry call sequence ``iters``
    times against ``tel``; returns seconds per step.

    Mirrors runtime.train: a data-wait record (what ``_timed_iter`` does),
    the dispatch span, the step gauge, the whole-step record, and — every
    ``log_every`` steps — the log-sync span the metrics fetch rides in.
    """
    t_start = time.perf_counter()
    step_t0 = time.perf_counter_ns()
    for step in range(iters):
        t0 = time.perf_counter_ns()
        tel.record("train/data_wait", t0, time.perf_counter_ns() - t0)
        with tel.span("train/dispatch"):
            pass
        tel.gauge("train/step", step)
        if step % log_every == 0:
            with tel.span("train/log_sync"):
                pass
        now = time.perf_counter_ns()
        tel.record("train/step", step_t0, now - step_t0)
        step_t0 = now
    return (time.perf_counter() - t_start) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sat_tpu_torch.tools.bench_telemetry",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--step-ms", type=float, default=30.0,
                    help="device step time the overhead is judged against")
    ap.add_argument("--iters", type=int, default=50000,
                    help="synthetic steps per measurement")
    ap.add_argument("--log-every", type=int, default=10,
                    help="log-boundary cadence, as in Config.log_every")
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args(argv)

    workdir = args.workdir or tempfile.mkdtemp(prefix="bench_telemetry_")
    made_workdir = args.workdir is None
    try:
        # warm both paths once (interning, allocator) before timing
        telemetry.disable()
        _step_sequence(telemetry.get(), 1000, args.log_every)
        off_s = _step_sequence(telemetry.get(), args.iters, args.log_every)

        tel = telemetry.enable(capacity=65536)
        _step_sequence(tel, 1000, args.log_every)
        tel = telemetry.enable(capacity=65536)  # fresh buffers for the run
        on_s = _step_sequence(tel, args.iters, args.log_every)
        telemetry.disable()

        off_us, on_us = off_s * 1e6, on_s * 1e6
        overhead_pct = 100.0 * (on_us / 1e3) / args.step_ms
        log(f"per-step telemetry: off {off_us:.3f} us, on {on_us:.3f} us "
            f"-> {overhead_pct:.4f}% of a {args.step_ms:.0f} ms step")

        # end-of-run export cost (never on the hot path)
        t0 = time.perf_counter()
        trace_path = exporters.export_chrome_trace(
            tel, os.path.join(workdir, "trace.json"))
        report = exporters.step_breakdown(
            tel, "train/step",
            ("train/data_wait", "train/dispatch", "train/log_sync"))
        assert trace_path and report is not None
        assert report["steps"] == args.iters
        export_ms = 1e3 * (time.perf_counter() - t0)
        log(f"end-of-run export (trace + breakdown): {export_ms:.1f} ms "
            f"for {args.iters} steps")

        result = {
            "metric": "telemetry_hot_path_overhead",
            "value": round(overhead_pct, 4),
            "unit": "%_of_step",
            "vs_baseline": 0.5,  # the acceptance bar: <= 0.5%
            "telemetry_on_us_per_step": round(on_us, 3),
            "telemetry_off_us_per_step": round(off_us, 3),
            "step_ms_assumed": args.step_ms,
            "log_every": args.log_every,
            "ring_capacity": tel._capacity,
            "export_ms": round(export_ms, 1),
            "device_kind": "host-only",
            **telemetry.bench_stamp(),
        }
        print(json.dumps(result), flush=True)
        return 0 if overhead_pct <= 0.5 else 1
    finally:
        if made_workdir:
            shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
