"""Fleet-plane + black-box hot-path cost accounting — the port of
``scripts/bench_fleet.py`` over the port's ``telemetry``.

The contract: the fleet telemetry plane and the flight recorder must be
cheap enough to leave on for every training run — their per-boundary
cost, amortized over ``log_every`` steps, under 0.5% of a 30 ms step.
This bench puts numbers on the three host-side pieces the log boundary
pays (no device, no torch — everything measured is pure host work, same
rationale as bench_obs.py; rows with ``device_kind`` "host-only"):

* ``fleet_tick``: one full ``FleetPlane.tick`` on process 0 of a
  simulated 8-host fleet — local percentile extraction, atomic sidecar
  write, reading the 8 peer sidecars, aggregation, fleet.json +
  fleet_history.jsonl emission, gauge publication.
* ``bb_journal``: one black-box ``journal`` (counters/gauges snapshot
  appended to the ring segment).
* ``bb_append``: one raw ring event append (the unit the span/event
  hooks pay).

Prints BENCH-contract JSON lines on stdout accepted by
``check_regression.py``.  Exit 0 when the gate holds, 1 otherwise.

Usage: python -m sat_tpu_torch.tools.bench_fleet [--iters 500] [--hosts 8]
       [--step-ms 30] [--log-every 10] [--workdir DIR]
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
from ..telemetry import blackbox as bb_mod
from ..telemetry import fleet as fleet_mod
from .benchlib import make_log

# the gate: fleet tick + one journal, amortized over the boundary's
# log_every steps, under 0.5% of a step
GATE_PCT = 0.5

log = make_log("bench_fleet")


def _populate(tel, steps: int = 256) -> None:
    """A train-shaped recorder: step/data_wait/dispatch spans so the
    percentile extraction iterates a realistic window."""
    for _ in range(steps):
        now = time.perf_counter_ns()
        tel.record("train/step", now, 30_000_000)
        tel.record("train/data_wait", now, 2_000_000)
        tel.record("train/dispatch", now, 1_000_000)
    tel.gauge("train/step", steps)
    tel.gauge("data/quarantined_total", 3)


def _seed_peers(fleet_dir: str, hosts: int) -> None:
    """Sidecars for the simulated peer processes (process 0 is live)."""
    for p in range(1, hosts):
        fleet_mod.sidecar_path(fleet_dir, p)  # path shape sanity
        with open(fleet_mod.sidecar_path(fleet_dir, p), "w") as f:
            json.dump(
                {
                    "process_index": p,
                    "host": f"host{p}",
                    "step": 256,
                    "time_unix": time.time(),
                    "step_p50_ms": 30.0,
                    "step_p95_ms": 31.0,
                    "data_wait_ms": 2.0,
                    "dispatch_ms": 1.0,
                    "rss_mb": 512.0,
                    "quarantined": 0.0,
                },
                f,
            )


def _tick_cost(plane, iters: int) -> float:
    t_start = time.perf_counter()
    for i in range(iters):
        plane.tick(256 + i)
    return (time.perf_counter() - t_start) / iters


def _journal_cost(bb, iters: int) -> float:
    t_start = time.perf_counter()
    for i in range(iters):
        bb.journal(256 + i)
    return (time.perf_counter() - t_start) / iters


def _append_cost(bb, iters: int) -> float:
    t_start = time.perf_counter()
    for i in range(iters):
        bb.append("bench", {"i": i})
    return (time.perf_counter() - t_start) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sat_tpu_torch.tools.bench_fleet",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--hosts", type=int, default=8,
                    help="simulated fleet size (peer sidecars on disk)")
    ap.add_argument("--step-ms", type=float, default=30.0)
    ap.add_argument("--log-every", type=int, default=10,
                    help="boundary cadence the per-boundary cost is "
                         "amortized over")
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args(argv)

    workdir = args.workdir or tempfile.mkdtemp(prefix="bench_fleet_")
    made_workdir = args.workdir is None
    try:
        tel = telemetry.enable(capacity=4096)
        _populate(tel)
        fleet_dir = os.path.join(workdir, "fleet")
        os.makedirs(fleet_dir, exist_ok=True)
        _seed_peers(fleet_dir, args.hosts)
        plane = fleet_mod.FleetPlane(
            fleet_dir, 0, args.hosts, tel, straggler_factor=2.0
        )
        bb = bb_mod.BlackBox(os.path.join(workdir, "blackbox"), tel)

        _tick_cost(plane, 20)  # warm (first opens, interning)
        tick_s = _tick_cost(plane, args.iters)
        _journal_cost(bb, 20)
        journal_s = _journal_cost(bb, args.iters)
        _append_cost(bb, 50)
        append_s = _append_cost(bb, args.iters * 4)
        telemetry.disable()

        tick_us = tick_s * 1e6
        journal_us = journal_s * 1e6
        append_us = append_s * 1e6
        # the boundary pays one tick + one journal every log_every steps
        boundary_us = tick_us + journal_us
        per_step_us = boundary_us / max(1, args.log_every)
        step_pct = 100.0 * (per_step_us / 1e3) / args.step_ms
        log(f"fleet tick {tick_us:.1f} us ({args.hosts} hosts), "
            f"journal {journal_us:.1f} us, append {append_us:.2f} us -> "
            f"{per_step_us:.2f} us/step = {step_pct:.4f}% of a "
            f"{args.step_ms:.0f} ms step (log_every={args.log_every})")

        rows = [
            {
                "metric": "fleet_blackbox_step_overhead",
                "value": round(step_pct, 4),
                "unit": "%_of_step",
                "vs_baseline": GATE_PCT,
                "fleet_tick_us": round(tick_us, 2),
                "bb_journal_us": round(journal_us, 2),
                "hosts_simulated": args.hosts,
                "log_every_assumed": args.log_every,
                "step_ms_assumed": args.step_ms,
                "device_kind": "host-only",
                **telemetry.bench_stamp(),
            },
            {
                "metric": "blackbox_append",
                "value": round(append_us, 3),
                "unit": "us",
                "vs_baseline": 50.0,
                "device_kind": "host-only",
                **telemetry.bench_stamp(),
            },
        ]
        for row in rows:
            print(json.dumps(row), flush=True)
        ok = step_pct <= GATE_PCT
        if not ok:
            log(f"GATE FAIL: {step_pct:.3f}% of step (bar {GATE_PCT}%)")
        return 0 if ok else 1
    finally:
        telemetry.disable()
        if made_workdir:
            shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
