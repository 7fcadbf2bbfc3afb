"""Watchdog cost accounting: guarded-vs-bare step-loop overhead — the
port of ``scripts/bench_watchdog.py`` over the port's
``resilience.watchdog``.

The hang/wedge watchdog is claimed to observe the train loop for < 0.5%
of a production step — the guards are two GIL-atomic dict writes per
phase and the observer thread reads host clocks on its own schedule,
never the loop's.  This bench puts a number on the claim on the host
alone: the instrumented cost is pure host work, so a synthetic
loop performing exactly the per-step guard sequence runtime.train
performs (one ``data_wait`` guard, one ``step`` guard wrapping a
``dispatch`` guard — the checkpoint guard only runs every save_period
steps and is excluded as conservative) measures the same cost the real
loop pays.

* ``off``: the loop body with no watchdog constructed — the bare
  baseline.
* ``on``: the same body bracketed by a live, **started** watchdog's
  phase guards while its observer thread polls — the armed cost.

Prints one BENCH-contract JSON line ({"metric", "value", "unit",
"vs_baseline", ...extras}).  ``value`` is the armed overhead in percent
of a ``--step-ms`` device step (0.5 is the acceptance bar, gated by
tools/check_regression.py like every "overhead" metric).  No device
and no torch (rows with ``device_kind`` "host-only").

Usage: python -m sat_tpu_torch.tools.bench_watchdog [--step-ms 30] [--iters 200000]
       [--workdir DIR]
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
from ..resilience.watchdog import Watchdog
from .benchlib import make_log

log = make_log("bench_watchdog")


def _bare_loop(iters: int) -> float:
    """The guard-free skeleton; seconds per step."""
    t_start = time.perf_counter()
    sink = 0
    for step in range(iters):
        sink += step  # same trivial body both loops carry
    assert sink >= 0
    return (time.perf_counter() - t_start) / iters


def _guarded_loop(wd: Watchdog, iters: int) -> float:
    """runtime.train's per-step guard sequence; seconds per step."""
    t_start = time.perf_counter()
    sink = 0
    for step in range(iters):
        with wd.phase("data_wait"):
            pass
        with wd.phase("step"):
            sink += step
            with wd.phase("dispatch"):
                pass
    assert sink >= 0
    return (time.perf_counter() - t_start) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sat_tpu_torch.tools.bench_watchdog",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--step-ms", type=float, default=30.0,
                    help="device step time the overhead is judged against")
    ap.add_argument("--iters", type=int, default=200000,
                    help="synthetic steps per measurement")
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args(argv)

    workdir = args.workdir or tempfile.mkdtemp(prefix="bench_watchdog_")
    made_workdir = args.workdir is None
    try:
        telemetry.disable()
        # warm both paths (interning, allocator) before timing
        _bare_loop(1000)
        off_s = _bare_loop(args.iters)

        wd = Watchdog(
            {"step": 3600.0, "data_wait": 3600.0, "dispatch": 3600.0},
            poll_s=0.25,
            dump_path=os.path.join(workdir, "watchdog_stacks.txt"),
        )
        wd.start()  # armed: the observer thread polls while we measure
        try:
            _guarded_loop(wd, 1000)
            on_s = _guarded_loop(wd, args.iters)
        finally:
            wd.stop()
        assert wd.state == 0 and wd.aborted_rc is None  # never tripped

        off_us, on_us = off_s * 1e6, on_s * 1e6
        overhead_us = max(0.0, on_us - off_us)
        overhead_pct = 100.0 * (overhead_us / 1e3) / args.step_ms
        log(f"per-step: bare {off_us:.3f} us, guarded {on_us:.3f} us -> "
            f"{overhead_pct:.4f}% of a {args.step_ms:.0f} ms step")

        result = {
            "metric": "watchdog_hot_path_overhead",
            "value": round(overhead_pct, 4),
            "unit": "%_of_step",
            "vs_baseline": 0.5,  # the acceptance bar: < 0.5%
            "watchdog_on_us_per_step": round(on_us, 3),
            "watchdog_off_us_per_step": round(off_us, 3),
            "step_ms_assumed": args.step_ms,
            "poll_s": wd.poll_s,
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
