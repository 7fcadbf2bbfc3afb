"""Resilience-layer cost accounting: checkpoint lineage + sentinel overhead
— the port of ``scripts/bench_ckpt.py`` over the port's ``resilience``.

The subsystem is claimed effectively free on the hot path: the anomaly
sentinel reads host floats the ``log_every`` fetch
already paid for, the fault-injection hooks are inert compares, and the
lineage tail (sha256 sidecar + post-write verify + retention) runs on the
async writer's thread, overlapped with training.  This bench puts numbers
on each piece —

* ``save``: atomic npz write of a synthetic flat checkpoint (``--mb``
  controls the Adam-slots-included size) — the work the async worker does.
* ``lineage``: sidecar hash + post-write verify + LAST_GOOD advance —
  the tail every save carries.
* ``sentinel``/``hooks``: per-step host-side cost of an armed
  AnomalySentinel check and the inert ``FaultPlan``/``consume_io_fault``
  compares, expressed against a ``--step-ms`` device step.

Prints BENCH-contract JSON lines on stdout ({"metric", "value", "unit",
"vs_baseline", ...extras}).  ``value`` is the hot-path overhead of the
resilience layer in percent of a step (< 2 is the acceptance bar; the
lineage tail is reported separately because the async writer hides it).
A pure host-side measurement: no device and no torch (rows with
``device_kind`` "host-only"), so it never wedges on an unreachable card.

Usage: python -m sat_tpu_torch.tools.bench_ckpt [--mb 64] [--step-ms 30]
       [--iters 20000] [--workdir DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time


import numpy as np

from ..resilience import lineage
from ..resilience.faultinject import FaultPlan, consume_io_fault
from ..resilience.retry import retry_io
from ..resilience.sentinel import AnomalySentinel
from ..utils.fileio import atomic_write
from .benchlib import make_log

log = make_log("bench_ckpt")


def _fake_flat(total_mb: float, seed: int = 0) -> dict:
    """A flat checkpoint dict shaped like a real run: a few big kernels,
    many small biases, float32 throughout (params + 2 Adam slots is what
    makes real checkpoints ~3x the param bytes)."""
    rng = np.random.default_rng(seed)
    total = int(total_mb * (1 << 20) // 4)
    flat, i = {}, 0
    while total > 0:
        n = min(total, max(1024, total // 3))
        flat[f"leaf_{i}"] = rng.normal(size=(n,)).astype(np.float32)
        total -= n
        i += 1
    flat["global_step"] = np.asarray(1000, np.int64)
    return flat


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sat_tpu_torch.tools.bench_ckpt",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=float, default=64.0,
                    help="synthetic checkpoint size (params + Adam slots)")
    ap.add_argument("--step-ms", type=float, default=30.0,
                    help="device step time the overheads are judged against")
    ap.add_argument("--iters", type=int, default=20000,
                    help="hot-path hook iterations (timed per-call)")
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args(argv)

    workdir = args.workdir or tempfile.mkdtemp(prefix="bench_ckpt_")
    made_workdir = args.workdir is None
    save_dir = os.path.join(workdir, "ckpt")
    os.makedirs(save_dir, exist_ok=True)
    try:
        flat = _fake_flat(args.mb)
        nbytes = sum(v.nbytes for v in flat.values())
        log(f"synthetic checkpoint: {len(flat)} leaves, "
            f"{nbytes / (1 << 20):.1f} MB")

        # --- the async worker's write, then the lineage tail ------------
        path = os.path.join(save_dir, "1000.npz")
        t0 = time.perf_counter()
        retry_io(
            lambda: atomic_write(path, "wb", lambda f: np.savez(f, **flat)),
            desc=f"write checkpoint {path}",
        )
        save_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        lineage.write_sidecar(path)
        ok = lineage.finalize_save(save_dir, path, 1000, healthy=True, keep=3)
        lineage_ms = 1e3 * (time.perf_counter() - t0)
        assert ok, "post-write verify failed on a freshly written file"
        log(f"npz write {save_ms:.1f} ms, lineage tail {lineage_ms:.1f} ms "
            f"(sha256 + verify + retention)")

        t0 = time.perf_counter()
        restorable = lineage.last_good_checkpoint(save_dir)
        walk_ms = 1e3 * (time.perf_counter() - t0)
        assert restorable and restorable.endswith("1000.npz")

        # --- hot-path hooks: what EVERY step pays -----------------------
        sentinel = AnomalySentinel("warn", spike_factor=10.0)
        metrics = {"loss": 2.0, "accuracy": 0.5}
        plan = FaultPlan.from_env()
        assert plan.inert, "SAT_FI_* leaked into the bench environment"

        t0 = time.perf_counter()
        for step in range(args.iters):
            sentinel.check(step, metrics)
        sentinel_us = 1e6 * (time.perf_counter() - t0) / args.iters

        t0 = time.perf_counter()
        for step in range(args.iters):
            plan.maybe_kill(step)
            consume_io_fault("hot-path probe")
        hooks_us = 1e6 * (time.perf_counter() - t0) / args.iters

        per_step_ms = (sentinel_us + hooks_us) / 1e3
        overhead_pct = 100.0 * per_step_ms / args.step_ms
        log(f"sentinel check {sentinel_us:.2f} us, inert hooks "
            f"{hooks_us:.2f} us -> {overhead_pct:.4f}% of a "
            f"{args.step_ms:.0f} ms step")

        # the lineage tail runs on the writer thread; amortize it over a
        # save_period of 1000 steps to show the honest worst case where
        # the host core is shared (single-core hosts DO pay it)
        lineage_amortized_pct = 100.0 * (lineage_ms / 1000.0) / args.step_ms

        result = {
            "metric": "resilience_hot_path_overhead",
            "value": round(overhead_pct, 4),
            "unit": "%_of_step",
            "vs_baseline": 2.0,  # the acceptance bar: < 2%
            "sentinel_us_per_step": round(sentinel_us, 3),
            "inert_hooks_us_per_step": round(hooks_us, 3),
            "step_ms_assumed": args.step_ms,
            "ckpt_mb": round(nbytes / (1 << 20), 1),
            "npz_write_ms": round(save_ms, 1),
            "lineage_tail_ms": round(lineage_ms, 1),
            "lineage_amortized_pct_at_save_period_1000":
                round(lineage_amortized_pct, 4),
            "last_good_walk_ms": round(walk_ms, 2),
        }
        from ..telemetry import bench_stamp

        result.update(device_kind="host-only", **bench_stamp())
        print(json.dumps(result), flush=True)
        return 0 if overhead_pct < 2.0 else 1
    finally:
        if made_workdir:
            shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
