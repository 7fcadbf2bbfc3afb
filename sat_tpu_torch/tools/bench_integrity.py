"""Integrity cost accounting: shard-gather overhead of --verify_shards —
the port of ``scripts/bench_integrity.py`` over the port's
``data.shards`` and ``data.integrity``.

The default sampling verifier (``--verify_shards sample``) is claimed
cheap enough to leave on for every run: one crc32c of one row every
``integrity.SAMPLE_EVERY`` gathers, batched through the same
table-driven/vectorized crc the summary writer uses.  This bench puts a
number on that claim on the host alone (no device, no torch, rows with
``device_kind`` "host-only"; and without cv2 —
the shard cache is built through a deterministic stub loader), by timing
the real ``ShardCache.gather`` path:

* ``off``:    gather with no integrity armed — the baseline fancy-index
  copy every cached step pays.
* ``sample``: the same gathers with the rotating-row sampler armed.

Prints one BENCH-contract JSON line on stdout ({"metric", "value",
"unit", "vs_baseline", ...extras}).  ``value`` is the *added* cost of
sample-mode verification in percent of a ``--step-ms`` device step
(1.0 is the acceptance bar: "≪ 1% of a 30 ms step").  ``full``
mode is measured and reported for context, never gated — it is an
explicitly opt-in audit mode.

Usage: python -m sat_tpu_torch.tools.bench_integrity [--step-ms 30] [--iters 2048]
       [--files 64] [--batch 8] [--size 64] [--workdir DIR]
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

from .. import telemetry
from ..data.shards import ShardCache, build_shard_cache
from .benchlib import make_log

log = make_log("bench_integrity")


class _StubLoader:
    """Deterministic image source keyed on basename — no cv2, no disk."""

    def __init__(self, size: int):
        self.size = size

    def load_raw(self, image_file: str) -> np.ndarray:
        seed = abs(hash(os.path.basename(image_file))) % (2 ** 32)
        rng = np.random.default_rng(seed)
        return rng.integers(
            0, 256, (self.size, self.size, 3), dtype=np.uint8
        )


def _time_gathers(cache: ShardCache, batches, iters: int) -> float:
    """Seconds per gather over ``iters`` gathers cycling ``batches``."""
    t0 = time.perf_counter()
    for i in range(iters):
        cache.gather(batches[i % len(batches)])
    return (time.perf_counter() - t0) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sat_tpu_torch.tools.bench_integrity",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--step-ms", type=float, default=30.0,
                    help="device step time the overhead is judged against")
    ap.add_argument("--iters", type=int, default=2048,
                    help="gathers per measurement (amortizes SAMPLE_EVERY)")
    ap.add_argument("--files", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=64,
                    help="image edge; 64 -> 12 KiB rows, the fixture scale")
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args(argv)

    workdir = args.workdir or tempfile.mkdtemp(prefix="bench_integrity_")
    made_workdir = args.workdir is None
    telemetry.disable()
    try:
        cache_dir = os.path.join(workdir, "cache")
        files = [
            os.path.join(workdir, f"img_{i:05d}.jpg")
            for i in range(args.files)
        ]
        build_shard_cache(
            files, cache_dir, args.size,
            rows_per_shard=16, loader=_StubLoader(args.size),
        )
        cache = ShardCache.open(cache_dir, args.size)
        batches = [
            files[i:i + args.batch]
            for i in range(0, args.files - args.batch + 1, args.batch)
        ]
        row_bytes = args.size * args.size * 3
        log(f"cache built: {args.files} files x {row_bytes} B rows, "
            f"batch {args.batch}, {args.iters} gathers per mode")

        results = {}
        for mode in ("off", "sample", "full"):
            cache.enable_integrity(mode)
            _time_gathers(cache, batches, 64)  # warm (page cache, sidecars)
            results[mode] = _time_gathers(cache, batches, args.iters)
            log(f"verify_shards={mode}: "
                f"{results[mode] * 1e6:.2f} us/gather")

        sample_us = (results["sample"] - results["off"]) * 1e6
        full_us = (results["full"] - results["off"]) * 1e6
        overhead_pct = 100.0 * max(0.0, sample_us / 1e3) / args.step_ms
        log(f"sample-mode added cost: {sample_us:.2f} us/gather "
            f"-> {overhead_pct:.4f}% of a {args.step_ms:.0f} ms step "
            f"(full mode, unbudgeted: {full_us:.2f} us/gather)")

        result = {
            "metric": "integrity_verify_overhead",
            "value": round(overhead_pct, 4),
            "unit": "%_of_step",
            "vs_baseline": 1.0,  # the acceptance bar: < 1%
            "gather_off_us": round(results["off"] * 1e6, 2),
            "gather_sample_us": round(results["sample"] * 1e6, 2),
            "gather_full_us": round(results["full"] * 1e6, 2),
            "sample_added_us": round(sample_us, 2),
            "full_added_us": round(full_us, 2),
            "row_bytes": row_bytes,
            "batch": args.batch,
            "step_ms_assumed": args.step_ms,
            "device_kind": "host-only",
            **telemetry.bench_stamp(),
        }
        print(json.dumps(result), flush=True)
        return 0 if overhead_pct < 1.0 else 1
    finally:
        if made_workdir:
            shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
