"""Input-pipeline A/B: live JPEG decode vs mmap shard-cache batch gather —
the port of ``scripts/bench_input.py``, with its flags and rows, over the
port's ``data`` package.

Per-step JPEG decode can bind a training host (a few ms of serial codec
work an image, against a device step of tens of ms).  This bench
quantifies the fix (``sat_tpu_torch/data/shards.py``): it materializes a
shard cache for a synthetic image set, then A/Bs per-batch feed time —

* ``sync`` window: batch assembly cost alone.  Live arm: thread-pool JPEG
  decode exactly as ``PrefetchLoader`` does it; shard arm: one mmap
  fancy-index gather per batch.
* ``overlap`` window: exposed host time per batch when a (simulated,
  ``--device-ms``) device step overlaps the prefetching loader — the
  number the train loop actually pays.

Prints BENCH-contract JSON lines on stdout ({"metric", "value", "unit",
"vs_baseline", ...extras}); the first line lands right after the sync A/B
and a fuller line re-emits the same schema with the overlap numbers, so a
driver reading either the first or the last JSON line gets a valid
metric.  ``value`` is the sync-feed speedup (live / shard, ×).  A pure
host-side measurement: it touches no device and imports no torch, and
its rows say so (``device_kind`` "host-only").

Usage: python -m sat_tpu_torch.tools.bench_input [--batch 64] [--images 128]
       [--image-size 224] [--src-size 480] [--epochs 3] [--device-ms 30]
       [--host-preprocess] [--workdir DIR] [--out FILE]
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

from .benchlib import make_log

log = make_log("bench_input")


def _write_jpegs(out_dir: str, n: int, src_size: int, seed: int = 0) -> list:
    """Synthetic photo-entropy JPEGs: smooth structure + noise, so the
    entropy decoder does realistic work at photo entropy)."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    h, w = (src_size * 3) // 4, src_size
    yy, xx = np.mgrid[0:h, 0:w]
    files = []
    for i in range(n):
        base = (
            96 + 80 * np.sin(xx / (17.0 + i % 7) + i)
            + 60 * np.cos(yy / (23.0 + i % 5))
        )
        img = np.clip(
            base[..., None] + rng.normal(0, 18, (h, w, 3)), 0, 255
        ).astype(np.uint8)
        f = os.path.join(out_dir, f"img_{i:05d}.jpg")
        cv2.imwrite(f, img, [int(cv2.IMWRITE_JPEG_QUALITY), 90])
        files.append(f)
    return files


def _batches(files: list, B: int, n_batches: int) -> list:
    """Deterministic batch file-lists cycling the image set."""
    out = []
    for b in range(n_batches):
        out.append([files[(b * B + i) % len(files)] for i in range(B)])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sat_tpu_torch.tools.bench_input")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--images", type=int, default=128)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--src-size", type=int, default=480,
                    help="source JPEG width (height = 3/4 width)")
    ap.add_argument("--sync-batches", type=int, default=5,
                    help="timed batches per arm in the sync window")
    ap.add_argument("--epochs", type=int, default=3,
                    help="dataset epochs per arm in the overlap window")
    ap.add_argument("--device-ms", type=float, default=30.0,
                    help="simulated device step per batch (~30 ms)")
    ap.add_argument("--host-preprocess", action="store_true",
                    help="A/B the raw=False path (float32 mean-sub on host, "
                         "config.device_preprocess=false) instead of the "
                         "default uint8 raw feed")
    ap.add_argument("--workdir", default=None,
                    help="keep images + shards here (default: fresh tmp dir, "
                         "removed on exit)")
    ap.add_argument("--out", default=None, help="also write the final JSON here")
    args = ap.parse_args(argv)

    from ..data.dataset import DataSet
    from ..data.images import ILSVRC_2012_MEAN, ImageLoader, PrefetchLoader
    from ..data.shards import build_shard_cache

    workdir = args.workdir or tempfile.mkdtemp(prefix="bench_input_")
    cleanup = args.workdir is None
    B, S = args.batch, args.image_size
    raw = not args.host_preprocess
    loader = ImageLoader(size=S, raw=raw)

    try:
        log(f"writing {args.images} synthetic JPEGs ({args.src_size}px) "
            f"under {workdir}")
        files = _write_jpegs(os.path.join(workdir, "images"), args.images,
                             args.src_size)

        # --- sync window: per-batch assembly cost, no overlap ------------
        batches = _batches(files, B, args.sync_batches + 1)
        from concurrent.futures import ThreadPoolExecutor

        log(f"live-decode sync baseline: {args.sync_batches} batches of {B}")
        live_ms = []
        with ThreadPoolExecutor(max_workers=8) as pool:
            for i, fs in enumerate(batches):
                t0 = time.perf_counter()
                np.stack(list(pool.map(loader.load_image, fs)))
                dt = 1e3 * (time.perf_counter() - t0)
                if i:  # first batch warms the page cache for both arms
                    live_ms.append(dt)
        live_med = float(np.median(live_ms))
        log(f"live decode: median {live_med:.1f} ms/batch")

        t0 = time.perf_counter()
        cache = build_shard_cache(
            files, os.path.join(workdir, "shards"), S, progress=False
        )
        build_s = time.perf_counter() - t0
        log(f"shard cache built in {build_s:.1f}s ({len(cache)} rows)")

        shard_ms = []
        for i, fs in enumerate(batches):
            t0 = time.perf_counter()
            g = cache.gather(fs)
            if not raw:
                g = g.astype(np.float32) - np.asarray(ILSVRC_2012_MEAN, np.float32)
            dt = 1e3 * (time.perf_counter() - t0)
            if i:
                shard_ms.append(dt)
        shard_med = float(np.median(shard_ms))
        log(f"shard gather: median {shard_med:.2f} ms/batch")

        speedup = live_med / shard_med if shard_med > 0 else float("inf")
        result = {
            "metric": "input_feed_speedup",
            "value": round(speedup, 2),
            "unit": "x",
            "vs_baseline": 1.0,  # no previously recorded number
            "live_ms_per_batch": round(live_med, 2),
            "shard_ms_per_batch": round(shard_med, 3),
            "batch_size": B,
            "image_size": S,
            "images": args.images,
            "raw_feed": raw,
            "build_s": round(build_s, 2),
            "window": "sync",
            "device_kind": "host-only",
        }
        from ..telemetry import bench_stamp

        result.update(bench_stamp())
        print(json.dumps(result), flush=True)  # first contract line, early

        # --- overlap window: exposed host wait behind a simulated step --
        ds = DataSet(list(range(len(files))), files, B)
        sleep_s = args.device_ms / 1e3

        def exposed(shard_cache):
            pl = PrefetchLoader(
                ds, ImageLoader(size=S, raw=raw),
                num_workers=8, prefetch_depth=2, shard_cache=shard_cache,
            )
            waits = []
            for _ in range(args.epochs):
                it = iter(pl)
                while True:
                    t0 = time.perf_counter()
                    batch = next(it, None)
                    if batch is None:
                        break
                    waits.append(1e3 * (time.perf_counter() - t0))
                    time.sleep(sleep_s)  # the "device step"
            return float(np.median(waits))

        log(f"overlap window: live arm ({args.epochs} epochs, "
            f"{args.device_ms:.0f}ms simulated step)")
        live_exp = exposed(None)
        log(f"overlap window: shard arm")
        shard_exp = exposed(cache)
        log(f"exposed host wait: live {live_exp:.1f} ms/batch, "
            f"shard {shard_exp:.2f} ms/batch")

        result.update(
            window="overlap",
            device_step_ms=args.device_ms,
            live_exposed_ms_per_batch=round(live_exp, 2),
            shard_exposed_ms_per_batch=round(shard_exp, 3),
            exposed_speedup=round(live_exp / shard_exp, 2)
            if shard_exp > 0 else float("inf"),
        )
        print(json.dumps(result), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(result, f, indent=2)
        return 0
    finally:
        if cleanup:
            shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
