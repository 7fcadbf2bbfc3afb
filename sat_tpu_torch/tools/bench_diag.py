"""Diag-tap overhead accounting: train-step cost with ``diag_level``
off/basic/full — the port of ``scripts/bench_diag.py``, with its flags,
row and exit code.

The model-health taps (``telemetry/device.py``) are claimed cheap enough
to leave on.  This bench puts a number on it: the measured wall-clock
delta between a ``diag_level=off`` and a ``diag_level=basic`` (and
``full``) train step on a small synthetic model, as percent of a
``--step-ms`` production step.  The acceptance bar is ``basic < 1%``.

The port computes the taps only on the steps that end a ``log_every``
interval (the steps whose metrics the loop fetches), so the three arms
run at ``log_every=1``: every timed step is a tapped one, the cost of a
log boundary's taps, which a run pays once every ``log_every`` steps.

Methodology: the three step variants are warmed up front, then timed in
INTERLEAVED rounds (off/basic/full, off/basic/full, ...) with a device
sync per timed block, taking the per-round minimum block time —
interleaving cancels drift that back-to-back arms would alias into the
delta.

Prints a BENCH-contract JSON row ({"metric","value","unit",
"vs_baseline",...}) stamped with ``telemetry.bench_stamp``, so
``tools/check_regression.py`` can gate it across sessions.

Usage: python -m sat_tpu_torch.tools.bench_diag [--batch 8] [--iters 30]
       [--rounds 5] [--step-ms 30]   (the card, or the CPU with
       SAT_TORCH_DEVICE=cpu)
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

from .benchlib import bench_device, device_kind, make_log, parse_sets

log = make_log("bench_diag")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sat_tpu_torch.tools.bench_diag")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=30, help="steps per timed block")
    ap.add_argument("--rounds", type=int, default=5, help="interleaved measurement rounds per arm")
    ap.add_argument("--step-ms", type=float, default=30.0,
                    help="production device step the overhead is scored against (~30 ms)")
    ap.add_argument("--extra-set", action="append", default=[], metavar="KEY=VALUE",
                    help="Config overrides over the small model (the port's addition, e.g. "
                    "the flagship widths)")
    args = ap.parse_args(argv)
    dev = bench_device()

    import numpy as np
    import torch

    from .. import telemetry
    from ..config import Config
    from ..train.step import create_train_state, make_train_step, step_generator

    base = parse_sets(Config(
        phase="train", batch_size=args.batch, image_size=32, dim_embedding=16,
        num_lstm_units=16, dim_initialize_layer=16, dim_attend_layer=16,
        dim_decode_layer=32, vocabulary_size=200, compute_dtype="float32",
        log_every=1,
    ), args.extra_set)
    B, T, S = args.batch, base.max_caption_length, base.image_size
    batch = {
        "images": torch.from_numpy(
            np.random.default_rng(0).integers(0, 255, (B, S, S, 3), np.uint8)).to(dev),
        "word_idxs": torch.from_numpy(
            np.random.default_rng(1).integers(0, base.vocabulary_size, (B, T)).astype(np.int64)).to(dev),
        "masks": torch.ones((B, T), dtype=torch.float32, device=dev),
    }

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    arms = {}
    for level in ("off", "basic", "full"):
        config = base.replace(diag_level=level)
        step_fn = make_train_step(config)
        state = create_train_state(config, torch.Generator().manual_seed(0), dev)
        # steady state: a couple of steps outside the timer
        for i in range(3):
            state, metrics = step_fn(state, batch, step_generator(config.seed, i, dev))
        sync()
        arms[level] = (step_fn, state)
        log(f"{level}: warmed, {len(metrics)} metric outputs")

    times = {level: [] for level in arms}
    for _ in range(args.rounds):
        for level, (step_fn, state) in arms.items():
            t0 = time.perf_counter()
            for i in range(args.iters):
                state, metrics = step_fn(state, batch, step_generator(base.seed, i, dev))
            sync()
            times[level].append((time.perf_counter() - t0) / args.iters)
            arms[level] = (step_fn, state)
    ms = {level: 1e3 * min(samples) for level, samples in times.items()}
    log(f"per-step: off {ms['off']:.4f} ms, basic {ms['basic']:.4f} ms, full {ms['full']:.4f} ms")

    # the gated quantity: what basic taps add to a production step budget
    basic_delta_ms = max(0.0, ms["basic"] - ms["off"])
    full_delta_ms = max(0.0, ms["full"] - ms["off"])
    overhead_pct = 100.0 * basic_delta_ms / args.step_ms
    log(f"basic taps: +{basic_delta_ms:.4f} ms/step = {overhead_pct:.4f}% of a "
        f"{args.step_ms:.0f} ms step (bar: 1%)")

    print(json.dumps({
        "metric": "diag_tap_overhead",
        "value": round(overhead_pct, 4),
        "unit": "%_of_step",
        "vs_baseline": 1.0,  # the acceptance bar: < 1%
        "off_ms_per_step": round(ms["off"], 4),
        "basic_ms_per_step": round(ms["basic"], 4),
        "full_ms_per_step": round(ms["full"], 4),
        "basic_delta_ms": round(basic_delta_ms, 4),
        "full_delta_ms": round(full_delta_ms, 4),
        "step_ms_assumed": args.step_ms,
        "iters": args.iters,
        "rounds": args.rounds,
        "batch_size": args.batch,
        "log_every": 1,
        "device_kind": device_kind(dev),
        **telemetry.bench_stamp(),
    }), flush=True)
    return 0 if overhead_pct < 1.0 else 1


if __name__ == "__main__":
    sys.exit(main())
