"""Bulk offline captioning benchmark: steady throughput + resume cost —
the port of ``scripts/bench_bulk.py``, with its flags, rows and exit
codes.

Times the real ``--phase bulk`` CLI end to end against a procedurally
generated corpus and a blessed seed-0 checkpoint of the flagship model
(``Config``'s widths; ``--extra-set`` changes them):

* ``bulk_throughput_captions_s`` — steady-state captions/second of the
  decode loop, read from the run's final heartbeat (the gauge clock
  starts after the slot pool's warm-up, so the kernel build and cuDNN's
  set-up are excluded);
* ``bulk_resume_overhead_s`` — wall seconds of a relaunch over a fully
  completed output dir: corpus walk + manifest load + per-shard crc
  verification.  This is the fixed tax every ``--supervise`` restart
  pays before new work starts.

The decode run goes through ``tools.cli_ranks`` (``cli.main`` on the same
arguments, in one process), which tallies its kernel launches: the bulk
path decodes through B2, the row-masked fused attention kernel, and the
rows carry the count.

The run is rejected (exit 1) on a steady-state recompile, as the JAX
script rejects one.  The port compiles only its kernel, so that is a
kernel build in the decode run: this process builds the kernel first
(``ops.build``, named by its source's hash), and the run must then build
none (its heartbeat's ``compile_count``, the ``kernel/builds`` counter).
The port has no ``bulk/steady_compiles`` gauge (``bulk/runner.py``).

Prints BENCH-contract JSON rows on stdout ({"metric", "value", "unit",
"vs_baseline", ...}; schema via ``telemetry.bench_stamp``) so
``tools/check_regression.py`` gates the trajectory.

Usage: python -m sat_tpu_torch.tools.bench_bulk [--images 24]
       [--shard-rows 6] [--workdir DIR] [--timeout 420]
       (the card, or the CPU with SAT_TORCH_DEVICE=cpu)
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

from .benchlib import child_env, device_kind, make_log, parent_device, parse_sets, repo_root

log = make_log("bench_bulk")


def _make_corpus(corpus_dir: str, n: int, size: int) -> None:
    """n procedural JPEGs — deterministic, no dataset download."""
    import cv2
    import numpy as np

    os.makedirs(corpus_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        img = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
        cv2.imwrite(os.path.join(corpus_dir, f"corpus_{i:05d}.jpg"), img)


def _bless_checkpoint(config) -> None:
    """Seed-0 initial weights saved and marked LAST_GOOD (no train steps;
    drawn on the host, the run loads them onto its device)."""
    import torch

    from ..resilience import lineage
    from ..train.checkpoint import save_checkpoint
    from ..train.step import create_train_state

    os.makedirs(config.save_dir, exist_ok=True)
    state = create_train_state(config, torch.Generator().manual_seed(0), "cpu")
    save_checkpoint(state, config)
    lineage.mark_last_good(config.save_dir, int(state.step))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sat_tpu_torch.tools.bench_bulk",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--images", type=int, default=24)
    ap.add_argument("--shard-rows", type=int, default=6)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--timeout", type=int, default=420,
                    help="per-child-run timeout, seconds")
    ap.add_argument("--extra-set", action="append", default=[], metavar="KEY=VALUE",
                    help="Config overrides over the flagship model (the port's addition)")
    args = ap.parse_args(argv)
    dev = parent_device()
    kind = device_kind(dev)

    from .. import telemetry
    from ..config import Config
    from ..data.vocabulary import Vocabulary

    if dev.type == "cuda":
        from ..ops import build

        build.build_all()  # the run below must find it built and build none
    workdir = args.workdir or tempfile.mkdtemp(prefix="bench_bulk_")
    made_workdir = args.workdir is None
    env = child_env()
    try:
        vocab_file = os.path.join(workdir, "vocabulary.csv")
        vocabulary = Vocabulary(size=30)
        vocabulary.build(["a man riding a horse.", "a cat on a table."])
        vocabulary.save(vocab_file)
        corpus = os.path.join(workdir, "corpus")
        out_dir = os.path.join(workdir, "out")
        config = Config(
            phase="bulk", vocabulary_size=vocabulary.size,
            vocabulary_file=vocab_file, beam_size=2,
            serve_slot_pages=2, serve_page_width=2,
            telemetry=True, heartbeat_interval=0.1,
            shard_cache="off",
            save_dir=os.path.join(workdir, "models"),
            summary_dir=os.path.join(workdir, "summary"),
            bulk_input=corpus, bulk_output=out_dir,
            bulk_shard_rows=args.shard_rows,
        )
        config = parse_sets(config, args.extra_set)
        _make_corpus(corpus, args.images, config.image_size)
        cfg_path = os.path.join(workdir, "bulk.json")
        config.save(cfg_path)

        log("blessing a seed-0 checkpoint (init-only, no train steps)")
        _bless_checkpoint(config)

        log(f"decode run: {args.images} images, shards of {args.shard_rows} on {kind}")
        tally_dir = os.path.join(workdir, "tally")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "sat_tpu_torch.tools.cli_ranks", tally_dir,
             json.dumps([["--config", cfg_path]])],
            capture_output=True, text=True, cwd=repo_root(), env=env, timeout=args.timeout,
        )
        decode_wall_s = time.perf_counter() - t0
        if proc.returncode != 0 or "bulk: complete" not in proc.stderr:
            log(f"bulk run failed rc {proc.returncode}:\n{proc.stderr}")
            return 1
        with open(os.path.join(tally_dir, "tally_rank0.json")) as f:
            tally = json.load(f)[0]
        hb_path = os.path.join(config.summary_dir, "telemetry", "heartbeat.json")
        with open(hb_path) as f:
            heartbeat = json.load(f)
        bulk = heartbeat.get("bulk", {})
        throughput = bulk.get("captions_per_s", 0.0)
        builds = heartbeat.get("compile_count")
        log(f"decode: {throughput:.1f} captions/s steady ({decode_wall_s:.1f}s wall incl. boot), "
            f"{builds} kernel builds in the run, B2 launches {tally['masked_launches']}, "
            f"B1 {tally['launches']}")
        if builds != 0:
            log(f"REJECTED: {builds} kernel builds in the decode run (the kernel was built "
                "before it: a steady-state rebuild)")
            return 1
        if bulk.get("images_done") != args.images:
            log(f"REJECTED: {bulk.get('images_done')} of {args.images} images captioned")
            return 1

        log("resume run over the completed output dir")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "sat_tpu_torch.cli", "--config", cfg_path],
            capture_output=True, text=True, cwd=repo_root(), env=env, timeout=args.timeout,
        )
        resume_s = time.perf_counter() - t0
        if proc.returncode != 0 or "nothing to do" not in proc.stderr:
            log(f"resume run failed rc {proc.returncode}:\n{proc.stderr}")
            return 1
        log(f"resume: {resume_s:.2f}s (verified + skipped every shard)")

        common = {"device_kind": kind, "fused_attend_launches": tally["launches"],
                  "fused_attend_masked_launches": tally["masked_launches"]}
        rows = [
            {
                "metric": "bulk_throughput_captions_s",
                "value": round(throughput, 3),
                "unit": "captions/s",
                "vs_baseline": 1.0,
                "images": args.images,
                "shard_rows": args.shard_rows,
                "decode_wall_s": round(decode_wall_s, 2),
                "kernel_builds": builds,
                **common,
                **telemetry.bench_stamp(),
            },
            {
                "metric": "bulk_resume_overhead_s",
                "value": round(resume_s, 3),
                "unit": "s",
                "vs_baseline": 1.0,
                "shards_verified": (args.images + args.shard_rows - 1) // args.shard_rows,
                "device_kind": kind,
                **telemetry.bench_stamp(),
            },
        ]
        print(json.dumps(rows, indent=1), flush=True)
        return 0
    finally:
        if made_workdir:
            shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
