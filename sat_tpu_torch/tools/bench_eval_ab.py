"""Controlled A/B of eval-decode throughput: a fresh process against one
that ran the train program first — the port of
``scripts/bench_eval_ab.py``, with its flags, rows and exit codes.

Varies ONE factor, with everything else held identical:

* arm "fresh":    a new process measures decode only;
* arm "resident": the SAME process first builds and runs the training
  program for ``--steps`` steps, keeps its train state alive (and
  reports ``torch.cuda.memory_allocated()`` then), and measures decode
  with byte-identical measurement code (``utils.benchmarking``).

Each arm runs in its own subprocess, repeated ``--repeats`` times,
interleaved (fresh, resident, fresh, ...) so slow drift of the card's
state cannot masquerade as an arm effect.  Within a run, decode time is
measured over ``--windows`` consecutive windows of ``--iters`` batches,
so warm-up drift inside a process shows apart from the resident-program
effect.  The parent writes one summary JSON line: the per-arm mean
images/sec of the LAST window, the resident/fresh ratio, and the raw
per-run rows.

Usage:
  python -m sat_tpu_torch.tools.bench_eval_ab [--repeats 3] [--batch 32]
      [--beam 3] [--iters 10] [--windows 3] [--out FILE]
  (--cpu --image-size 64 --steps 2 for a smoke run on the CPU)
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import List, Optional

from .benchlib import bench_device, child_env, device_kind, parent_device, parse_sets, repo_root


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m sat_tpu_torch.tools.bench_eval_ab")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--beam", type=int, default=3)
    ap.add_argument("--iters", type=int, default=10, help="batches per window")
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--steps", type=int, default=10, help="train steps the resident arm runs first")
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default=None, help="summary JSON path (parent)")
    ap.add_argument("--arm", choices=["fresh", "resident"], default=None,
                    help="internal: run one measurement in this process")
    ap.add_argument("--budget-s", type=float, default=420.0, help="parent per-subprocess timeout")
    ap.add_argument("--extra-set", action="append", default=[], metavar="KEY=VALUE",
                    help="Config overrides over the defaults (the port's addition)")
    return ap


def run_arm(args) -> int:
    """One measurement process; prints a single JSON row on stdout."""
    dev = bench_device(args.cpu)

    import numpy as np
    import torch

    from .. import telemetry
    from ..config import Config
    from ..models.captioner import init_variables
    from ..ops import fused_attend as fa
    from ..train.checkpoint import compute_params
    from ..utils.benchmarking import make_chained_decode, time_decode_windows

    config = parse_sets(Config(batch_size=args.batch, beam_size=args.beam, image_size=args.image_size),
                        args.extra_set)
    B = args.batch
    rng = np.random.default_rng(0)
    host_images = rng.normal(size=(B, args.image_size, args.image_size, 3)).astype(np.float32)

    resident_state = None
    resident_bytes = None
    if args.arm == "resident":
        # the train program run in this process, its state left alive on
        # the device
        from ..train.step import create_train_state, make_train_step, step_generator

        state = create_train_state(config, torch.Generator().manual_seed(0), dev)
        train_step = make_train_step(config)
        t_batch = {
            "images": torch.from_numpy(host_images).to(dev),
            "word_idxs": torch.from_numpy(
                rng.integers(0, config.vocabulary_size, (B, config.max_caption_length)).astype(np.int64)
            ).to(dev),
            "masks": torch.ones((B, config.max_caption_length), dtype=torch.float32, device=dev),
        }
        for i in range(args.steps):
            state, _ = train_step(state, t_batch, step_generator(1, i, dev))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            resident_bytes = torch.cuda.memory_allocated(dev)
        resident_state = state  # keep it alive through the decode windows

    params, batch_stats = init_variables(config, torch.Generator().manual_seed(0), dev)
    variables = compute_params(params, config, batch_stats)
    images = torch.from_numpy(host_images).to(dev)

    decode = make_chained_decode(config, eos=1, beam_size=args.beam)
    launches0 = fa.fused_attend.launches
    compile_s, windows_ms, _ = time_decode_windows(decode, variables, images, args.iters, args.windows)
    row = {
        "arm": args.arm,
        "batch": B,
        "beam": args.beam,
        "windows_batch_ms": [round(ms, 2) for ms in windows_ms],
        "images_per_sec_last_window": round(1e3 * B / windows_ms[-1], 2),
        "compile_s": round(compile_s, 1),
        "memory_allocated_after_train_bytes": resident_bytes,
        "fused_attend_launches": fa.fused_attend.launches - launches0,
        "device_kind": device_kind(dev),
    }
    row.update(telemetry.bench_stamp())
    del resident_state
    print(json.dumps(row), flush=True)
    return 0


def _emit_error(row: dict) -> None:
    # both streams: a wrapper that keeps only one still sees the reason
    print(json.dumps(row), flush=True)
    print(json.dumps(row), file=sys.stderr, flush=True)


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.arm:
        return run_arm(args)
    dev = parent_device(args.cpu)  # refuse here, before any child starts

    child_flags = [
        "--batch", str(args.batch), "--beam", str(args.beam),
        "--iters", str(args.iters), "--windows", str(args.windows),
        "--steps", str(args.steps), "--image-size", str(args.image_size),
    ] + (["--cpu"] if args.cpu else []) + [x for s in args.extra_set for x in ("--extra-set", s)]

    rows = []
    # interleaved arms: drift of the card's state over the session
    # averages out of the arm comparison instead of into it
    order = []
    for r in range(args.repeats):
        order += [("fresh", r), ("resident", r)]
    for arm, rep in order:
        try:
            proc = subprocess.run(
                [sys.executable, "-m", "sat_tpu_torch.tools.bench_eval_ab", "--arm", arm] + child_flags,
                capture_output=True, text=True, timeout=args.budget_s, cwd=repo_root(), env=child_env(),
            )
        except subprocess.TimeoutExpired as e:
            # a wedged child must produce the same structured error row as
            # a nonzero exit, not an uncaught traceback
            _emit_error({
                "error": "arm_timeout", "arm": arm, "repeat": rep, "budget_s": args.budget_s,
                "stderr": ((e.stderr or "")[-500:] if isinstance(e.stderr, str) else ""),
            })
            return 3
        if proc.returncode != 0:
            _emit_error({"error": "arm_failed", "arm": arm, "repeat": rep,
                         "rc": proc.returncode, "stderr": proc.stderr[-500:]})
            return 3
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        row["repeat"] = rep
        rows.append(row)
        print(json.dumps(row), file=sys.stderr, flush=True)

    def arm_mean(arm):
        v = [r["images_per_sec_last_window"] for r in rows if r["arm"] == arm]
        return sum(v) / len(v)

    from .. import telemetry

    fresh, resident = arm_mean("fresh"), arm_mean("resident")
    resident_bytes = [r["memory_allocated_after_train_bytes"] for r in rows if r["arm"] == "resident"]
    summary = {
        "metric": "eval_images_per_sec",
        "value": round(fresh, 2),          # the clean-process number
        "unit": f"images/sec @ beam={args.beam}",
        "vs_baseline": None,
        "protocol": (
            f"B={args.batch}, {args.windows} windows x {args.iters} "
            f"batches, last window, {args.repeats} interleaved repeats "
            "per arm, fresh subprocess each"
        ),
        "fresh_mean": round(fresh, 2),
        "resident_mean": round(resident, 2),
        "resident_over_fresh": round(resident / fresh, 4),
        "resident_memory_allocated_bytes": resident_bytes,
        "fused_attend_launches": sum(r["fused_attend_launches"] for r in rows),
        "device_kind": device_kind(dev),
        "rows": rows,
    }
    summary.update(telemetry.bench_stamp())
    line = json.dumps(summary)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
