"""Trained-model early-exit A/B — the port of
``scripts/bench_early_exit.sh``, in Python, with its knobs and output.

The beam search's exact early exit (``ops/beam_search.run_search``) only
pays off when the model actually terminates captions, which a random
init never does — so train a quick flagship-shape model on the
self-contained corpus (``tools.quality_run --corpus-only``, then ``python
-m sat_tpu_torch.cli --phase train``), then run ``tools.bench_eval`` on
its checkpoint with and without the exit.  Artifact = two JSON lines on
stdout (``early_exit`` true, then false), each ``eval_images_per_sec``.

Usage: python -m sat_tpu_torch.tools.bench_early_exit [outdir]
Env knobs (CPU smoke: EE_CPU=1 EE_IMAGE_SIZE=64 EE_STEPS=30 EE_BATCH=4):
  EE_IMAGE_SIZE (default 224), EE_STEPS (400), EE_BATCH (bench batch,
  32), EE_CPU=1 (the CPU everywhere; default: the card), and the port's
  EE_SETS (space-separated KEY=VALUE Config overrides for the training
  run and the bench, e.g. the tests' small widths).
The corpus and checkpoint are cached under ``outdir/ee_run_<size>px_
<steps>s_<backend>[_<sets hash>]``, keyed on every knob that shapes them.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
from typing import List, Optional

from .benchlib import child_env, parent_device, repo_root


def _run(cmd: List[str], log_path: str, timeout: int, env, echo: bool = False) -> int:
    """One step's command, its stderr (and its stdout, unless ``echo``
    prints that here) appended to ``log_path``; the return code (124 on
    its timeout)."""
    with open(log_path, "a") as log:
        try:
            proc = subprocess.run(cmd, stdout=subprocess.PIPE if echo else log, stderr=log, text=True,
                                  cwd=repo_root(), env=env, timeout=timeout)
        except subprocess.TimeoutExpired:
            return 124
    if echo:
        print(proc.stdout, end="", flush=True)
    return proc.returncode


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out = os.path.abspath(argv[0] if argv else os.path.join(repo_root(), "runs", "bench_early_exit"))
    img = os.environ.get("EE_IMAGE_SIZE", "224")
    steps = os.environ.get("EE_STEPS", "400")
    batch = os.environ.get("EE_BATCH", "32")
    cpu = os.environ.get("EE_CPU", "0") == "1"
    sets = os.environ.get("EE_SETS", "").split()
    parent_device(cpu)  # the card, or the CPU when asked; refuse before any work
    # the cache dir is keyed on EVERY knob that shapes corpus + checkpoint,
    # the backend included, so a CPU smoke run can't pass for the card's
    backend = "cpu" if cpu else "dev"
    tag = f"_{hashlib.sha256(' '.join(sets).encode()).hexdigest()[:8]}" if sets else ""
    run_dir = os.path.join(out, f"ee_run_{img}px_{steps}s_{backend}{tag}")
    os.makedirs(out, exist_ok=True)
    env = child_env(**({"SAT_TORCH_DEVICE": "cpu"} if cpu else {}))
    py = sys.executable

    if not os.path.exists(os.path.join(run_dir, "captions.json")):
        rc = _run([py, "-m", "sat_tpu_torch.tools.quality_run", "--corpus-only", "--image-size", img,
                   "--out", run_dir], os.path.join(out, "ee_corpus.log"), 300, env)
        if rc:
            print("corpus gen failed", file=sys.stderr)
            return 1

    models = os.path.join(run_dir, "models")
    if not (os.path.isdir(models) and any(f.endswith(".npz") for f in os.listdir(models))):
        overrides = [
            f"train_image_dir={run_dir}/images",
            f"train_caption_file={run_dir}/captions.json",
            f"vocabulary_file={run_dir}/vocabulary_basic.csv",
            f"temp_annotation_file={run_dir}/anns_basic.csv",
            f"temp_data_file={run_dir}/data_basic.npy",
            f"save_dir={models}",
            f"summary_dir={run_dir}/summary",
            f"image_size={img}",
            "max_train_ann_num=none", "batch_size=16", "num_epochs=200",
            f"max_steps={steps}", "save_period=0", "initial_learning_rate=3e-4",
            *sets,
        ]
        rc = _run([py, "-m", "sat_tpu_torch.cli", "--phase=train", *[x for o in overrides for x in ("--set", o)]],
                  os.path.join(out, "ee_train.log"), 700, env)
        if rc:
            print("train failed", file=sys.stderr)
            return 1

    ckpt = max((os.path.join(models, f) for f in os.listdir(models) if f.endswith(".npz")),
               key=os.path.getmtime)
    extra = [x for s in sets for x in ("--extra-set", s)]
    for arm in ([], ["--no-early-exit"]):
        cmd = [py, "-m", "sat_tpu_torch.tools.bench_eval", "--batch", batch, "--iters", "10",
               "--image-size", img, *(["--cpu"] if cpu else []),
               "--params", ckpt, "--vocab", os.path.join(run_dir, "vocabulary_basic.csv"), *extra, *arm]
        # the bench's JSON rows go to this process's stdout, its log to the file
        if _run(cmd, os.path.join(out, "ee_bench.log"), 400, env, echo=True):
            print("bench arm failed", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
