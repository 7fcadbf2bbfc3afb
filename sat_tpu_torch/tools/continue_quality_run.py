"""Continue a finished quality run from its final checkpoint.

The port of ``scripts/continue_quality_run.py``.  The protocol saves one
checkpoint at the end of training; this tool restores it, extends
``num_epochs`` by ``--extra-epochs``, trains the additional steps,
re-evaluates (beam 3, and greedy with ``--beam-compare``) and rewrites
``scores.json``, keeping its provenance fields.  The continued run is the
uninterrupted one: the batch order and the dropout masks are functions of
the seed and the step, so a run continued at an epoch boundary is bitwise
a run that never stopped.

Usage:
  python -m sat_tpu_torch.tools.continue_quality_run --out runs/quality_rich \
      --corpus rich [--extra-epochs 39] [--beam-compare] [--cpu] [...]
Flags mirror the original quality_run invocation where relevant; the
config is rebuilt the same way, only num_epochs grows.  It runs on the
card unless ``--cpu`` or ``SAT_TORCH_DEVICE=cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sat_tpu_torch.tools.continue_quality_run")
    ap.add_argument("--out", required=True)
    ap.add_argument("--corpus", default="rich", choices=["basic", "rich"])
    ap.add_argument("--extra-epochs", type=int, default=39)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--frozen-cnn", action="store_true")
    ap.add_argument("--beam-compare", action="store_true")
    ap.add_argument("--cnn", default="vgg16")
    ap.add_argument("--extra-set", action="append", default=[])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)

    t0 = time.time()

    def log(msg: str) -> None:
        print(f"[cont +{time.time()-t0:6.1f}s] {msg}", flush=True)

    from ..device import resolve_device

    dev = resolve_device("cpu" if args.cpu else None)

    from .. import runtime
    from ..cli import build_config
    from ..data.dataset import prepare_train_data
    from ..train.checkpoint import latest_checkpoint
    from .quality_run import protocol_overrides, serving_state, set_args

    root = os.path.abspath(args.out)
    if not os.path.isdir(os.path.join(root, "images")):
        raise SystemExit(f"no corpus at {root}: run quality_run first")
    overrides = protocol_overrides(root, args.corpus, args.batch_size, args.image_size, args.cnn)
    sets = set_args(overrides + args.extra_set)
    train_flags = [] if args.frozen_cnn else ["--train_cnn"]

    ckpt = latest_checkpoint(os.path.join(root, "models"))
    if not ckpt:
        raise SystemExit(f"no checkpoint under {root}/models")
    log(f"restoring {ckpt}")

    config, _ = build_config(["--phase=train"] + train_flags + sets)
    state = runtime.setup_train_state(config, model_file=ckpt, device=dev)
    start_step = int(state.step)

    # steps an epoch from the cached dataset size; num_epochs extended so
    # the loop runs --extra-epochs past wherever the checkpoint stopped
    dataset = prepare_train_data(config)
    steps_per_epoch = dataset.num_batches
    done_epochs = start_step // steps_per_epoch
    config = config.replace(num_epochs=done_epochs + args.extra_epochs)
    log(f"continuing from step {start_step} (epoch {done_epochs}) for "
        f"{args.extra_epochs} more epochs x {steps_per_epoch} steps")

    state = runtime.train(config, state=state, dataset=dataset, device=dev)
    log(f"training done at step {int(state.step)}")

    served = serving_state(state)
    eval_config, _ = build_config(["--phase=eval", "--beam_size=3"] + sets)
    scores = runtime.evaluate(eval_config, state=served, device=dev)
    log(f"beam=3 scores: { {k: round(v, 4) for k, v in scores.items()} }")

    greedy_scores = None
    if args.beam_compare:
        greedy_config, _ = build_config(["--phase=eval", "--beam_size=1"] + sets)
        greedy_config = greedy_config.replace(eval_result_file=f"{root}/results_greedy.json")
        greedy_scores = runtime.evaluate(greedy_config, state=served, device=dev)
        log(f"greedy scores: { {k: round(v, 4) for k, v in greedy_scores.items()} }")

    # merged into the original run's payload: its provenance fields
    # (corpus, protocol, train_cnn, vocab_words, length histogram, device)
    # survive the continuation
    scores_path = os.path.join(root, "scores.json")
    payload = {}
    try:
        with open(scores_path) as f:
            payload = json.load(f)
    except (OSError, json.JSONDecodeError):
        pass
    payload.update(
        scores=scores,
        greedy_scores=greedy_scores,
        steps=int(state.step),
        continued_from_step=start_step,
        continuation_seconds=round(time.time() - t0, 1),
    )
    with open(scores_path, "w") as f:
        json.dump(payload, f, indent=2)
    print(json.dumps(payload))
    return 0


if __name__ == "__main__":
    sys.exit(main())
