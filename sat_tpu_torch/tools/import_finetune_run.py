"""Import-then-finetune: the reference-checkpoint migration path, end to
end.

The port of ``scripts/import_finetune_run.py``.  Trains a donor (phase
A) on the fixture corpus, exports its state into the reference's flat
TF1 ``{var.name: value}`` npy layout (``export_reference_checkpoint``),
imports that file into a freshly initialized model
(``import_reference_checkpoint``) and finetunes it (phase B), beside a
from-scratch control trained for the same phase-B budget (phase C).  It
shows that

* the imported model's starting loss is phase A's final loss (the
  weights survived the round trip through the foreign layout: a silent
  gate-order or orientation mismatch would send it back to scratch), and
* finetuning continues down from there and beats the control.

Writes ``summary.json`` (the five losses and four checks) and
``summary.md`` under ``--out``; exit 0 when every check passes, else 1.

Usage: python -m sat_tpu_torch.tools.import_finetune_run [--cpu]
       [--steps-a N] [--steps-b N] [--out DIR] [--extra-set KEY=VALUE ...]
(the card unless --cpu or SAT_TORCH_DEVICE=cpu; ``--extra-set`` is the
port's addition, the overrides appended to every phase's config)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

import numpy as np

from .corpus import make_corpus, read_loss_curve


def mean_first_losses(metrics_path: str, n: int = 5):
    curve = read_loss_curve(metrics_path, samples=10**9)
    return float(np.mean([loss for _, loss in curve[:n]])), curve


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sat_tpu_torch.tools.import_finetune_run")
    ap.add_argument("--steps-a", type=int, default=300, help="phase-A steps")
    ap.add_argument("--steps-b", type=int, default=150, help="finetune steps")
    ap.add_argument("--num-images", type=int, default=48)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    ap.add_argument("--out", default="runs/import_finetune")
    ap.add_argument("--extra-set", action="append", default=[], metavar="KEY=VALUE",
                    help="Config overrides appended to every phase's config")
    args = ap.parse_args(argv)

    from ..device import resolve_device

    dev = resolve_device("cpu" if args.cpu else None)
    t0 = time.time()
    root = os.path.abspath(args.out)
    os.makedirs(root, exist_ok=True)
    img_dir, caption_file = make_corpus(root, num_images=args.num_images, image_edge=args.image_size)

    from .. import runtime
    from ..cli import build_config
    from ..train.checkpoint import export_reference_checkpoint, import_reference_checkpoint
    from .quality_run import card_facts, set_args

    steps_per_epoch = -(-2 * args.num_images // args.batch_size)

    def cfg(tag: str, steps: int):
        overrides = [
            f"train_image_dir={img_dir}",
            f"train_caption_file={caption_file}",
            f"vocabulary_file={root}/vocabulary.csv",
            f"temp_annotation_file={root}/anns.csv",
            f"temp_data_file={root}/data.npy",
            f"save_dir={root}/models_{tag}",
            f"summary_dir={root}/summary_{tag}",
            "max_train_ann_num=none",
            f"batch_size={args.batch_size}",
            f"num_epochs={-(-steps // steps_per_epoch)}",
            "vocabulary_size=200",
            "fc_drop_rate=0.1",
            "lstm_drop_rate=0.1",
            "initial_learning_rate=0.0003",
            "save_period=0",
            "log_every=5",
            f"image_size={args.image_size}",
        ] + args.extra_set
        config, _ = build_config(["--phase=train", "--train_cnn"] + set_args(overrides))
        return config

    facts = card_facts(dev)
    print(f"[import-ft +{time.time()-t0:5.1f}s] device: {facts['device']} ({dev})")

    # ---- phase A: train the donor model -------------------------------
    cfg_a = cfg("a", args.steps_a)
    state_a = runtime.train(cfg_a, device=dev)
    curve_a = read_loss_curve(f"{root}/summary_a/metrics.jsonl", samples=10**9)
    final_a = float(np.mean([loss for _, loss in curve_a[-3:]]))
    print(f"[import-ft +{time.time()-t0:5.1f}s] phase A done: "
          f"step {int(state_a.step)}, final loss ~{final_a:.3f}")

    # ---- export to the reference's flat layout ------------------------
    ref_path = f"{root}/reference_layout.npy"
    n_exported = export_reference_checkpoint(state_a, ref_path)
    print(f"[import-ft +{time.time()-t0:5.1f}s] exported {n_exported} tensors "
          f"in reference layout -> {ref_path}")

    # ---- import into a fresh model and finetune -----------------------
    cfg_b = cfg("b", args.steps_b)
    fresh = runtime.setup_train_state(cfg_b, seed=123, device=dev)
    imported, n_loaded = import_reference_checkpoint(fresh, ref_path)
    print(f"[import-ft +{time.time()-t0:5.1f}s] imported {n_loaded} tensors")

    runtime.train(cfg_b, state=imported, device=dev)
    first_b, curve_b = mean_first_losses(f"{root}/summary_b/metrics.jsonl")
    final_b = float(np.mean([loss for _, loss in curve_b[-3:]]))

    # ---- from-scratch control over the same phase-B budget ------------
    cfg_c = cfg("c", args.steps_b)
    runtime.train(cfg_c, device=dev)
    first_c, curve_c = mean_first_losses(f"{root}/summary_c/metrics.jsonl")
    final_c = float(np.mean([loss for _, loss in curve_c[-3:]]))

    verdicts = {
        # imported start ~ phase-A end: the weights survived the layout
        # round trip (gate order, kernel orientation, name translation)
        "import_resumes_phase_a": first_b < final_a + 0.5,
        # ...and is far below a cold start
        "import_beats_scratch_start": first_b < 0.6 * first_c,
        # finetuning continues down from the imported point
        "finetune_improves": final_b < first_b,
        "finetune_beats_scratch": final_b < final_c,
    }
    summary = {
        "device": facts["device"],
        "power_limit": facts["power_limit"],
        "steps_a": int(args.steps_a),
        "steps_b": int(args.steps_b),
        "tensors_exported": n_exported,
        "tensors_imported": n_loaded,
        "phase_a_final_loss": round(final_a, 4),
        "imported_start_loss": round(first_b, 4),
        "finetuned_final_loss": round(final_b, 4),
        "scratch_start_loss": round(first_c, 4),
        "scratch_final_loss": round(final_c, 4),
        "verdicts": verdicts,
        "total_seconds": round(time.time() - t0, 1),
    }
    with open(f"{root}/summary.json", "w") as f:
        json.dump(summary, f, indent=2)

    ok = all(verdicts.values())
    shown = argv if argv is not None else sys.argv[1:]
    section = "\n".join([
        "## Import-then-finetune: the reference-checkpoint migration path, end to end",
        "",
        f"Produced by `python -m sat_tpu_torch.tools.import_finetune_run {' '.join(shown)}`".rstrip()
        + f" on **{facts['device']}**.",
        "",
        "| Quantity | Loss |",
        "|---|---|",
        f"| phase-A donor, final | {final_a:.3f} |",
        f"| **imported** model, first steps | **{first_b:.3f}** |",
        f"| from-scratch control, first steps | {first_c:.3f} |",
        f"| imported + {args.steps_b} finetune steps | {final_b:.3f} |",
        f"| from-scratch control after {args.steps_b} steps | {final_c:.3f} |",
        "",
        f"{n_exported} tensors exported / {n_loaded} imported (decoder + CNN; optimizer slots "
        "dropped). Checks: "
        + ", ".join(f"{k}={'PASS' if v else 'FAIL'}" for k, v in verdicts.items())
        + f". Artifacts: `{args.out}/summary.json`.",
        "",
    ])
    with open(f"{root}/summary.md", "w") as f:
        f.write(section)
    print(f"[import-ft +{time.time()-t0:5.1f}s] summary written; all checks {'PASS' if ok else 'FAIL'}")
    for k, v in verdicts.items():
        print(f"  {k}: {'PASS' if v else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
