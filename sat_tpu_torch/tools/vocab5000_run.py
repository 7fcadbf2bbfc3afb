"""Full-width vocabulary exercise: train + decode at V=5000, with TP parity.

The port of ``scripts/vocab5000_run.py``.  The reference's published
configuration runs ``vocabulary_size=5000``, the width of the [5000, 512]
embedding and softmax that vocab tensor parallelism exists for.  This
tool

1. builds the rich corpus of :mod:`.corpus` large enough that the
   top-5000 vocabulary cap BINDS (3 unique words an image: 1700 images
   give more than 5000 distinct words),
2. builds the vocabulary, refusing anything but exactly 5000 words,
3. trains the flagship decoder at V=5000 in one process for a bounded
   number of steps on real corpus batches (``runtime.train``),
4. repeats the identical run (same seed, same batches) on a (2,4) mesh:
   the port's CLI in 8 ranks under ``python -m torch.distributed.run``
   (``tools.cli_ranks``), the embedding rows and the last decode layer's
   columns sharded 4 ways over ``model`` (5000 % 4 == 0), after counting
   the parameters the port's sharding rule shards over ``model``,
5. holds the per-record loss parity of the two trajectories (relative
   difference under 5e-2 at every logged record),
6. beam-decodes (beam=3) a capped eval subset at V=5000 through the full
   eval pipeline both ways: ``runtime.evaluate`` in this process, and the
   CLI's ``--phase eval`` in the same 8 ranks, whose results.json is
   scored here, and
7. writes ``result.json`` (the JAX script's keys, plus the card, each
   arm's median step and the kernel launches) and ``summary.md``.

On one card all eight ranks share ``cuda:0`` under gloo (the port's
backend rule).  The card unless ``--cpu`` or ``SAT_TORCH_DEVICE=cpu``;
without a card and without that request the tool raises.  Any failed
gate exits non-zero.

Usage: python -m sat_tpu_torch.tools.vocab5000_run [--out runs/vocab5000]
       [--steps 48] [--cpu]
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import subprocess
import sys
import time
from typing import List, Optional

import numpy as np

from .corpus import make_rich_corpus

MESH_SHAPE = (2, 4)


def _losses(summary_dir: str) -> np.ndarray:
    path = os.path.join(summary_dir, "metrics.jsonl")
    with open(path) as f:
        return np.array([json.loads(x)["total_loss"] for x in f])


def log_every(steps: int) -> int:
    """The JAX script's log cadence of 8, denser below 32 steps so a
    short run still logs several records for the parity gate and the
    median step (8 steps: every 2)."""
    return max(1, min(8, steps // 4))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sat_tpu_torch.tools.vocab5000_run")
    ap.add_argument("--out", default="runs/vocab5000")
    ap.add_argument("--num-images", type=int, default=1700,
                    help="3 unique words/image; 1700 → >5100 distinct "
                    "words, so the top-5000 cap binds")
    ap.add_argument("--steps", type=int, default=48,
                    help="bounded train steps per arm (the exercise is "
                    "width + parity, not convergence)")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--image-size", type=int, default=64,
                    help="small edge keeps the VGG16 forward cheap; "
                    "the vocab-width tensors are full-size regardless")
    ap.add_argument("--eval-anns", type=int, default=24,
                    help="eval-subset cap for the beam=3 decode stage")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    ap.add_argument("--extra-set", action="append", default=[], metavar="KEY=VALUE",
                    help="Config overrides appended to every arm's config (e.g. compute_dtype=float32)")
    args = ap.parse_args(argv)

    from ..device import DEVICE_ENV, resolve_device

    dev = resolve_device("cpu" if args.cpu else None)
    t0 = time.time()

    def log(msg: str) -> None:
        print(f"[v5000 +{time.time()-t0:6.1f}s] {msg}", flush=True)

    root = os.path.abspath(args.out)
    os.makedirs(root, exist_ok=True)

    img_dir, caption_file, _ = make_rich_corpus(
        root, num_images=args.num_images, image_edge=args.image_size
    )
    log(f"corpus: {args.num_images} images, 2 captions each")

    from .. import runtime
    from ..cli import build_config
    from ..data.dataset import build_vocabulary
    from ..data.vocabulary import Vocabulary
    from ..ops.fused_attend import fused_attend
    from ..parallel.sharding import leaf_dim, walk
    from .quality_run import card_facts, median_step_ms, serving_state, set_args

    facts = card_facts(dev)
    log(f"device: {facts['device']} ({dev}), power limit {facts['power_limit']}")

    # ~steps*B annotations so one epoch is exactly the bounded run
    ann_cap = args.steps * args.batch_size
    common = [
        f"train_image_dir={img_dir}",
        f"train_caption_file={caption_file}",
        f"eval_image_dir={img_dir}",
        f"eval_caption_file={caption_file}",
        f"vocabulary_file={root}/vocabulary.csv",
        f"temp_annotation_file={root}/anns.csv",
        f"temp_data_file={root}/data.npy",
        f"eval_result_dir={root}/results",
        "vocabulary_size=5000",
        f"batch_size={args.batch_size}",
        f"image_size={args.image_size}",
        "num_epochs=1",
        f"max_train_ann_num={ann_cap}",
        f"max_eval_ann_num={args.eval_anns}",
        "save_period=0",
        f"log_every={log_every(args.steps)}",
        # deterministic trajectories for the parity comparison
        "fc_drop_rate=0.0",
        "lstm_drop_rate=0.0",
    ]

    def argv_for(phase: str, *extra: str) -> List[str]:
        return [f"--phase={phase}"] + set_args([*common, *extra, *args.extra_set])

    def cfg(phase: str, *extra: str):
        config, _ = build_config(argv_for(phase, *extra))
        return config

    # 1) vocabulary from the FULL corpus (no ann cap) — the 5000 cap must
    # bind, which is the point of the exercise
    vocab_cfg = cfg("train", "max_train_ann_num=none")
    if not os.path.exists(vocab_cfg.vocabulary_file):
        vocabulary = build_vocabulary(vocab_cfg)
    else:
        vocabulary = Vocabulary(5000, vocab_cfg.vocabulary_file)
    vocab_words = len(vocabulary.words)
    log(f"vocabulary built: {vocab_words} words (cap 5000)")
    if vocab_words != 5000:
        raise SystemExit(f"corpus must overflow the top-5000 cap, built {vocab_words}")

    # 2) single-process trajectory
    single_cfg = cfg(
        "train",
        f"save_dir={root}/models_single",
        f"summary_dir={root}/summary_single",
        "mesh_shape=1,1",
    )
    log("training in one process at V=5000")
    state_single = runtime.train(single_cfg, seed=single_cfg.seed, device=dev)
    single_losses = _losses(f"{root}/summary_single")
    step_ms_single = median_step_ms(f"{root}/summary_single/metrics.jsonl")
    log(f"one process done: {int(state_single.step)} steps, "
        f"loss {single_losses[0]:.4f} -> {single_losses[-1]:.4f}, median step {step_ms_single} ms")

    # 3) vocab-TP (2 data x 4 model) trajectory, same seed and data
    tp_extra = (f"save_dir={root}/models_tp", f"summary_dir={root}/summary_tp",
                f"mesh_shape={MESH_SHAPE[0]},{MESH_SHAPE[1]}")
    tp_cfg = cfg("train", *tp_extra)
    # guard against silently-replicated "TP": the embedding/softmax rows
    # must actually shard 4-way at this width
    n_sharded = sum(
        leaf_dim(path, tuple(t.shape), tp_cfg, MESH_SHAPE[1]) is not None
        for path, t in walk(state_single.params)
    )
    if n_sharded <= 0:
        raise SystemExit("no parameter sharded over 'model' at V=5000")
    log(f"TP shards {n_sharded} param tensors over 'model'")

    # 4) beam=3 decode at V=5000 through the full eval pipeline, in this
    # process (the mesh's eval runs in the ranks below)
    log("beam=3 eval decode, one process")
    fused_attend.launches = fused_attend.masked_launches = 0
    eval_single = runtime.evaluate(
        cfg("eval", f"summary_dir={root}/summary_single",
            f"eval_result_file={root}/results_single.json",
            "beam_size=3", "mesh_shape=1,1"),
        state=serving_state(state_single), device=dev,
    )
    launches_single = fused_attend.launches
    log(f"one-process scores: { {k: round(v, 4) for k, v in eval_single.items()} } "
        f"(fused_attend launched {launches_single} times)")

    world = MESH_SHAPE[0] * MESH_SHAPE[1]
    log(f"training a dp={MESH_SHAPE[0]} x tp={MESH_SHAPE[1]} mesh at V=5000 (same seed, same batches), "
        f"then its beam=3 eval: the CLI in {world} ranks")
    runs = [
        argv_for("train", *tp_extra),
        argv_for("eval", f"save_dir={root}/models_tp", f"summary_dir={root}/summary_tp",
                 f"eval_result_file={root}/results_tp.json", "beam_size=3",
                 f"mesh_shape={MESH_SHAPE[0]},{MESH_SHAPE[1]}"),
    ]
    tally_dir = os.path.join(root, "tally_tp")
    env = dict(os.environ)
    if dev.type == "cpu":
        env[DEVICE_ENV] = "cpu"
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    t_mesh = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(world),
         "-m", "sat_tpu_torch.tools.cli_ranks", tally_dir, json.dumps(runs)],
        cwd=repo, env=env, capture_output=True, text=True,
    )
    mesh_wall = time.time() - t_mesh
    with open(os.path.join(root, "ranks.log"), "w") as f:
        f.write(proc.stdout + "\n" + proc.stderr)
    if proc.returncode != 0:
        print(proc.stdout[-4000:] + "\n" + proc.stderr[-8000:], file=sys.stderr)
        raise SystemExit(f"the {world} ranks exited {proc.returncode} (log: {root}/ranks.log)")
    tallies = []
    for path in sorted(glob.glob(os.path.join(tally_dir, "tally_rank*.json"))):
        with open(path) as f:
            tallies.append(json.load(f))
    tp_losses = _losses(f"{root}/summary_tp")
    step_ms_tp = median_step_ms(f"{root}/summary_tp/metrics.jsonl")
    log(f"mesh done in {mesh_wall:.1f}s: {len(tp_losses)} records, "
        f"loss {tp_losses[0]:.4f} -> {tp_losses[-1]:.4f}, median step {step_ms_tp} ms")

    # 5) per-record loss parity.  fp32, identical data order, dropout
    # off: the only divergence source is collective/matmul reduction
    # order, which Adam amplifies step over step.
    if not (single_losses.shape == tp_losses.shape and len(single_losses) > 0):
        raise SystemExit(f"loss records differ: {single_losses.shape} vs {tp_losses.shape}")
    rel = np.abs(tp_losses - single_losses) / np.maximum(single_losses, 1e-9)
    log(f"loss parity: max rel diff {rel.max():.3e} over {len(rel)} records")
    for i, (a, b, r) in enumerate(zip(single_losses, tp_losses, rel)):
        log(f"  record {i}: one process {a:.6f}, mesh {b:.6f}, rel {r:.3e}")

    # the mesh eval's results.json (rank 0's), scored by the same scorers
    eval_tp = score_results(cfg("eval", f"eval_result_file={root}/results_tp.json"))
    log(f"mesh scores: { {k: round(v, 4) for k, v in eval_tp.items()} }")

    payload = {
        "vocab_words": vocab_words,
        "vocabulary_cap_bound": True,
        "num_images": args.num_images,
        "image_size": args.image_size,
        "train_steps": int(state_single.step),
        "loss_single_first_last": [float(single_losses[0]), float(single_losses[-1])],
        "loss_tp_first_last": [float(tp_losses[0]), float(tp_losses[-1])],
        "loss_parity_max_rel": float(rel.max()),
        "mesh_shape": list(MESH_SHAPE),
        "tp_sharded_tensors": n_sharded,
        "scores_single": eval_single,
        "scores_tp": eval_tp,
        "total_seconds": round(time.time() - t0, 1),
        "device": facts["device"],
        "power_limit": facts["power_limit"],
        "loss_records": len(rel),
        "step_ms_single": step_ms_single,
        "step_ms_tp": step_ms_tp,
        "mesh_seconds": round(mesh_wall, 1),
        "launches_single_eval": launches_single,
        "launches_tp_eval_ranks": [t[1]["launches"] for t in tallies if len(t) > 1],
    }
    with open(os.path.join(root, "result.json"), "w") as f:
        json.dump(payload, f, indent=2)
    with open(os.path.join(root, "summary.md"), "w") as f:
        f.write(summary_text(argv if argv is not None else sys.argv[1:], payload))
    print(json.dumps(payload))

    # the gates: the artifact records the exact values first
    if not rel.max() < 5e-2:
        raise SystemExit(f"TP trajectory diverged: {rel.max()}")
    for name, scores in (("one process", eval_single), ("mesh", eval_tp)):
        if not scores or not all(math.isfinite(v) for v in scores.values()):
            raise SystemExit(f"{name} scores are not finite: {scores}")
    return 0


def score_results(config):
    """BLEU-1..4 / METEOR / ROUGE_L / CIDEr of ``config.eval_result_file``
    over the eval split, as ``runtime.evaluate`` scores its own."""
    from .. import runtime
    from ..evalcap.eval import CocoEvalCap

    coco, dataset, _ = runtime.prepare_eval_data(config)
    with open(config.eval_result_file) as f:
        payload = json.load(f)
    return CocoEvalCap(coco, coco.load_results(payload), eval_data=dataset).evaluate()


def summary_text(argv: List[str], p: dict) -> str:
    where = f"**{p['device']}**" + (f" (power limit {p['power_limit']})" if p["power_limit"] else "")
    lines = [
        "# V=5000 run: one process against a (2,4) vocab-parallel mesh",
        "",
        f"`{' '.join(['python -m sat_tpu_torch.tools.vocab5000_run', *argv])}` on {where}; "
        f"{p['total_seconds']} s in all, the {p['mesh_shape'][0] * p['mesh_shape'][1]} ranks "
        f"{p['mesh_seconds']} s (train and eval, start-up included).",
        "",
        f"Vocabulary {p['vocab_words']} words (the cap binds), {p['num_images']} images at "
        f"{p['image_size']} px, {p['train_steps']} steps an arm; {p['tp_sharded_tensors']} parameter "
        "tensors sharded over `model`.",
        "",
        "| Reading | One process | Mesh (2,4) |",
        "|---|---|---|",
        f"| loss, first / last record | {p['loss_single_first_last'][0]:.6f} / "
        f"{p['loss_single_first_last'][1]:.6f} | {p['loss_tp_first_last'][0]:.6f} / "
        f"{p['loss_tp_first_last'][1]:.6f} |",
        f"| median step (ms, logged intervals after the first) | {p['step_ms_single']} | {p['step_ms_tp']} |",
    ]
    for k in p["scores_single"]:
        lines.append(f"| {k} (beam 3) | {p['scores_single'][k]:.4f} | {p['scores_tp'].get(k, float('nan')):.4f} |")
    lines += [
        "",
        f"Loss parity: max relative difference {p['loss_parity_max_rel']:.3e} over {p['loss_records']} "
        "records (gate 5e-2).",
        "",
    ]
    return "\n".join(lines)


if __name__ == "__main__":
    sys.exit(main())
