"""Eval-side decode throughput: images/sec at beam_size=3 — the port of
``scripts/bench_eval.py``.

Measures the whole decode of a batch on the card: VGG16 encode, then the
batched beam search (B1, the fused attention kernel, once a decode step),
chained call to call (``utils.benchmarking``), one sync a window.  The
row carries B1's launches over the measurement.

Usage: python -m sat_tpu_torch.tools.bench_eval [--batch 32] [--beam 3]
       [--iters 20]   (the card; --cpu --image-size 64 for a smoke run on
       the CPU, whose rows say device_kind "cpu")
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

from .benchlib import bench_device, device_kind


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m sat_tpu_torch.tools.bench_eval")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--beam", type=int, default=3)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    # A/B control for the search's exact early exit (ops/beam_search.py);
    # the random-init model here never emits eos from the top-K set, so
    # both arms measure the full-T worst case: the flag is for trained
    # checkpoints via --params
    ap.add_argument("--no-early-exit", action="store_true")
    ap.add_argument(
        "--params", default=None,
        help="checkpoint .npz to decode with (a trained model terminates "
        "early; random init is the worst case)",
    )
    ap.add_argument(
        "--vocab", default=None,
        help="vocabulary CSV of the checkpoint's run — required with "
        "--params: derives the real '.' eos id and the valid_size mask "
        "the production decode applies",
    )
    ap.add_argument(
        "--vocab-size", type=int, default=None,
        help="the checkpoint run's config.vocabulary_size (logit width) "
        "when it differs from the default",
    )
    ap.add_argument(
        "--encoder-quant", choices=("off", "bf16", "int8"), default="off",
        help="A/B the PTQ encoder (sat_tpu_torch/nn/quant.py): measures the "
        "float arm first, then the quantized arm over the SAME weights, "
        "emitting a second eval_images_per_sec_<mode> row",
    )
    ap.add_argument(
        "--extra-set", action="append", default=[], metavar="KEY=VALUE",
        help="Config overrides over the defaults (the port's addition, e.g. "
        "compute_dtype=float32)",
    )
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.params and not args.vocab:
        ap.error("--params requires --vocab (eos id + valid_size must come "
                 "from the run's vocabulary, not a fixed index)")
    dev = bench_device(args.cpu)

    import numpy as np
    import torch

    from .. import telemetry
    from ..config import Config
    from ..models.captioner import init_variables
    from ..ops import fused_attend as fa
    from ..train.checkpoint import assign_flat, compute_params, load_flat, named_leaves
    from ..utils.benchmarking import make_chained_decode, time_decode_windows
    from .benchlib import parse_sets

    kind = device_kind(dev)
    print(f"device: {kind}", file=sys.stderr, flush=True)
    config = Config(batch_size=args.batch, beam_size=args.beam, image_size=args.image_size)
    config = parse_sets(config, args.extra_set)
    if args.vocab_size:
        config = config.replace(vocabulary_size=args.vocab_size)
    B = args.batch
    rng = np.random.default_rng(0)
    images = torch.from_numpy(
        rng.normal(size=(B, args.image_size, args.image_size, 3)).astype(np.float32)
    ).to(dev)
    eos = 1  # any fixed vocab index; random init never tops it: worst case
    valid_size = None
    params, batch_stats = init_variables(config, torch.Generator().manual_seed(0), dev)
    if args.params:
        from ..data.vocabulary import Vocabulary
        from ..runtime import _eos_id

        # width set BEFORE loading: Vocabulary clamps its word list to size
        vocab = Vocabulary(config.vocabulary_size, save_file=args.vocab)
        eos = _eos_id(vocab)
        valid_size = len(vocab.words)
        # partial restore guard: a leaf skipped for its shape would
        # silently benchmark random weights as "trained", so count the
        # params group by itself
        flat = load_flat(args.params)
        n_p = assign_flat(params, "params/", flat)
        n_params = sum(1 for _ in named_leaves(params, "params/"))
        if n_p < n_params:
            print(f"checkpoint covered {n_p}/{n_params} param leaves — wrong "
                  "config/--vocab-size for this checkpoint?", file=sys.stderr)
            return 2
        assign_flat(batch_stats, "batch_stats/", flat)
    variables = compute_params(params, config, batch_stats)

    decode = make_chained_decode(
        config, eos=eos, beam_size=args.beam, valid_size=valid_size,
        early_exit=not args.no_early_exit,
    )
    launches0 = fa.fused_attend.launches
    compile_s, windows_ms, _ = time_decode_windows(decode, variables, images, args.iters, windows=1)
    launches = fa.fused_attend.launches - launches0
    print(f"compile+first: {compile_s:.1f}s", file=sys.stderr, flush=True)

    images_per_sec = 1e3 * B / windows_ms[0]
    common = {
        "unit": f"images/sec @ beam={args.beam}",
        "batch_size": B,
        "early_exit": not args.no_early_exit,
        "device_kind": kind,
        **telemetry.bench_stamp(),
    }
    print(json.dumps({
        "metric": "eval_images_per_sec",
        "value": round(images_per_sec, 2),
        "vs_baseline": None,
        "batch_ms": round(windows_ms[0], 1),
        "encoder_quant": "off",
        "compute_dtype": config.compute_dtype,
        "compile_s": round(compile_s, 2),
        "fused_attend_launches": launches,
        **common,
    }), flush=True)

    if args.encoder_quant != "off":
        # quantized arm: same weights through the PTQ pass, same decode;
        # the row pair is the encode-path A/B
        from ..nn import quant

        qconfig = config.replace(encoder_quant=args.encoder_quant)
        t0 = time.perf_counter()
        qcnn = quant.quantize_encoder({"cnn": params["cnn"], "batch_stats": batch_stats}, qconfig, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        quantize_s = time.perf_counter() - t0
        qvars = {**compute_params({"decoder": params["decoder"]}, qconfig), "qcnn": qcnn}
        qdecode = make_chained_decode(
            qconfig, eos=eos, beam_size=args.beam, valid_size=valid_size,
            early_exit=not args.no_early_exit,
        )
        launches0 = fa.fused_attend.launches
        q_compile_s, q_windows_ms, _ = time_decode_windows(qdecode, qvars, images, args.iters, windows=1)
        q_launches = fa.fused_attend.launches - launches0
        print(f"quant arm ({args.encoder_quant}) compile+first: {q_compile_s:.1f}s "
              f"(quantize {quantize_s:.2f}s)", file=sys.stderr, flush=True)
        print(json.dumps({
            "metric": f"eval_images_per_sec_{args.encoder_quant}",
            "value": round(1e3 * B / q_windows_ms[0], 2),
            "vs_baseline": None,
            "batch_ms": round(q_windows_ms[0], 1),
            "encoder_quant": args.encoder_quant,
            "quantize_seconds": round(quantize_s, 3),
            "fp32_images_per_sec": round(images_per_sec, 2),
            "fused_attend_launches": q_launches,
            **common,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
