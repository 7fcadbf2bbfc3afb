"""Quality-plane overhead gate: what the drift observability costs — the
port of ``scripts/bench_quality.py``, with its flags, row and exit code.

The caption-quality plane (signal extraction at the detok boundary +
streaming sketch/PSI updates, ``sat_tpu_torch/telemetry/quality.py``) is
claimed cheap enough to leave on for every serving request.  This bench
puts a number on it the same way the metering bench does:

* **live arm** — a real in-process serving stack booted with
  ``--serve_quality on`` (a seed-made flagship model, warmed) on the
  card, one closed-loop client, batch mode (B1 decodes); measures
  request p50 WITH the plane enabled, asserts ZERO steady-state kernel
  builds (the port's compile events: the alphas harvest must ride the
  existing drained transfer), and that /stats carries a live
  ``quality`` block with a frozen reference.
* **quality-path microbench** — the per-request host work in isolation
  (``extract_signals`` over a real drained beam result, alphas
  included, then ``QualityMonitor.observe`` with a frozen reference —
  the sketch updates + outlier screen every request pays; periodic
  PSI publication rides its rate limiter exactly as in production),
  priced against the live arm's p50.

Prints one BENCH-contract JSON line (``tools/check_regression.py``):

* ``quality_overhead_pct`` (pct, lower is better, noise-floored at
  0.05) — extraction+sketch cost as % of serve p50.  **Hard gate:**
  raw overhead <= 0.5% and zero steady-state recompiles, exit 1
  otherwise.

Usage: python -m sat_tpu_torch.tools.bench_quality [--requests 80]
       [--microbench 4000] [--workdir DIR]   (the card, or the CPU with
       SAT_TORCH_DEVICE=cpu)
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import shutil
import sys
import tempfile
import time
import urllib.request

import numpy as np

from .benchlib import bench_device, device_kind, make_log, parse_sets

log = make_log("bench_quality")


SENTENCES = [
    "a man riding a horse on the beach.",
    "a group of people standing around a kitchen.",
    "two dogs playing with a red ball in the grass.",
    "a plate of food with rice and vegetables.",
    "a bus driving down a city street.",
    "a cat sitting on top of a wooden table.",
]


def _make_jpegs(n: int, size: int) -> list:
    import cv2

    out = []
    for i in range(n):
        rng = np.random.default_rng(100 + i)
        img = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
        c = i % 3
        extent = size // 4 + (3 * i) % (3 * size // 4)
        img[:extent, :, c] = 30 * (i + 1) % 255
        ok, buf = cv2.imencode(".jpg", img)
        assert ok
        out.append(bytes(buf))
    return out


def _make_ckpt(workdir, quality_window, extra_set):
    """A fresh flagship model (``Config``'s widths; ``--extra-set``
    changes them) drawn from seed 0, saved through checkpoint+lineage,
    quality ON."""
    import torch

    from .. import telemetry
    from ..config import Config
    from ..data.vocabulary import Vocabulary
    from ..resilience import lineage
    from ..train.checkpoint import save_checkpoint
    from ..train.step import create_train_state

    vocab_file = os.path.join(workdir, "vocabulary.csv")
    vocabulary = Vocabulary(size=50)
    vocabulary.build(SENTENCES)
    vocabulary.save(vocab_file)

    config = parse_sets(Config(
        phase="serve",
        vocabulary_size=vocabulary.size,
        vocabulary_file=vocab_file,
        save_dir=os.path.join(workdir, "models"),
        summary_dir=os.path.join(workdir, "summary"),
        serve_buckets=(1, 4),
        serve_max_batch=4,
        serve_max_wait_ms=2,
        heartbeat_interval=0.0,
        serve_quality="on",
        serve_quality_window=quality_window,
        serve_quality_exemplar_dir=os.path.join(workdir, "exemplars"),
    ), extra_set)
    os.makedirs(config.save_dir, exist_ok=True)
    tel = telemetry.enable(capacity=1 << 18)
    state = create_train_state(config, torch.Generator().manual_seed(0), "cpu")
    save_checkpoint(state, config)
    lineage.mark_last_good(config.save_dir, int(state.step))
    return config, vocabulary, tel


def _post(port, data, timeout=60.0):
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/caption", body=data,
                     headers={"Content-Type": "image/jpeg"})
        resp = conn.getresponse()
        resp.read()
        return resp.status, time.perf_counter() - t0
    finally:
        conn.close()


def _get_json(port, path, timeout=10.0):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=timeout
    ) as r:
        return json.loads(r.read())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sat_tpu_torch.tools.bench_quality",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=80,
                    help="closed-loop requests on the live arm")
    ap.add_argument("--microbench", type=int, default=4000,
                    help="quality-path iterations in the microbench")
    ap.add_argument("--quality-window", type=int, default=32,
                    help="reference window (small, so it freezes mid-run)")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--extra-set", action="append", default=[], metavar="KEY=VALUE",
                    help="Config overrides over the flagship model (the port's addition)")
    args = ap.parse_args(argv)
    kind = device_kind(bench_device())

    workdir = args.workdir or tempfile.mkdtemp(prefix="bench_quality_")
    made_workdir = args.workdir is None
    try:
        from .. import telemetry
        from ..ops.fused_attend import fused_attend
        from ..serve.engine import ServeEngine, load_serving_state
        from ..serve.server import CaptionServer
        from ..telemetry.quality import QualityMonitor, extract_signals

        config, vocabulary, tel = _make_ckpt(workdir, args.quality_window, args.extra_set)
        state, _ = load_serving_state(config)
        engine = ServeEngine(config, state, vocabulary, tel=tel)
        engine.warmup()
        server = CaptionServer(config, engine, port=0).start()
        log(f"server up on port {server.port} (quality on, "
            f"window {args.quality_window})")

        jpegs = _make_jpegs(16, config.image_size)
        try:
            # --- live arm: closed loop, zero-recompile assert ---------
            status, _ = _post(server.port, jpegs[0])  # warm pass
            assert status == 200, f"warm request failed: {status}"
            compiles0 = tel.counters().get("kernel/builds", 0)
            launches0 = fused_attend.launches
            lats = []
            for i in range(args.requests):
                status, lat = _post(server.port, jpegs[i % len(jpegs)])
                if status == 200:
                    lats.append(lat)
            recompiles = tel.counters().get("kernel/builds", 0) - compiles0
            launches = fused_attend.launches - launches0
            data = np.sort(np.asarray(lats, np.float64)) * 1e3
            p50 = round(float(data[int(0.5 * len(data))]), 3)
            stats = _get_json(server.port, "/stats")
            quality = stats.get("quality") or {}
            frozen = bool(quality.get("reference"))
            log(f"live arm: {len(lats)}/{args.requests} ok, p50 {p50}ms, "
                f"steady-state compiles {recompiles}, quality block "
                f"requests={quality.get('requests')} psi_max="
                f"{quality.get('psi_max')} reference_frozen={frozen}")

            # --- microbench: the per-request quality path -------------
            out = engine.dispatch(engine.pad_batch(
                [engine.preprocess(jpegs[0])])[0])
            words, lengths, scores, alphas = engine.drain_output(out, 1)
            assert alphas is not None, "quality-on drain must carry alphas"
            monitor = QualityMonitor(window=64, tel=tel)
            vocab_size = len(vocabulary.words)
            # fill + freeze the reference first, so the timed loop pays
            # the steady-state path (sketch update + PSI screen), not the
            # one-time freeze
            for _ in range(80):
                sig = extract_signals(
                    words[0], lengths[0], scores[0],
                    vocab_size=vocab_size, eos_id=engine.eos_id,
                    alphas=alphas[0])
                monitor.observe(sig)
            t0 = time.perf_counter()
            for _ in range(args.microbench):
                sig = extract_signals(
                    words[0], lengths[0], scores[0],
                    vocab_size=vocab_size, eos_id=engine.eos_id,
                    alphas=alphas[0])
                monitor.observe(sig)
                monitor.maybe_publish()
            quality_us = (time.perf_counter() - t0) / args.microbench * 1e6
            log(f"quality path: {quality_us:.2f}us/request over "
                f"{args.microbench} iterations (signals + sketch + "
                f"rate-limited publish)")

            raw_overhead = quality_us / 1e3 / p50 * 100.0 if p50 else 0.0
            # noise-floored like the metering row: the raw number is tiny
            # and a percent-delta gate over it would page on scheduler
            # jitter; the HARD gate below judges the raw value
            overhead = round(max(raw_overhead, 0.05), 4)

            print(json.dumps({
                "metric": "quality_overhead_pct",
                "value": overhead,
                "unit": "pct",
                "raw_overhead_pct": round(raw_overhead, 5),
                "noise_floor": 0.05,
                "gate_pct": 0.5,
                "quality_path_us": round(quality_us, 3),
                "microbench_iters": args.microbench,
                "request_p50_ms": p50,
                "requests_ok": len(lats),
                "steady_state_compiles": recompiles,
                "quality_requests": quality.get("requests"),
                "quality_psi_max": quality.get("psi_max"),
                "reference_frozen": frozen,
                "fused_attend_launches": launches,
                "device_kind": kind,
                **telemetry.bench_stamp(),
            }), flush=True)

            ok = (
                raw_overhead <= 0.5
                and recompiles == 0
                and len(lats) == args.requests
                and quality.get("requests", 0) > 0
                and frozen
            )
            if not ok:
                log("GATE FAILED: overhead > 0.5%, a steady-state "
                    "recompile, failed requests, or no live quality block")
            return 0 if ok else 1
        finally:
            server.shutdown()
    finally:
        if made_workdir:
            shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
