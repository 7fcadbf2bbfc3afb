#!/usr/bin/env python3
"""Smoke run of sat_tpu_torch on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases, each fatal on failure:

1. device — a CUDA card must be visible; prints its name and power limit.
2. build  — compiles every ``sat_tpu_torch/csrc/*.cu`` with nvcc (sm_90a).
3. kernel — the CUDA ``fused_attend`` against its plain torch version on
   the card, at the flagship decode shape (bucket 32 × beam 3 = 96 rows,
   N=196, da=D=512) and a ragged one, in float32 and bfloat16, with a
   control that a kernel rounding in the wrong place fails; times both
   with CUDA events beside the kernel's memory bound.
4. reference — the serving path at a small float32 size on the card and
   on the CPU (the plain versions): the same captions.
5. slice — a full-width flagship checkpoint (VGG16 at 224 px, vocabulary
   5000, bf16) made from a numpy seed in the JAX package's ``<step>.npz``
   format with a LAST_GOOD pointer; ``load_serving_state`` →
   ``ServeEngine.warmup`` → ``CaptionServer`` on an ephemeral port, then
   POSTed requests: three alone (bucket 1), then 3 and then 31 sent at
   once just after a lead request, so they queue behind it and ride
   batches (bucket 4, then up to 32); an image sent alone and in a batch
   must caption the same.  Launch counts are reset just before and read just
   after, so the kernel must have run on the main path.
6. profile — one bucket-32 dispatch under torch.profiler: device busy
   time against wall time, and the top kernels.

Prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero without a card or
without the package beside it.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (NVIDIA data sheet)
FP32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
SEED = 0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str, t0: float) -> None:
    print(f"phase {name}: ok in {time.perf_counter() - t0:.1f}s", flush=True)


# -- kernel phase ------------------------------------------------------------

def attention_inputs(torch, B, N, da, D, gen):
    """Inputs shaped like the decode path's: tanh features, a small w2,
    non-negative (post-relu) contexts."""
    dev = "cuda"
    t1 = torch.tanh(torch.randn((B, N, da), generator=gen, device=dev))
    t2 = torch.tanh(torch.randn((B, da), generator=gen, device=dev))
    w2 = (torch.rand((da, 1), generator=gen, device=dev) - 0.5) * 0.16
    ctx = torch.relu(torch.randn((B, N, D), generator=gen, device=dev))
    return t1, t2, w2, ctx


def time_ms(torch, fn, flush, reps: int = 60, warm: int = 10) -> float:
    """Median device time of ``reps`` single calls, by CUDA events, with
    the L2 cache flushed before each (the decode loop streams t1 and
    contexts back from device memory every step).  A spin kernel ahead
    of each call keeps the card busy while the host enqueues it, so the
    host's launch overhead stays out of the interval."""
    for _ in range(warm):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        torch.cuda._sleep(1_000_000)  # ~0.5 ms of spinning
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def attention_bound_ms(B, N, da, D) -> tuple:
    """Least time for the work: each input read once, each output
    written once, over the memory rate; the float32 flops over the
    float32 rate.  Returns (ms, "bytes" or "operations")."""
    nbytes = 4 * (B * N * da + B * da + da + B * N * D + B * D + B * N)
    flops = B * N * (3 * da + 2 * D) + 4 * B * N
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(torch, fa):
    """The kernel against its plain version by ``fa.agreement`` (float32:
    elementwise; bfloat16: the same rounded logits up to rare one-ulp
    flips), then a control: the kernel without its bf16 rounding (mode
    float32) held against the bf16 plain version must fail that rule."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    rows = []
    for (B, N, da, D) in ((96, 196, 512, 512), (5, 7, 24, 40), (3, 196, 512, 512)):
        for dtype in ("float32", "bfloat16"):
            args = attention_inputs(torch, B, N, da, D, gen)
            got = fa.fused_attend(*args, compute_dtype=dtype)
            want = fa.fused_attend_reference(*args, compute_dtype=dtype)
            logits = fa.reference_logits(*args[:3], compute_dtype=dtype)
            rep = fa.agreement(got, want, args[3], logits, dtype)
            if not rep["ok"]:
                fail(f"fused_attend {dtype} B={B} N={N} da={da} D={D}: {rep}")
            if (B, dtype) == (96, "bfloat16"):
                control = fa.agreement(fa.fused_attend(*args, compute_dtype="float32"),
                                       want, args[3], logits, dtype)
                if control["ok"]:
                    fail(f"control: the kernel without bf16 rounding passed the bf16 rule: {control}")
                print(f"control fused_attend mode float32 vs bfloat16 plain B={B}: fails as it "
                      f"must ({control['why']}): {control}", flush=True)
            ms = time_ms(torch, lambda: fa.fused_attend(*args, compute_dtype=dtype), flush)
            plain_ms = time_ms(torch, lambda: fa.fused_attend_reference(*args, compute_dtype=dtype), flush)
            bound_ms, bound_by = attention_bound_ms(B, N, da, D)
            print(
                f"kernel fused_attend {dtype} B={B} N={N} da={da} D={D}: {rep}; "
                f"kernel {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, "
                f"bound {bound_ms * 1e3:.1f} us ({bound_by}, {bound_ms / ms:.1%} of it)",
                flush=True,
            )
            rows.append(dict(B=B, N=N, da=da, D=D, dtype=dtype, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             max_abs_err=rep["max_abs_err"]))
    return rows


# -- checkpoint + images -----------------------------------------------------

def write_checkpoint(np, config, save_dir: str, step: int, seed: int) -> str:
    """Random weights in the JAX package's flat format: glorot-uniform
    convs, uniform(±scale) dense kernels and embedding, zero biases."""
    from sat_tpu_torch.data.vocabulary import vocab_fingerprint
    from sat_tpu_torch.resilience import lineage
    from sat_tpu_torch.train.checkpoint import param_shapes

    rng = np.random.default_rng(seed)
    flat = {}
    for name, shape in param_shapes(config).items():
        if name.endswith("/bias"):
            flat[name] = np.zeros(shape, np.float32)
        elif "/cnn/" in name:
            fan_in, fan_out = shape[0] * shape[1] * shape[2], shape[0] * shape[1] * shape[3]
            lim = (6.0 / (fan_in + fan_out)) ** 0.5
            flat[name] = rng.uniform(-lim, lim, shape).astype(np.float32)
        else:
            s = config.fc_kernel_initializer_scale
            flat[name] = rng.uniform(-s, s, shape).astype(np.float32)
    flat["global_step"] = np.asarray(step, np.int32)
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"{step}.npz")
    np.savez(path, **flat)
    lineage.write_sidecar(path, vocab=vocab_fingerprint(config.vocabulary_file, config.vocabulary_size))
    lineage.mark_last_good(save_dir, step)
    return path


def write_vocabulary(np, path: str, size: int) -> None:
    from sat_tpu_torch.data.vocabulary import Vocabulary

    v = Vocabulary(size)
    v.words = ["<start>", "."] + [f"w{i}" for i in range(2, size)]
    v.word2idx = {w: i for i, w in enumerate(v.words)}
    v.word_frequencies = -np.log1p(np.arange(size, dtype=np.float64))
    v.save(path)


def jpegs(np, n: int, size: int, seed: int):
    import cv2

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    out = []
    for i in range(n):
        img = rng.integers(0, 256, size=(size, size, 3), dtype=np.uint8) // 2
        img[..., i % 3] += ((xx * (i + 1) + yy * 3) % 128).astype(np.uint8)
        ok, buf = cv2.imencode(".jpg", img)
        if not ok:
            fail("cv2 could not encode a test JPEG")
        out.append(buf.tobytes())
    return out


def post(port: int, body: bytes):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/caption", data=body, method="POST",
        headers={"Content-Type": "image/jpeg"},
    )
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            status, payload = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        status, payload = e.code, json.loads(e.read() or b"{}")
    return status, payload, (time.perf_counter() - t0) * 1e3


def post_all(port: int, bodies, lead=None):
    """POST ``bodies`` at once from one thread each.  With ``lead``, that
    request goes first and the others follow 20 ms later, while its
    batch is on the card: they queue behind it and the batcher takes
    them as one batch.  Returns (lead reply or None, replies)."""
    out = [None] * len(bodies)
    lead_out = []

    def one(i):
        out[i] = post(port, bodies[i])

    lead_thread = None
    if lead is not None:
        lead_thread = threading.Thread(target=lambda: lead_out.append(post(port, lead)))
        lead_thread.start()
        time.sleep(0.02)
    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads + ([lead_thread] if lead_thread else []):
        t.join(timeout=600)
    if any(o is None for o in out) or (lead is not None and not lead_out):
        fail("a request thread did not finish")
    return (lead_out[0] if lead_out else None), out


# -- phases 4-6 ----------------------------------------------------------------

def reference_phase(torch, np, tmp: str):
    """The serving path at a small float32 size on the card (CUDA kernel)
    and on the CPU (plain versions): identical words, close scores."""
    from sat_tpu_torch.config import Config
    from sat_tpu_torch.data.vocabulary import Vocabulary
    from sat_tpu_torch.serve.engine import ServeEngine, load_serving_state

    config = Config(
        image_size=32, dim_embedding=16, num_lstm_units=16, dim_initialize_layer=16,
        dim_attend_layer=16, dim_decode_layer=32, vocabulary_size=50,
        compute_dtype="float32", beam_size=3, serve_buckets=(4,), serve_max_batch=4,
        save_dir=os.path.join(tmp, "small"), vocabulary_file=os.path.join(tmp, "small.csv"),
    )
    write_vocabulary(np, config.vocabulary_file, config.vocabulary_size)
    write_checkpoint(np, config, config.save_dir, step=1, seed=SEED + 1)
    vocab = Vocabulary(config.vocabulary_size, config.vocabulary_file)
    engines = {
        dev: ServeEngine(config, load_serving_state(config, device=dev)[0], vocab, device=dev)
        for dev in ("cuda", "cpu")
    }
    images = np.stack([engines["cpu"].preprocess(b) for b in jpegs(np, 4, 64, SEED + 2)])
    res = {dev: e.drain_output(e.dispatch(images), 4) for dev, e in engines.items()}
    if not np.array_equal(res["cuda"][0], res["cpu"][0]) or not np.array_equal(res["cuda"][1], res["cpu"][1]):
        fail(f"reference: words differ between cuda and cpu:\n{res['cuda'][0]}\n{res['cpu'][0]}")
    err = float(np.abs(res["cuda"][2] - res["cpu"][2]).max())
    if not err <= 1e-4:
        fail(f"reference: log-prob max abs err {err:.3e} over 1e-4")
    print(f"reference float32 small model: cuda == cpu words, log-prob max abs err {err:.3e} (tol 1e-4)",
          flush=True)


def flagship_config(tmp: str):
    """The model the repo ships, as served by default: every architecture
    and serve default (VGG16 at 224 px, da=512, 2-layer MLPs, LSTM 512,
    vocabulary 5000, beam 3, bf16, buckets 1/4/16/32, a batch held open
    at most 5 ms)."""
    from sat_tpu_torch.config import Config

    return Config(
        phase="serve", save_dir=os.path.join(tmp, "models"),
        vocabulary_file=os.path.join(tmp, "vocabulary.csv"),
    )


def slice_phase(np, fa, config, card: str, device=None):
    from sat_tpu_torch.data.vocabulary import Vocabulary
    from sat_tpu_torch.serve.engine import ServeEngine, load_serving_state
    from sat_tpu_torch.serve.server import CaptionServer

    write_vocabulary(np, config.vocabulary_file, config.vocabulary_size)
    t0 = time.perf_counter()
    path = write_checkpoint(np, config, config.save_dir, step=1000, seed=SEED)
    print(f"slice checkpoint {os.path.basename(path)}: {os.path.getsize(path) / 2**20:.0f} MiB "
          f"written in {time.perf_counter() - t0:.1f}s", flush=True)
    state, _ = load_serving_state(config, device=device)
    engine = ServeEngine(
        config, state, Vocabulary(config.vocabulary_size, config.vocabulary_file), device=device
    )
    engine.warmup()
    server = CaptionServer(config, engine, port=0, host="127.0.0.1")
    bodies = jpegs(np, 36, 256, SEED + 3)
    try:
        server.start()
        fa.fused_attend.launches = 0
        t_main = time.perf_counter()
        alone = [post(server.port, bodies[i]) for i in range(3)]
        # a lead request and 3 (then 31) more sent while it runs: 4 (then
        # 32) requests, so however the batcher splits them, a batch of
        # 2-4 (bucket 4) forms unless all arrive one by one
        lead4, trio = post_all(server.port, bodies[0:3], lead=bodies[3])
        lead32, burst = post_all(server.port, bodies[4:35], lead=bodies[35])
        main_s = time.perf_counter() - t_main
        launches = fa.fused_attend.launches
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/stats", timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        server.shutdown()
    replies = alone + [lead4] + trio + [lead32] + burst
    for status, payload, _ in replies:
        if status != 200:
            fail(f"slice: a request got {status}: {payload}")
        caps = payload["captions"]
        if len(caps) != config.beam_size or not all(
            np.isfinite(c["log_prob"]) and isinstance(c["caption"], str) for c in caps
        ):
            fail(f"slice: malformed reply {payload}")
    counters = stats["counters"]
    buckets = {k: v for k, v in counters.items() if k.startswith("bucket_")}
    if not (buckets.get("bucket_1", 0) >= 1 and buckets.get("bucket_4", 0) >= 1):
        fail(f"slice: buckets 1 and 4 must both dispatch, got {buckets}")
    if launches == 0:
        fail("slice: fused_attend was never launched on the main path")
    # images 0-2 went alone first; each that then rode a batch must caption the same
    pairs = [(alone[i][1], trio[i][1]) for i in range(3) if trio[i][1]["bucket"] > 1]
    if not pairs:
        fail(f"slice: no image sent alone was then served in a batch (buckets {buckets})")
    diff = 0.0
    for x, y in pairs:
        if [c["caption"] for c in x["captions"]] != [c["caption"] for c in y["captions"]]:
            fail(f"slice: one image captions differently alone and in bucket {y['bucket']}:\n{x}\n{y}")
        diff = max([diff] + [abs(c["log_prob"] - d["log_prob"]) for c, d in zip(x["captions"], y["captions"])])
    lat = lambda rs: statistics.median(r[2] for r in rs)  # noqa: E731
    print(f"slice: {len(replies)} requests in {main_s:.2f}s, buckets {buckets}, fused_attend "
          f"launches {launches}; {len(pairs)} image(s) alone vs in a batch: same captions, "
          f"log-prob max abs diff {diff:.2e}", flush=True)
    print(f"slice p50 request latency on {card}: alone {lat(alone):.2f} ms (3), 3 sent behind "
          f"a lead {lat(trio):.2f} ms (3), 31 sent behind a lead {lat(burst):.2f} ms (31), "
          f"all {lat(replies):.2f} ms ({len(replies)})", flush=True)
    print(f"slice sample caption (random weights): {alone[0][1]['captions'][0]}", flush=True)
    return engine, launches, bodies


def profile_phase(torch, engine, bodies):
    from torch.profiler import ProfilerActivity, profile

    images = engine.pad_batch([engine.preprocess(b) for b in bodies[:32]])[0]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = engine.dispatch(images)
        engine.drain_output(out, 32)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    if busy == 0:
        fail("profile: torch.profiler recorded no device time")
    print(f"profile bucket 32 bf16: wall {wall_ms:.2f} ms, {out.steps_run} decode steps, device busy "
          f"{busy:.2f} ms ({busy / wall_ms:.1%} of wall)", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"profile kernel {e.self_device_time_total / 1e3:8.3f} ms x{e.count:<4d} {e.key[:90]}",
              flush=True)


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "sat_tpu_torch")):
        fail("the sat_tpu_torch package is not beside this script")
    sys.path.insert(0, here)
    import numpy as np
    import torch

    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}", flush=True)
    phase("device", t0)

    t0 = time.perf_counter()
    from sat_tpu_torch.ops import build
    from sat_tpu_torch.ops import fused_attend as fa

    build.build_all()
    for name, log in build.build_log.items():
        print(f"build {name}: {log['seconds']:.1f}s; " + "; ".join(log["ptxas"]), flush=True)
    phase("build", t0)

    t0 = time.perf_counter()
    rows = kernel_phase(torch, fa)
    phase("kernel", t0)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t0 = time.perf_counter()
        reference_phase(torch, np, tmp)
        phase("reference", t0)
        t0 = time.perf_counter()
        engine, launches, bodies = slice_phase(np, fa, flagship_config(tmp), card)
        phase("slice", t0)
        t0 = time.perf_counter()
        profile_phase(torch, engine, bodies)
        phase("profile", t0)

    main_row = next(r for r in rows if (r["B"], r["dtype"]) == (96, "bfloat16"))
    print(json.dumps({"kernels": [{
        "name": "fused_attend",
        "route": "cuda",
        "source": "sat_tpu_torch/csrc/fused_attend.cu",
        "replaces": "sat_tpu/ops/pallas_attention.py:65",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"],
        "kernel_ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "shape": "B=96 N=196 da=D=512 bfloat16 (bucket 32 x beam 3)",
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
