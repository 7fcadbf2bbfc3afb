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
4. masked — the kernel's masked body (the slot pool's) at B = 48 (the
   flagship pool, 16 slots × beam 3), 5 and 3, float32 and bfloat16, with
   every row, one row or every other row live and NaN/±Inf in the dead
   rows: dead rows must come out +0.0, live rows bitwise equal to the
   unmasked kernel and in agreement with the masked plain version; times
   B=48 bf16 with 48, 24 and 3 live rows beside the plain version and
   the bound of that live count.
5. reference — the serving path at a small float32 size on the card and
   on the CPU (the plain versions), in batch and in continuous mode: the
   same captions.
6. slice — a full-width flagship checkpoint (VGG16 at 224 px, vocabulary
   5000, bf16) made from a numpy seed in the JAX package's ``<step>.npz``
   format with a LAST_GOOD pointer; ``load_serving_state`` →
   ``ServeEngine.warmup`` → ``CaptionServer`` on an ephemeral port, then
   POSTed requests: three alone (bucket 1), then 3 and then 31 sent at
   once just after a lead request, so they queue behind it and ride
   batches (bucket 4, then up to 32); an image sent alone and in a batch
   must caption the same.  Launch counts are reset just before and read just
   after, so the kernel must have run on the main path.
7. profile — one bucket-32 dispatch under torch.profiler: device busy
   time against wall time, and the top kernels.
8. continuous — the same checkpoint served with ``serve_mode=
   "continuous"`` (a 4 × 4 slot pool, decode depths 1/2/4/8) and sent
   the same 39 requests; the 32 of the last burst overflow the 16 slots.
   Every reply 200, and bitwise the monolithic search's on the image's
   contexts encoded at one of the pool's lane shapes (the decode does
   not depend on batch geometry on the card; the bf16 encode does, so
   captions alone, in the burst and in the batch slice are compared and
   counted, not required equal); ``/stats`` shows windows at K=1 and
   K>1; the masked kernel ran (counts reset just before, read just
   after).  Then 16 images encoded once go
   through the pool and the monolithic search: bitwise the same words
   and scores.  Last, one full-pool K=8 window under torch.profiler.

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


def masked_bound_ms(B, live, N, da, D) -> tuple:
    """The masked body's least time: only live rows' inputs must be read
    (dead rows are never touched), every row's outputs written; only live
    rows' flops.  Returns (ms, "bytes" or "operations")."""
    nbytes = 4 * (live * (N * da + da + N * D) + da + B * (D + N)) + B
    flops = live * (N * (3 * da + 2 * D) + 4 * N)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def masked_inputs(args, mask):
    """Dead rows of ``args`` overwritten with NaN (t1, contexts) and ±Inf
    (t2): the garbage a retired slot may hold."""
    t1, t2, w2, ctx = (x.clone() for x in args)
    dead = ~mask
    t1[dead] = float("nan")
    t2[dead] = float("inf")
    t2[dead, ::2] = float("-inf")
    ctx[dead] = float("nan")
    return t1, t2, w2, ctx


def masked_phase(torch, fa):
    """The masked body: dead rows +0.0 bit for bit, live rows bitwise the
    unmasked kernel's on the same inputs, and in agreement
    (``fa.agreement``) with the masked plain version."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    patterns = {
        "all": lambda B: torch.ones(B, dtype=torch.bool, device="cuda"),
        "one": lambda B: torch.arange(B, device="cuda") == B // 2,
        "alternate": lambda B: torch.arange(B, device="cuda") % 2 == 0,
    }
    errs = []
    for (B, N, da, D) in ((48, 196, 512, 512), (5, 7, 24, 40), (3, 196, 512, 512)):
        for dtype in ("float32", "bfloat16"):
            clean = attention_inputs(torch, B, N, da, D, gen)
            for name, make in patterns.items():
                mask = make(B)
                args = masked_inputs(clean, mask)
                got = fa.fused_attend(*args, row_mask=mask, compute_dtype=dtype)
                unmasked = fa.fused_attend(*args, compute_dtype=dtype)
                want = fa.fused_attend_reference(*args, row_mask=mask, compute_dtype=dtype)
                torch.cuda.synchronize()
                where = f"masked fused_attend {dtype} B={B} N={N} da={da} D={D} live={name}"
                for g in got:
                    if not bool((g[~mask].view(torch.int32) == 0).all()):
                        fail(f"{where}: a dead row is not +0.0")
                for g, u in zip(got, unmasked):
                    if not torch.equal(g[mask], u[mask]):
                        fail(f"{where}: live rows differ from the unmasked kernel")
                t1, t2, w2, ctx = args
                rep = fa.agreement(
                    tuple(x[mask] for x in got), tuple(x[mask] for x in want), ctx[mask],
                    fa.reference_logits(t1[mask], t2[mask], w2, dtype), dtype,
                )
                if not rep["ok"]:
                    fail(f"{where}: {rep}")
                errs.append(rep["max_abs_err"])
            print(f"kernel masked fused_attend {dtype} B={B} N={N} da={da} D={D}: live all/one/"
                  f"alternate ok (dead rows +0.0, live rows == unmasked kernel, agreement)", flush=True)
    rows = []
    B, N, da, D, dtype = 48, 196, 512, 512, "bfloat16"
    args = attention_inputs(torch, B, N, da, D, gen)
    for live in (48, 24, 3):
        mask = torch.arange(B, device="cuda") < live
        ms = time_ms(torch, lambda: fa.fused_attend(*args, row_mask=mask, compute_dtype=dtype), flush)
        plain_ms = time_ms(
            torch, lambda: fa.fused_attend_reference(*args, row_mask=mask, compute_dtype=dtype), flush
        )
        bound_ms, bound_by = masked_bound_ms(B, live, N, da, D)
        print(f"kernel masked fused_attend {dtype} B={B} live={live}: kernel {ms * 1e3:.1f} us, "
              f"plain {plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.1f} us ({bound_by}, "
              f"{bound_ms / ms:.1%} of it)", flush=True)
        rows.append(dict(B=B, live=live, dtype=dtype, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
    return rows, max(errs)


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
    continuous_reference(np, config.replace(serve_mode="continuous", serve_slot_pages=2,
                                            serve_page_width=2), vocab, images)


def continuous_reference(np, config, vocab, images):
    """The continuous path at the small float32 size, on the card (masked
    kernel) and on the CPU: 6 requests queued into a 2 × 2 pool."""
    from sat_tpu_torch.ops import fused_attend as fa
    from sat_tpu_torch.serve.batcher import ContinuousBatcher
    from sat_tpu_torch.serve.engine import ServeEngine, load_serving_state

    rows = list(images) + list(images[:2][::-1])
    res = {}
    for dev in ("cuda", "cpu"):
        engine = ServeEngine(config, load_serving_state(config, device=dev)[0], vocab, device=dev)
        batcher = ContinuousBatcher(engine).start()
        before = fa.fused_attend.masked_launches
        try:
            reqs = [batcher.submit(im) for im in rows]
            for r in reqs:
                if not r.done.wait(timeout=300) or r.error is not None:
                    fail(f"reference continuous {dev}: a request failed: {r.error}")
        finally:
            batcher.drain(timeout=60)
        if dev == "cuda" and fa.fused_attend.masked_launches == before:
            fail("reference continuous: the masked kernel was never launched on the card")
        res[dev] = [r.result["captions"] for r in reqs]
    err = 0.0
    for a, b in zip(res["cuda"], res["cpu"]):
        if [c["caption"] for c in a] != [c["caption"] for c in b]:
            fail(f"reference continuous: words differ between cuda and cpu:\n{a}\n{b}")
        err = max([err] + [abs(c["log_prob"] - d["log_prob"]) for c, d in zip(a, b)])
    if not err <= 1e-4:
        fail(f"reference continuous: log-prob max abs err {err:.3e} over 1e-4")
    print(f"reference float32 small model, continuous 2x2 pool, {len(rows)} requests: cuda == cpu "
          f"words, log-prob max abs err {err:.3e} (tol 1e-4)", flush=True)


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


def send_traffic(port: int, bodies):
    """The slices' traffic: 3 requests alone, then a lead request and 3
    (then 31) more sent while it runs.  Returns (replies by shape, each
    image's first reply, wall seconds)."""
    t0 = time.perf_counter()
    alone = [post(port, bodies[i]) for i in range(3)]
    # a lead request and 3 (then 31) more sent while it runs: 4 (then
    # 32) requests, so however the batcher splits them, a batch of
    # 2-4 (bucket 4) forms unless all arrive one by one
    lead4, trio = post_all(port, bodies[0:3], lead=bodies[3])
    lead32, burst = post_all(port, bodies[4:35], lead=bodies[35])
    wall_s = time.perf_counter() - t0
    shapes = dict(alone=alone, trio=trio, burst=burst, leads=[lead4, lead32])
    first = alone + [lead4] + burst + [lead32]  # image i's first reply at index i
    return shapes, first, wall_s


def check_replies(np, config, shapes, where: str):
    for status, payload, _ in [r for rs in shapes.values() for r in rs]:
        if status != 200:
            fail(f"{where}: a request got {status}: {payload}")
        caps = payload["captions"]
        if len(caps) != config.beam_size or not all(
            np.isfinite(c["log_prob"]) and isinstance(c["caption"], str) for c in caps
        ):
            fail(f"{where}: malformed reply {payload}")


def identical_captions(pairs):
    """(images whose caption lists are identical, largest log-prob
    difference between identical captions) over pairs of replies."""
    exact, diff = 0, 0.0
    for x, y in pairs:
        a = [(c["caption"], c["log_prob"]) for c in x["captions"]]
        b = [(c["caption"], c["log_prob"]) for c in y["captions"]]
        if [c for c, _ in a] == [c for c, _ in b]:
            exact += 1
            diff = max([diff] + [abs(p - q) for (_, p), (_, q) in zip(a, b)])
    return exact, diff


def same_words(pairs, where: str) -> float:
    """Fails unless each pair of replies has the same captions; returns
    the largest log-prob difference."""
    exact, diff = identical_captions(pairs)
    if exact != len(pairs):
        fail(f"{where}: {len(pairs) - exact} image(s) caption differently:\n{pairs}")
    return diff


def lane_oracle(torch, np, engine, config, bodies, lanes):
    """Per image, the replies the monolithic search gives on its contexts
    encoded at every (lane width, position) the pool can use, zero rows
    elsewhere (``pool.admit`` pads a lane with zeros).  On the card the
    decode does not depend on the batch geometry; the encode does (cuDNN
    picks other bf16 kernels per batch size), so a continuous reply must
    be bitwise one of these.  Returns (candidates per image, largest
    context difference of one image across lane widths)."""
    from sat_tpu_torch.ops.beam_search import beam_search

    images = [engine.preprocess(b) for b in bodies]
    size = config.image_size
    candidates = [[] for _ in images]
    spread = 0.0
    with torch.inference_mode():
        for lane in lanes:
            for pos in range(lane):
                rows = []
                for im in images:
                    batch = np.zeros((lane, size, size, 3), engine._image_dtype)
                    batch[pos] = im
                    rows.append(engine.encode_images(batch)[pos])
                contexts = torch.stack(rows)
                if lane == lanes[0]:
                    first = contexts
                spread = max(spread, float((contexts - first).abs().max()))
                out = beam_search(engine.decoder_params, config, contexts, engine.eos_id,
                                  valid_size=len(engine.vocabulary.words))
                for i, reply in enumerate(engine.decode_output(out, len(images))):
                    candidates[i].append(reply["captions"])
    return candidates, spread


def print_latency(card: str, where: str, shapes) -> None:
    lat = lambda rs: statistics.median(r[2] for r in rs)  # noqa: E731
    every = [r for rs in shapes.values() for r in rs]
    print(f"{where} p50 request latency on {card}: alone {lat(shapes['alone']):.2f} ms (3), 3 sent "
          f"behind a lead {lat(shapes['trio']):.2f} ms (3), 31 sent behind a lead "
          f"{lat(shapes['burst']):.2f} ms (31), all {lat(every):.2f} ms ({len(every)})", flush=True)


def get_stats(port: int) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=30) as r:
        return json.loads(r.read())


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
        shapes, first, main_s = send_traffic(server.port, bodies)
        launches = fa.fused_attend.launches
        stats = get_stats(server.port)
    finally:
        server.shutdown()
    check_replies(np, config, shapes, "slice")
    alone, trio = shapes["alone"], shapes["trio"]
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
    diff = same_words(pairs, "slice: alone and in a batch")
    print(f"slice: {len(first) + 3} requests in {main_s:.2f}s, buckets {buckets}, fused_attend "
          f"launches {launches}; {len(pairs)} image(s) alone vs in a batch: same captions, "
          f"log-prob max abs diff {diff:.2e}", flush=True)
    print_latency(card, "slice", shapes)
    print(f"slice sample caption (random weights): {alone[0][1]['captions'][0]}", flush=True)
    return engine, launches, bodies, [r[1] for r in first]


def pool_matches_monolithic(torch, np, engine, config, bodies):
    """The stepped decode on the card at full width against the
    monolithic search on the same contexts: 16 images, encoded once,
    decoded as one batch of 48 beam rows and through a 16-slot pool
    (48 rows, masked kernel, K=8 windows).  Words, scores and lengths
    must be bitwise equal."""
    from sat_tpu_torch.ops import beam_search as bs

    n = len(bodies)
    params, eos, valid = engine.decoder_params, engine.eos_id, len(engine.vocabulary.words)
    with torch.inference_mode():
        contexts = engine.encode_images(np.stack([engine.preprocess(b) for b in bodies]))
        mono = bs.beam_search(params, config, contexts, eos, valid_size=valid)
        carry = bs.init_slot_pool(config, n, device=contexts.device)
        every = torch.ones(n, dtype=torch.bool, device=contexts.device)
        carry = bs.init_slots(params, config, carry, contexts,
                              torch.arange(n, device=contexts.device), every)
        for _ in range(config.max_caption_length // 8 + 1):
            carry, _, _ = bs.decode_multi_step(params, config, carry, every, eos, k=8, valid_size=valid)
        if bool(carry.alive.any()):
            fail("pool vs monolithic: a slot still alive after max_caption_length steps")
        got = bs.harvest_slots(carry)
    for name in ("words", "log_scores", "lengths"):
        if not torch.equal(getattr(got, name), getattr(mono, name)):
            fail(f"pool vs monolithic on the same contexts: {name} differ")
    print(f"continuous: {n} images through a {n}-slot pool (masked kernel) == the monolithic "
          f"search on the same contexts (unmasked kernel): words, scores, lengths bitwise", flush=True)


def continuous_phase(torch, np, fa, config, card: str, bodies, batch_first):
    """The flagship checkpoint served in continuous mode, the batch
    slice's traffic, then one full-pool K=8 window profiled."""
    from sat_tpu_torch.data.vocabulary import Vocabulary
    from sat_tpu_torch.serve.engine import ServeEngine, load_serving_state
    from sat_tpu_torch.serve.server import CaptionServer

    state, _ = load_serving_state(config)
    engine = ServeEngine(config, state, Vocabulary(config.vocabulary_size, config.vocabulary_file))
    server = CaptionServer(config, engine, port=0, host="127.0.0.1")
    pool = server.pool
    try:
        server.start()  # warms the slot pool
        fa.fused_attend.launches = fa.fused_attend.masked_launches = 0
        shapes, first, main_s = send_traffic(server.port, bodies)
        masked, unmasked = fa.fused_attend.masked_launches, fa.fused_attend.launches
        stats = get_stats(server.port)
    finally:
        server.shutdown()
    check_replies(np, config, shapes, "continuous")
    block = stats["slot_pool"]
    per_k = block["dispatches_per_k"]
    if not (per_k.get("1", 0) >= 1 and sum(v for k, v in per_k.items() if k != "1") >= 1):
        fail(f"continuous: windows at K=1 and at K>1 must both run, got {per_k}")
    if masked == 0:
        fail("continuous: the masked fused_attend was never launched on the continuous path")
    candidates, spread = lane_oracle(torch, np, engine, config, bodies, pool.lane_widths)
    for i, (_, payload, _) in enumerate(first + shapes["trio"]):
        if payload["captions"] not in candidates[i % len(first)]:
            fail(f"continuous: image {i % len(first)}'s reply is not the monolithic search's on its "
                 f"contexts at any lane: {payload}")
    exact_alone, diff_alone = identical_captions(
        [(shapes["alone"][i][1], shapes["trio"][i][1]) for i in range(3)])
    exact_batch, diff_batch = identical_captions(list(zip(batch_first, [r[1] for r in first])))
    print(f"continuous: {len(first) + 3} requests in {main_s:.2f}s, slot pool {block['pages']}x"
          f"{block['page_width']}, {block['dispatches']} windows ({per_k} by K), {block['steps']} "
          f"decode steps; masked fused_attend launches {masked}, unmasked {unmasked}; window "
          f"iterations run after the pool drained: {masked - block['steps']}", flush=True)
    print(f"continuous: all {len(first) + 3} replies bitwise the monolithic search's on the image's "
          f"contexts at one of the lanes {pool.lane_widths} (one image's contexts differ by up to "
          f"{spread:.3e} across lane widths)", flush=True)
    print(f"continuous: identical captions alone and in the burst: {exact_alone} of 3 (log-prob "
          f"diff {diff_alone:.2e}); identical to the batch slice: {exact_batch} of {len(first)} "
          f"(log-prob diff {diff_batch:.2e}); the rest differ as their contexts do", flush=True)
    print_latency(card, "continuous", shapes)
    pool_matches_monolithic(torch, np, engine, config, bodies[:pool.slots])

    # one steady K=8 window over a full pool, under the profiler
    from torch.profiler import ProfilerActivity, profile

    pool.reset()
    images = [engine.preprocess(b) for b in bodies[:pool.slots]]
    if pool.admit([(im, i) for i, im in enumerate(images)]) != pool.slots:
        fail("continuous profile: the pool did not take a full page set")
    done, steps = pool.multi_step(8)  # settle: the first window after admission
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        done, steps = pool.multi_step(8)
        done.cpu()
        wall_ms = (time.perf_counter() - t0) * 1e3
    pool.reset()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    if busy == 0:
        fail("continuous profile: torch.profiler recorded no device time")
    print(f"profile continuous K=8 window, {pool.slots} slots live (48 beam rows) bf16: wall "
          f"{wall_ms:.2f} ms, {int(steps)} steps, device busy {busy:.2f} ms ({busy / wall_ms:.1%} "
          f"of wall)", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"profile continuous kernel {e.self_device_time_total / 1e3:8.3f} ms x{e.count:<4d} "
              f"{e.key[:90]}", flush=True)
    return masked


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

    t0 = time.perf_counter()
    masked_rows, masked_err = masked_phase(torch, fa)
    phase("masked", t0)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t0 = time.perf_counter()
        reference_phase(torch, np, tmp)
        phase("reference", t0)
        t0 = time.perf_counter()
        config = flagship_config(tmp)
        engine, launches, bodies, batch_first = slice_phase(np, fa, config, card)
        phase("slice", t0)
        t0 = time.perf_counter()
        profile_phase(torch, engine, bodies)
        del engine
        phase("profile", t0)
        t0 = time.perf_counter()
        masked_launches = continuous_phase(
            torch, np, fa, config.replace(serve_mode="continuous"), card, bodies, batch_first
        )
        phase("continuous", t0)

    main_row = next(r for r in rows if (r["B"], r["dtype"]) == (96, "bfloat16"))
    masked_row = next(r for r in masked_rows if r["live"] == 48)
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
    }, {
        "name": "fused_attend_masked",
        "route": "cuda",
        "source": "sat_tpu_torch/csrc/fused_attend.cu",
        "replaces": "sat_tpu/ops/pallas_attention.py:95",
        "launches": masked_launches,
        "max_abs_err": masked_err,
        "ms": masked_row["ms"],
        "kernel_ms": masked_row["ms"],
        "plain_ms": masked_row["plain_ms"],
        "bound_ms": masked_row["bound_ms"],
        "bound_by": masked_row["bound_by"],
        "library_ms": None,
        "shape": "B=48 N=196 da=D=512 bfloat16, 48 rows live (16 slots x beam 3)",
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
