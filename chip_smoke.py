#!/usr/bin/env python3
"""Smoke run of sat_tpu_torch on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases, each fatal on failure:

1. device — a CUDA card must be visible; prints its name and power limit.
2. build  — compiles every ``sat_tpu_torch/csrc/*.cu`` with nvcc (sm_90a).
3. kernel — the CUDA ``fused_attend`` against its plain torch version on
   the card, at the flagship decode shapes (buckets 32, 16, 4 and 1 ×
   beam 3 = 96, 48, 12 and 3 rows, eval's batch 20 × beam 3 = 60 rows
   and the eval-loss step's batch of 20; N=196, da=D=512) and two
   ragged ones,
   in float32 and bfloat16, with a control that a kernel rounding in the
   wrong place fails; times each with CUDA events beside the kernel's
   memory bound, and prints its launch plan (blocks per row, shared
   memory a block).  Then row invariance at full width: one row placed
   at several indices of batches of 1 to 108 rows, masked and unmasked,
   must come out bitwise the same.
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
8a. serve ops — the operations layer: the flagship checkpoint through
   ``python -m sat_tpu_torch.cli --phase serve`` in a fresh process, in
   batch and then continuous mode, with the wedge watchdog (3 s), a 1 s
   heartbeat, ``--trace_export``, ``--blackbox`` and an error-ratio SLO,
   and ``SAT_FI_WEDGE_SERVE_BATCH`` wedging one batch (window): 200s
   with ``X-Request-Id`` echoed and minted, a fast 500 "wedged",
   ``/healthz`` 503 "degraded" then "ok" after the re-warm, the same
   words as before; a ``/profile`` capture while 32 requests flow
   holding the kernel's events (a second POST 409, a bad duration 400);
   ``/stats`` percentiles, ``/metrics`` parsing with ``sat_up 1``, the
   metering identity (attributed device-ms within 5% of the busy
   spans); SIGTERM: exit 0, "serve drained cleanly", ``access.jsonl``
   one record a request with the five phases, the final heartbeat,
   ``trace.json`` one lane a request, no postmortem bundle.  Then
   in-process on the slice's engine: a ``torch.cuda._sleep`` of twice the
   wedge timeout ahead of one batch (the watchdog fires while
   ``/healthz`` answers), and the slice traffic with the telemetry
   registry off and on, in turns (both p50s, the terminal funnel's time).
9. eval — the flagship model on a COCO-format fixture written from a
   seed (48 JPEGs, two captions each from a fixed list; batch 20 and
   ``max_eval_ann_num=96``, so 5 batches, the last with 4 rows of
   padding), two checkpoints: ``python -m sat_tpu_torch.cli --config``
   (phase eval) in a fresh process, then the same with ``--sweep``.
   results.json has one row for each of the 48 images; the seven printed
   scores are finite and in range; the unmasked kernel launched once a
   decode step of every batch and the masked one never (each process
   counts from 0 and reports its counts, decode steps and the seconds of
   decode and scoring).
10. test — ``--phase test`` over 7 JPEGs: results.csv with 7 rows and 7
   captioned ``*_result.jpg``.
11. eval reference — the eval path at the small float32 size through
   ``runtime.evaluate`` (attention maps on) and ``decode_dataset``, on
   the card and on the CPU: the same captions and scores, prob and
   alphas within 1e-4; the card's run launched the kernel, the CPU's not.
12. eval steady — ``decode_dataset`` at full width over 400 JPEGs of
   480 px (20 batches of 20): images/s of two warm passes, then the
   card's busy share of one pass under torch.profiler.
13. shard cache — the eval steady fixture through ``shard_cache="on"``:
   the build timed, then two ``decode_dataset`` passes from the cache,
   their captions and probs bitwise a live pass's, images/s beside it;
   then a shard row rotted (``SAT_FI_CORRUPT_SHARD_ROW``) under
   ``verify_shards="full"``: caught, decoded live, captions unchanged.
14. bulk — ``python -m sat_tpu_torch.cli --phase bulk`` over the steady
   fixture's 400 JPEGs plus one file that is not a JPEG (401 files, two
   shards of 256), the slice's flagship checkpoint and every ``Config``
   default (16 slots x beam 3, depths 1/2/4/8, heartbeat 10 s), each run
   in a fresh process: one row a file with ``beam_size`` finite
   captions, the bad file quarantined and substituted, one ledger line,
   the masked kernel launched and the unmasked not, the heartbeat's
   ``bulk/*`` gauges; a run killed by ``SAT_FI_DIE_AT_STEP`` at half the
   control's decode steps, relaunched: the output directory bitwise the
   control's; a second relaunch: "nothing to do".  Then one shard
   decoded in-process under torch.profiler: the card's busy share.
14a. serve planes — the flagship in-process, telemetry on: (1) the encode
   cache: one image's contexts at widths 1/4/16/32 compared first, then
   36 lone requests over 12 JPEGs in one seeded order, cache off and on,
   in batch and continuous mode: every repeat bitwise its cold reply, on
   against off bitwise if the encoder is width-invariant, else the same
   words and the best log-prob within 1e-3 relative; the hit ratio, the
   gather p50 beside the encode p50, a 4-request burst of a new image =
   1 miss; (2) an encode-tier server (batch) and a decode-tier server
   (continuous): /encode frames caption on both with the image's own
   words, a flipped bit 400, another step 409, the frame's crc timed on
   each side; (3) the lifecycle in continuous mode, manual policy: a
   jittered candidate /reload-ed while requests flow (p50 before and
   during the load), canary ids served by the candidate through the
   clone pool, /promote (the same ids then bitwise the canary's
   replies), a second candidate rolled back and rejected, /healthz's
   lifecycle_state sequence; (4) tenants: X-Model to a resident model
   (a second seeded checkpoint) equal to a server booted on it alone, in
   both modes, the free tenant's third quick request 429 with
   Retry-After and scope tenant; (5) quality on, window 32: 40 requests,
   /quality_reference 200, the /stats quality block, the lone-request
   p50 off and on in turns; ``--phase bulk`` with quality on over the
   steady fixture's first 64 files killed at half its decode steps and
   relaunched: bitwise.  B1 and B2 counted on every part.
14b. route — ``python -m sat_tpu_torch.cli --phase route --num_replicas
   2`` over the flagship checkpoint, once in batch mode (B1 in the
   replicas) and once in continuous mode (B2), replicas on free ports:
   the fleet's boot seconds; every replica's ``/stats`` device
   "cuda:0"; 12 images sent alone (each with its own ``X-Request-Id``)
   with the words one in-process port server gives them alone, then 31
   behind a lead (counted against that server's burst, not required:
   the bf16 encode depends on the batch geometry); p50s beside the
   single server's; each id once in the router's ``access.jsonl`` and
   in exactly one replica's; r1 SIGKILLed in a burst of 32 once it
   holds requests (32 answered 200, at least one retried, the fleet
   view showing r1 unreachable), then respawned by the command the
   fleet spawns it with (``LocalFleet.replica_argv``); ``POST /drain?replica=r0`` (r0 exits, 6 requests all answered
   by r1) and ``/undrain``; SIGTERM: the router exits 0 and no replica
   it started is left.  The replicas' kernel counts come from their
   ``/stats``, read at readiness and at each one's end.
15. train reference — the train path at the small float32 size, dropout
   off: 3 Adam steps on the card and on the CPU from the same weights
   and batch (losses within 1e-5 relative, parameters within 1e-5
   absolute, no kernel launched by a train step); ``fused_attend``
   refusing an input that requires grad on the card; an eval-loss step
   launching the kernel once a decode step, its metrics the CPU's
   within 1e-5 relative.
16. train — the flagship model with ``Config``'s training defaults
   (dropout 0.5/0.3, Adam 1e-4, clip 5, batch 20, frozen CNN, async
   checkpoints) on the eval steady fixture with two captions an image
   (800 pairs): ``python -m sat_tpu_torch.cli --phase train`` in a fresh
   process for 60 steps (checkpoints 20, 40, 60 verify, LAST_GOOD 60,
   finite metrics, the loss falls, no kernel launched); ``--load`` to 80
   (resumes at 60, 80.npz holds 60.npz's names); ``--phase test`` on 7
   JPEGs with 80.npz.
17. train steady — ``runtime.train`` in-process at full width: the median
   of 30 warm steps (each ending in ``torch.cuda.synchronize``),
   training pairs/s, peak memory, FLOPs a step from the shapes against
   989 TFLOP/s bf16; 5 steps under torch.profiler (busy share, top
   kernels); the host time of forward, backward and update apart; one
   eval-loss step at full width launching the kernel T times.  Before
   it, ``torch.cuda.memory_allocated()`` is printed.
16a. supervise — the flagship trained 6 steps through the CLI on a
   40-JPEG fixture (a control), then the same under ``--supervise``
   with ``SAT_FI_WEDGE_AT_STEP=5`` and ``--watchdog 0.2`` (a 5 s step
   deadline): the child aborted with exit 86 and a stack dump, one
   restart from LAST_GOOD 3, LAST_GOOD 6; the max abs difference
   between the two 6.npz printed.

18. resnet50 reference — the small float32 ResNet50 (64 px: N=4,
   D=2048) on the card and on the CPU: contexts within 1e-4 of max|ctx|,
   the same words in batch mode (B1 launched on the card only) and in
   continuous mode (B2).
19. resnet50 serve and bulk — a full-width ResNet50 checkpoint (224 px,
   N=49, D=2048, vocabulary 5000, bf16, running statistics in
   ``batch_stats/``) through phases 6-8's code: the batch slice's
   traffic, one bucket-32 dispatch profiled, continuous mode (each reply's
   best log-prob within 1e-3 relative of the monolithic search's at one
   of the lanes: at D=2048 the decoder's bf16 products are not bitwise
   the same across row counts), the pool against the monolithic search
   on the same 48 rows bitwise; then ``--phase bulk`` over the bulk
   corpus (B2 launched, B1 not).  Kernels B1 and B2 at ResNet50's grid
   run in phases 3 and 4 (B = 96, 60, 48, 3; the pool's 48 with 48, 24
   and 3 rows live; row invariance).
19a. resnet50 serve planes — part (1) of 14a at ResNet50 in continuous
   mode.
20. resnet50 eval and train — ``--phase eval`` through the CLI on phase
   9's fixture (B1 once a decode step); 20 ``--train_cnn`` steps of
   ``runtime.train`` at full width (median warm step, peak memory,
   checkpoints 10 and 20 with moved ``batch_stats/``, the loss falling),
   then ``--phase train --train_cnn --load`` through the CLI from a copy
   holding 10.npz alone: its 20.npz against the uninterrupted run's.
21. import — a layout-exact ``resnet50_no_fc.npy`` written from a seed
   through ``--load_cnn --cnn_model_file`` into a 5-step train (265
   tensors, carried unchanged into 5.npz); that state exported with
   ``export_reference_checkpoint``; ``--phase test --model_file
   exported.npy`` captions 7 JPEGs.
22. encoder_quant — both flagship checkpoints served with
   ``encoder_quant`` off, bf16 and int8: contexts of a bucket-32 batch
   within the JAX package's gate (bf16 0.05, int8 0.10 of max|ctx|),
   caption agreement with ``off`` over 36 images, encode time beside
   ``off``; one int8 conv's int32 accumulators on the card bitwise the
   CPU's; the checkpoint's int8 ``qcnn`` bitwise the incumbent's when
   its whole tree is moved to the card first, when its host tree is
   folded on the card one conv at a time, and through the lifecycle
   loader, with the seconds and the rise of peak device memory of the
   first two.

Prints a ``{"kernels": [...]}`` line (each kernel's launches on the
VGG16 and ResNet50 main paths, its time and bound at both grids), then
as its last line ``{"ok": true, "device": {...}}``.  Exits non-zero
without a card or without the package beside it.

``python3 chip_smoke.py --only route_batch,supervise`` runs the build
and the named phases (spaces in a name become ``_``; an unknown name
fails with the list), with the phases they need before them; it prints
each phase's launches and no kernels or ok line.

Fails when ``SAT_TORCH_DEVICE`` is set: every phase takes the card.

``python3 chip_smoke.py --bench`` runs only the build and a kernel
bench: the kernel at every timed shape beside what bounds it there, the
timing floor (a one-float memset), torch's sum over the same bytes, and
both timed after a flush that reads instead of writes (no dirty lines to
write back); and the host time to enqueue one call.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
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


def time_ms(torch, fn, flush, reps: int = 60, warm: int = 10, read_flush: bool = False) -> float:
    """Median device time of ``reps`` single calls, by CUDA events, with
    the L2 cache flushed before each (the decode loop streams t1 and
    contexts back from device memory every step).  A spin kernel ahead
    of each call keeps the card busy while the host enqueues it, so the
    host's launch overhead stays out of the interval.  The flush writes
    ``flush``, leaving dirty lines the timed call writes back; with
    ``read_flush`` (the bench's comparison) it reads it instead."""
    for _ in range(warm):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        torch.cuda._sleep(1_000_000)  # ~0.5 ms of spinning
        flush.max() if read_flush else flush.zero_()
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
    for (B, N, da, D) in ((48, 196, 512, 512), (5, 7, 24, 40), (3, 196, 512, 512), (48, 49, 512, 2048)):
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
    B, da, dtype = 48, 512, "bfloat16"
    for N, D in ((196, 512), (49, 2048)):
        args = attention_inputs(torch, B, N, da, D, gen)
        for live in (48, 24, 3):
            mask = torch.arange(B, device="cuda") < live
            ms = time_ms(torch, lambda: fa.fused_attend(*args, row_mask=mask, compute_dtype=dtype), flush)
            plain_ms = time_ms(
                torch, lambda: fa.fused_attend_reference(*args, row_mask=mask, compute_dtype=dtype), flush
            )
            bound_ms, bound_by = masked_bound_ms(B, live, N, da, D)
            print(f"kernel masked fused_attend {dtype} B={B} N={N} D={D} live={live}: kernel "
                  f"{ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.1f} us "
                  f"({bound_by}, {bound_ms / ms:.1%} of it)", flush=True)
            rows.append(dict(B=B, N=N, D=D, live=live, dtype=dtype, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by))
    return rows, max(errs)


KERNEL_SHAPES = ((96, 196, 512, 512), (60, 196, 512, 512), (48, 196, 512, 512), (20, 196, 512, 512),
                 (12, 196, 512, 512), (5, 7, 24, 40), (2, 5, 22, 38), (3, 196, 512, 512))
# ResNet50's grid (N=49, D=2048) at batch serve's bucket 32 and eval's
# batch 20 (x beam 3), the pool's 48 rows and bucket 1: attend_plan gives
# 7 rows a block, so the cluster's eighth block owns no position
RESNET50_SHAPES = ((96, 49, 512, 2048), (60, 49, 512, 2048), (48, 49, 512, 2048), (3, 49, 512, 2048))


def kernel_phase(torch, fa):
    """The kernel against its plain version by ``fa.agreement`` (float32:
    elementwise; bfloat16: the same rounded logits up to rare one-ulp
    flips), then a control: the kernel without its bf16 rounding (mode
    float32) held against the bf16 plain version must fail that rule."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    rows = []
    for (B, N, da, D) in KERNEL_SHAPES + RESNET50_SHAPES:
        plan = fa.attend_plan(N, da, D)
        print(f"plan fused_attend N={N} da={da} D={D}: {plan.cluster} blocks a row, "
              f"{plan.smem_bytes} bytes of shared memory a block, {plan._asdict()}", flush=True)
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
    row_invariance(torch, fa)
    row_invariance(torch, fa, N=49, D=2048)
    return rows


def row_invariance(torch, fa, N=196, da=512, D=512):
    """One row at full width placed at the first, middle and last index of
    batches of 1, 3, 48, 96 and 108 rows among other rows, unmasked and
    masked (the row live, the others live or dead at random): its ctx and
    alpha must be bitwise the same every time, in both dtypes.  The slot
    pool's gate (a reply decoded in the 48-row pool is bitwise the
    monolithic search's over 108 rows) rests on this."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    row = attention_inputs(torch, 1, N, da, D, gen)
    cases = 0
    for dtype in ("float32", "bfloat16"):
        want = fa.fused_attend(*row, compute_dtype=dtype)
        for B in (1, 3, 48, 96, 108):
            t1, t2, _, ctx = attention_inputs(torch, B, N, da, D, gen)
            for i in sorted({0, B // 2, B - 1}):
                a1, a2, actx = t1.clone(), t2.clone(), ctx.clone()
                a1[i], a2[i], actx[i] = row[0][0], row[1][0], row[3][0]
                mask = torch.rand(B, generator=gen, device="cuda") < 0.5
                mask[i] = True
                for got in (fa.fused_attend(a1, a2, row[2], actx, compute_dtype=dtype),
                            fa.fused_attend(a1, a2, row[2], actx, row_mask=mask, compute_dtype=dtype)):
                    for x, y in zip(got, want):
                        if not torch.equal(x[i], y[0]):
                            fail(f"row invariance {dtype}: the row at index {i} of B={B} differs "
                                 f"from the row alone")
                    cases += 1
    print(f"kernel row invariance N={N} da={da} D={D}: one row at {cases} places (B = 1, 3, 48, "
          f"96, 108; first, middle, last; unmasked and masked; f32 and bf16): bitwise the same",
          flush=True)


def bench_phase(torch, fa):
    """The kernel at every timed shape beside what bounds it there: the
    timing floor (a one-float memset timed the same way), torch's sum over
    as many floats as the kernel must read, and both again after a flush
    that reads instead of writes; and, at B=96, the host time to enqueue
    one call through the wrapper.  Prints one line a shape and returns
    nothing: a bench, not a check."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    one = torch.zeros(1, device="cuda")
    print(f"bench floor: one 4-byte memset timed the same way {time_ms(torch, one.zero_, flush) * 1e3:.1f} us",
          flush=True)
    cases = [(B, None, dt) for B in (96, 48, 12, 3) for dt in ("float32", "bfloat16")]
    cases += [(48, live, "bfloat16") for live in (48, 24, 3)]
    for B, live, dtype in cases:
        N, da, D = 196, 512, 512
        args = attention_inputs(torch, B, N, da, D, gen)
        mask = None if live is None else torch.arange(B, device="cuda") < live
        fn = lambda: fa.fused_attend(*args, row_mask=mask, compute_dtype=dtype)  # noqa: E731
        if (B, live, dtype) == (96, None, "bfloat16"):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(100):
                fn()
            host_us = (time.perf_counter() - t0) * 1e4
            torch.cuda.synchronize()
            print(f"bench host enqueue a call through fused_attend: {host_us:.1f} us", flush=True)
        us = time_ms(torch, fn, flush) * 1e3
        bound_ms, _ = attention_bound_ms(B, N, da, D) if live is None else masked_bound_ms(B, live, N, da, D)
        # a yardstick for the bytes, not the function: torch's sum over as
        # many floats as the live rows' t1 and contexts
        same_bytes = torch.ones((live or B) * N * (da + D), device="cuda")
        sum_us = time_ms(torch, same_bytes.sum, flush) * 1e3
        clean = [time_ms(torch, f, flush, read_flush=True) * 1e3 for f in (fn, same_bytes.sum)]
        print(f"bench fused_attend {dtype} B={B} live={live if live is not None else B}: {us:.1f} us; "
              f"bound {bound_ms * 1e3:.1f} us; torch sum over the same bytes {sum_us:.1f} us; "
              f"after a read flush: kernel {clean[0]:.1f} us, torch sum {clean[1]:.1f} us", flush=True)


# -- checkpoint + images -----------------------------------------------------

def write_checkpoint(np, config, save_dir: str, step: int, seed: int, bias_shift=None) -> str:
    """Random weights in the JAX package's flat format: glorot-uniform
    convs, uniform(±scale) dense kernels and embedding, zero biases but
    the output biases ``bias_shift`` ({word index: shift}) names; for
    ResNet50 batch-norm scales in [0.9, 1.1] and running statistics as a
    pretrained file holds them (means N(0, 0.1), variances in [0.5, 1.5])."""
    from sat_tpu_torch.data.vocabulary import vocab_fingerprint
    from sat_tpu_torch.resilience import lineage
    from sat_tpu_torch.train.checkpoint import param_shapes

    rng = np.random.default_rng(seed)
    flat = {}
    for name, shape in param_shapes(config).items():
        leaf = name.rsplit("/", 1)[1]
        if leaf == "bias":
            flat[name] = np.zeros(shape, np.float32)
        elif leaf in ("scale", "var"):
            flat[name] = rng.uniform(0.9, 1.1, shape).astype(np.float32) if leaf == "scale" else \
                rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif leaf == "mean":
            flat[name] = rng.normal(0, 0.1, shape).astype(np.float32)
        elif "/cnn/" in name:
            fan_in, fan_out = shape[0] * shape[1] * shape[2], shape[0] * shape[1] * shape[3]
            lim = (6.0 / (fan_in + fan_out)) ** 0.5
            flat[name] = rng.uniform(-lim, lim, shape).astype(np.float32)
        else:
            s = config.fc_kernel_initializer_scale
            flat[name] = rng.uniform(-s, s, shape).astype(np.float32)
    for index, shift in (bias_shift or {}).items():
        flat["params/decoder/decode/fc_2/bias"][index] += shift
    flat["global_step"] = np.asarray(step, np.int32)
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"{step}.npz")
    np.savez(path, **flat)
    lineage.write_sidecar(path, vocab=vocab_fingerprint(config.vocabulary_file, config.vocabulary_size))
    lineage.mark_last_good(save_dir, step)
    return path


def write_vocabulary(np, path: str, size: int, words=()) -> None:
    """``<start>``, '.', then ``words``, then fillers up to ``size``."""
    from sat_tpu_torch.data.vocabulary import Vocabulary

    v = Vocabulary(size)
    v.words = (["<start>", "."] + list(words) + [f"w{i}" for i in range(2, size)])[:size]
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
        vocabulary_file=os.path.join(tmp, "vocabulary.csv"), summary_dir=os.path.join(tmp, "summary"),
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


def slice_phase(np, fa, config, card: str, device=None, where: str = "slice"):
    """Serves with the telemetry registry on, as ``serve()`` does: /stats
    reads its counters."""
    from sat_tpu_torch import telemetry
    from sat_tpu_torch.data.vocabulary import Vocabulary
    from sat_tpu_torch.serve.engine import ServeEngine, load_serving_state
    from sat_tpu_torch.serve.server import CaptionServer

    write_vocabulary(np, config.vocabulary_file, config.vocabulary_size)
    telemetry.enable()
    t0 = time.perf_counter()
    path = write_checkpoint(np, config, config.save_dir, step=1000, seed=SEED)
    print(f"{where} checkpoint {os.path.basename(path)}: {os.path.getsize(path) / 2**20:.0f} MiB "
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
        telemetry.disable()
    check_replies(np, config, shapes, where)
    alone, trio = shapes["alone"], shapes["trio"]
    buckets = {f"bucket_{k}": v for k, v in stats["bucket_histogram"].items()}
    if not (buckets.get("bucket_1", 0) >= 1 and buckets.get("bucket_4", 0) >= 1):
        fail(f"{where}: buckets 1 and 4 must both dispatch, got {buckets}")
    if launches == 0:
        fail(f"{where}: fused_attend was never launched on the main path")
    # images 0-2 went alone first; each that then rode a batch must caption the same
    pairs = [(alone[i][1], trio[i][1]) for i in range(3) if trio[i][1]["bucket"] > 1]
    if not pairs:
        fail(f"{where}: no image sent alone was then served in a batch (buckets {buckets})")
    diff = same_words(pairs, f"{where}: alone and in a batch")
    print(f"{where}: {len(first) + 3} requests in {main_s:.2f}s, buckets {buckets}, fused_attend "
          f"launches {launches}; {len(pairs)} image(s) alone vs in a batch: same captions, "
          f"log-prob max abs diff {diff:.2e}", flush=True)
    print_latency(card, where, shapes)
    print(f"{where} sample caption (random weights): {alone[0][1]['captions'][0]}", flush=True)
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


def closest_candidate(payload, candidates):
    """(the smallest relative difference between the reply's best log-prob
    and a candidate's, whether a candidate has the reply's captions)."""
    best = payload["captions"][0]["log_prob"]
    diff = min(abs(best - cand[0]["log_prob"]) / abs(cand[0]["log_prob"]) for cand in candidates)
    words = [c["caption"] for c in payload["captions"]]
    return diff, any([c["caption"] for c in cand] == words for cand in candidates)


def continuous_phase(torch, np, fa, config, card: str, bodies, batch_first, where: str = "continuous",
                     log_prob_rtol=None):
    """The flagship checkpoint served in continuous mode, the batch
    slice's traffic, then one full-pool K=8 window profiled.  Every reply
    must be bitwise the monolithic search's on the image's contexts at
    one of the pool's lanes.  With ``log_prob_rtol`` (ResNet50), the
    reply's best log-prob within that relative bound of the search's
    there, and the replies with the search's captions counted: at D=2048
    the decoder's bf16 products are not bitwise the same across row
    counts (the pool's 48 rows against the oracle's 108), 20 steps of
    bf16 rounding move a log-prob by a few 1e-4 of itself, and random
    weights leave near-tied beams that then swap.  The pool against the
    monolithic search over the same 48 rows stays bitwise."""
    from sat_tpu_torch import telemetry
    from sat_tpu_torch.data.vocabulary import Vocabulary
    from sat_tpu_torch.serve.engine import ServeEngine, load_serving_state
    from sat_tpu_torch.serve.server import CaptionServer

    telemetry.enable()  # as serve() does: /stats reads its counters
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
        telemetry.disable()
    check_replies(np, config, shapes, where)
    block = stats["slot_pool"]
    per_k = block["dispatches_per_k"]
    if not (per_k.get("1", 0) >= 1 and sum(v for k, v in per_k.items() if k != "1") >= 1):
        fail(f"{where}: windows at K=1 and at K>1 must both run, got {per_k}")
    if masked == 0:
        fail(f"{where}: the masked fused_attend was never launched on the continuous path")
    candidates, spread = lane_oracle(torch, np, engine, config, bodies, pool.lane_widths)
    worst, bitwise, worded = 0.0, 0, 0
    for i, (_, payload, _) in enumerate(first + shapes["trio"]):
        if payload["captions"] in candidates[i % len(first)]:
            bitwise += 1
            continue
        diff, same = closest_candidate(payload, candidates[i % len(first)])
        if log_prob_rtol is None or diff > log_prob_rtol:
            fail(f"{where}: image {i % len(first)}'s reply is not the monolithic search's on its "
                 f"contexts at any lane (best log-prob rel diff {diff:.3e}): {payload}")
        worst, worded = max(worst, diff), worded + same
    if log_prob_rtol is not None:
        n = len(first) + 3
        print(f"{where}: {bitwise} of {n} replies bitwise the monolithic search's at a lane, "
              f"{bitwise + worded} of {n} with its captions; best log-probs within {worst:.3e} relative "
              f"(tol {log_prob_rtol})", flush=True)
    exact_alone, diff_alone = identical_captions(
        [(shapes["alone"][i][1], shapes["trio"][i][1]) for i in range(3)])
    exact_batch, diff_batch = identical_captions(list(zip(batch_first, [r[1] for r in first])))
    print(f"{where}: {len(first) + 3} requests in {main_s:.2f}s, slot pool {block['pages']}x"
          f"{block['page_width']}, {block['dispatches']} windows ({per_k} by K), {block['steps']} "
          f"decode steps; masked fused_attend launches {masked}, unmasked {unmasked}; window "
          f"iterations run after the pool drained: {masked - block['steps']}", flush=True)
    print(f"{where}: all {len(first) + 3} replies the monolithic search's on the image's contexts "
          f"at one of the lanes {pool.lane_widths} (one image's contexts differ by up to "
          f"{spread:.3e} across lane widths)", flush=True)
    print(f"{where}: identical captions alone and in the burst: {exact_alone} of 3 (log-prob "
          f"diff {diff_alone:.2e}); identical to the batch slice: {exact_batch} of {len(first)} "
          f"(log-prob diff {diff_batch:.2e}); the rest differ as their contexts do", flush=True)
    print_latency(card, where, shapes)
    pool_matches_monolithic(torch, np, engine, config, bodies[:pool.slots])

    # one steady K=8 window over a full pool, under the profiler
    from torch.profiler import ProfilerActivity, profile

    pool.reset()
    images = [engine.preprocess(b) for b in bodies[:pool.slots]]
    if pool.admit([(im, i) for i, im in enumerate(images)]) != pool.slots:
        fail(f"{where} profile: the pool did not take a full page set")
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
        fail(f"{where} profile: torch.profiler recorded no device time")
    print(f"profile {where} K=8 window, {pool.slots} slots live (48 beam rows) bf16: wall "
          f"{wall_ms:.2f} ms, {int(steps)} steps, device busy {busy:.2f} ms ({busy / wall_ms:.1%} "
          f"of wall)", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"profile {where} kernel {e.self_device_time_total / 1e3:8.3f} ms x{e.count:<4d} "
              f"{e.key[:90]}", flush=True)
    return masked


def profile_phase(torch, engine, bodies, where: str = "profile"):
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
        fail(f"{where}: torch.profiler recorded no device time")
    print(f"{where} bucket 32 bf16: wall {wall_ms:.2f} ms, {out.steps_run} decode steps, device busy "
          f"{busy:.2f} ms ({busy / wall_ms:.1%} of wall)", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"{where} kernel {e.self_device_time_total / 1e3:8.3f} ms x{e.count:<4d} {e.key[:90]}",
              flush=True)


# -- serve ops phase -----------------------------------------------------------

def http(port: int, method: str, path: str, body: bytes = None, headers=None, timeout: float = 300.0):
    """(status, headers, raw body) of one request to the local server."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def caption(port: int, body: bytes, rid: str = None):
    """(status, reply, X-Request-Id echoed, ms) of one POST /caption."""
    headers = {"Content-Type": "image/jpeg"}
    if rid is not None:
        headers["X-Request-Id"] = rid
    t0 = time.perf_counter()
    status, hdrs, raw = http(port, "POST", "/caption", body, headers)
    return status, json.loads(raw or b"{}"), hdrs.get("X-Request-Id"), (time.perf_counter() - t0) * 1e3


def healthz(port: int):
    status, _, raw = http(port, "GET", "/healthz", timeout=30)
    return status, json.loads(raw)


def wait_healthy(port: int, where: str, limit_s: float = 120.0) -> float:
    """Polls /healthz until 200 "ok"; returns the seconds it took."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < limit_s:
        status, payload = healthz(port)
        if status == 200 and payload["status"] == "ok":
            return time.perf_counter() - t0
        time.sleep(0.05)
    fail(f"{where}: /healthz not back to ok within {limit_s:.0f}s: {payload}")


def parse_metrics(text: str, where: str) -> dict:
    """{'family{labels}': value} of a Prometheus text body; fails on a
    line that does not parse."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        key, _, value = line.rpartition(" ")
        try:
            out[key] = float(value)
        except ValueError:
            fail(f"{where}: /metrics line does not parse: {line!r}")
    return out


def trace_kernels(path: str):
    """Device kernel events of a torch.profiler Chrome trace."""
    with open(path) as f:
        doc = json.load(f)
    return [e for e in doc.get("traceEvents", []) if e.get("cat") in ("kernel", "Kernel")]


def serve_ops_process(np, config, card: str, mode: str, tmp: str, bodies, wedge_at: int):
    """The port's serve through ``python -m sat_tpu_torch.cli --phase
    serve`` in a fresh process with the whole operations layer on and a
    batch (batch mode) or decode window (continuous mode) wedged by
    ``SAT_FI_WEDGE_SERVE_BATCH``; returns its launch tally."""
    where = f"serve ops {mode}"
    root = os.path.join(tmp, f"serve_ops_{mode}")
    tdir = os.path.join(root, "telemetry")
    os.makedirs(root)
    cfg_path = os.path.join(root, "config.json")
    config.replace(serve_mode=mode, telemetry_dir=tdir).save(cfg_path)
    trace_path = os.path.join(root, "trace.json")
    here = os.path.dirname(os.path.abspath(__file__))
    args = ["--config", cfg_path, "--phase", "serve", "--port", "0", "--heartbeat_interval", "1",
            "--trace_export", trace_path, "--blackbox", "--set", "serve_wedge_timeout_ms=3000",
            "--set", "slo_error_ratio=0.5"]
    out_f, err_f = open(os.path.join(root, "stdout"), "w+"), open(os.path.join(root, "stderr"), "w+")
    proc = subprocess.Popen([sys.executable, "-c", CLI_HARNESS, *args], cwd=here, stdout=out_f,
                            stderr=err_f, env={**os.environ, "SAT_FI_WEDGE_SERVE_BATCH": str(wedge_at)})

    def tail():
        err_f.flush()
        err_f.seek(0)
        return err_f.read()[-3000:]

    try:
        t0 = time.perf_counter()
        port = None
        hb = os.path.join(tdir, "heartbeat.json")
        while port is None:
            if proc.poll() is not None:
                fail(f"{where}: the server exited {proc.returncode} before it listened:\n{tail()}")
            if time.perf_counter() - t0 > 300:
                fail(f"{where}: no heartbeat.json with a port in 300s:\n{tail()}")
            try:
                with open(hb) as f:
                    port = json.load(f).get("port")
            except (OSError, ValueError):
                pass
            time.sleep(0.1)
        boot_s = time.perf_counter() - t0
        if healthz(port)[0] != 200:
            fail(f"{where}: /healthz not 200 after boot: {healthz(port)}")
        # requests one at a time until one is wedged
        replies, wedged = [], None
        for i in range(4):
            status, payload, rid, ms = caption(port, bodies[i], rid=f"smoke-{mode}-{i}" if i == 0 else None)
            if status == 500:
                wedged = (i, payload, rid, ms)
                break
            if status != 200:
                fail(f"{where}: request {i} got {status}: {payload}")
            want = f"smoke-{mode}-{i}" if i == 0 else payload["request_id"]
            if rid != want or payload["request_id"] != rid or (i > 0 and len(rid) != 16):
                fail(f"{where}: X-Request-Id {rid!r} not echoed/minted (reply id {payload['request_id']!r})")
            replies.append(payload)
        if wedged is None or not replies:
            fail(f"{where}: expected 200s then a wedged 500, got {len(replies)} 200s, then "
                 f"{wedged}:\n{tail()}")
        i_w, payload, rid, wedge_ms = wedged
        if "wedged" not in payload["error"] or rid is None or wedge_ms > 3000 + 10_000:
            fail(f"{where}: the wedged reply is not a fast 500 'wedged': {payload} in {wedge_ms:.0f} ms")
        # the hook flips health just after the 500s go out (as in sat_tpu)
        t_poll, seen = time.perf_counter(), []
        while time.perf_counter() - t_poll < 10 and not seen:
            status, health = healthz(port)
            if (status, health["status"]) == (503, "degraded"):
                seen.append(time.perf_counter() - t_poll)
        if not seen:
            fail(f"{where}: /healthz never said 503 degraded after the wedge: {status} {health['status']}")
        rewarm_s = wait_healthy(port, where)
        status, again, _, _ = caption(port, bodies[0])
        if status != 200 or again["captions"] != replies[0]["captions"]:
            fail(f"{where}: after the re-warm image 0 captions differently:\n{replies[0]}\n{again}")
        print(f"{where} on {card}: boot {boot_s:.1f}s; {len(replies)} request(s) 200 with X-Request-Id "
              f"echoed and minted; request {i_w} wedged: 500 in {wedge_ms:.0f} ms ({payload['error']!r}); "
              f"/healthz 503 degraded, then ok after a re-warm of {rewarm_s:.2f}s; image 0 after the "
              f"re-warm: bitwise its first reply", flush=True)
        # a capture started (the reply comes once the profiler runs), 32
        # requests sent into it, a second capture refused meanwhile
        status, _, raw = http(port, "POST", "/profile?duration_ms=500")
        flow = {}
        flow_thread = threading.Thread(target=lambda: flow.update(zip(("lead", "rest"), post_all(
            port, bodies[4:35], lead=bodies[35]))))
        flow_thread.start()
        second, _, _ = http(port, "POST", "/profile?duration_ms=500")
        bad, _, _ = http(port, "POST", "/profile?duration_ms=soon")
        flow_thread.join(timeout=600)
        if status != 200 or second != 409 or bad != 400:
            fail(f"{where}: POST /profile gave {status}, then {second} (want 409), bad duration {bad} (want 400)")
        for st, pl, _ in [flow["lead"]] + flow["rest"]:
            if st != 200:
                fail(f"{where}: a request of the flow got {st}: {pl}")
        trace = os.path.join(json.loads(raw)["profile_dir"], "trace.json")
        t_wait = time.perf_counter()
        while time.perf_counter() - t_wait < 60:
            try:
                with open(trace) as f:
                    json.load(f)
                break
            except (OSError, ValueError):  # not written, or still being written
                time.sleep(0.2)
        kernels = trace_kernels(trace)
        # the kernel template's second parameter is MASKED: B1 false, B2 true
        body_name = "true" if mode == "continuous" else "false"
        ours = [e for e in kernels if "fused_attend_kernel<" in e["name"]]
        if not kernels or not ours:
            fail(f"{where}: the /profile capture holds {len(kernels)} kernel events, {len(ours)} of fused_attend")
        names = sorted({e["name"][e["name"].index("fused_attend_kernel<"):].split(">")[0] + ">" for e in ours})
        busy = sum(e.get("dur", 0) for e in kernels) / 1e3
        print(f"{where} profile capture (500 ms while 32 requests flowed): {len(kernels)} kernel events, "
              f"{len(ours)} of fused_attend ({names}; MASKED={body_name} expected), device busy "
              f"{busy:.1f} ms; a second POST 409, a bad duration 400", flush=True)
        if not any(n.split(", ")[1] == body_name for n in names):
            fail(f"{where}: the capture has no fused_attend_kernel<..., {body_name}, ...> events: {names}")
        # artifacts and endpoints
        stats = json.loads(http(port, "GET", "/stats")[2])
        lat = stats["latency_ms"].get("serve/request")
        if not lat or not all(k in lat for k in ("p50", "p95", "p99")):
            fail(f"{where}: /stats has no serve/request percentiles: {stats['latency_ms']}")
        if mode == "continuous" and stats["slot_pool"]["busy"] != 0:
            fail(f"{where}: slots still busy after the flow: {stats['slot_pool']}")
        metrics = parse_metrics(http(port, "GET", "/metrics")[2].decode(), where)
        if metrics.get("sat_up") != 1.0:
            fail(f"{where}: /metrics has no 'sat_up 1'")
        busy_ms = sum(metrics.get(f'sat_span_seconds_sum{{span="{n}"}}', 0.0)
                      for n in ("serve/encode", "serve/step", "serve/decode_window")) * 1e3
        attributed = metrics.get('sat_counter_total{name="metering/default/device_ms"}', 0.0)
        if not busy_ms > 0 or abs(attributed - busy_ms) > 0.05 * busy_ms:
            fail(f"{where}: metering identity broken: attributed {attributed:.3f} ms vs measured busy "
                 f"{busy_ms:.3f} ms")
        n_requests = len(replies) + 2 + 32
        print(f"{where}: /stats serve/request p50 {lat['p50']} ms p95 {lat['p95']} ms p99 {lat['p99']} ms "
              f"over {lat['count']}; metering: attributed device {attributed:.1f} ms vs measured busy "
              f"{busy_ms:.1f} ms ({(attributed - busy_ms) / busy_ms:+.2e} relative; tol 5%); /metrics "
              f"{len(metrics)} samples, sat_up 1", flush=True)
        phases = {k: stats["latency_ms"][k]["p50"] for k in stats["latency_ms"]}
        print(f"{where}: span p50s (ms) {phases}", flush=True)
        proc.send_signal(__import__("signal").SIGTERM)
        try:
            rc = proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            fail(f"{where}: SIGTERM did not end the server in 120s")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out_f.flush()
    out_f.seek(0)
    stdout = out_f.read()
    err = tail()
    if rc != 0 or "serve drained cleanly" not in err:
        fail(f"{where}: SIGTERM exit {rc}, 'serve drained cleanly' missing:\n{err}")
    last = stdout.strip().splitlines()[-1] if stdout.strip() else ""
    tally = json.loads(last[len("chip_smoke counts "):])
    with open(os.path.join(tdir, "access.jsonl")) as f:
        records = [json.loads(line) for line in f]
    if len(records) != n_requests or not all(
            set(r["phases"]) == {f"{p}_ms" for p in ("queue_wait", "batch_form", "dispatch", "drain", "detok")}
            for r in records):
        fail(f"{where}: access.jsonl holds {len(records)} records for {n_requests} requests, or a record "
             f"lacks a phase")
    with open(os.path.join(tdir, "heartbeat.json")) as f:
        beat = json.load(f)
    if beat.get("serve", {}).get("ready") != 0 or beat["counters"].get("serve/completed") != n_requests - 1:
        fail(f"{where}: heartbeat.json is not the final beat: serve {beat.get('serve')}, completed "
             f"{beat['counters'].get('serve/completed')} (want {n_requests - 1})")
    with open(trace_path) as f:
        lanes = [e for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "request" and e["name"].startswith("request ")]
    if len(lanes) != n_requests:
        fail(f"{where}: trace.json has {len(lanes)} request lanes for {n_requests} requests")
    bundles = [d for d in os.listdir(tdir) if d.startswith("postmortem_")]
    if bundles:
        fail(f"{where}: a postmortem bundle on a clean exit: {bundles}")
    launches = tally["masked"] if mode == "continuous" else tally["launches"]
    if launches == 0:
        fail(f"{where}: the {'masked' if mode == 'continuous' else 'unmasked'} fused_attend never launched")
    print(f"{where}: SIGTERM → exit 0, 'serve drained cleanly'; access.jsonl {len(records)} records with "
          f"the five phases; final heartbeat (ready 0, {n_requests - 1} completed); trace.json "
          f"{len(lanes)} request lanes; no postmortem bundle; fused_attend launches {tally['launches']}, "
          f"masked {tally['masked']}", flush=True)
    return tally


def device_stall(torch, np, engine, config, card: str, bodies):
    """A real stall in-process: the batch engine's device region enqueues
    a spin of about twice the wedge timeout before its work.  The
    watchdog must fire while the card is busy, /healthz must answer
    during the stall, and the server must come back ok."""
    from sat_tpu_torch.serve.server import CaptionServer

    where = "serve ops device stall"
    wedge_ms = 3000.0
    cycles = int(2 * wedge_ms / 1e3 * torch.cuda.get_device_properties(0).clock_rate * 1e3)
    encode_batch = engine.encode_batch
    armed = [True]

    def stalled(images, *args, **kwargs):
        if armed[0]:
            armed[0] = False
            torch.cuda._sleep(cycles)
        return encode_batch(images, *args, **kwargs)

    engine.encode_batch = stalled
    server = CaptionServer(config.replace(serve_wedge_timeout_ms=wedge_ms, heartbeat_interval=0.0,
                                          telemetry_dir=os.path.join(os.path.dirname(config.save_dir),
                                                                     "stall_telemetry")),
                           engine, port=0, host="127.0.0.1")
    try:
        server.start()
        box = {}
        t0 = time.perf_counter()
        th = threading.Thread(target=lambda: box.update(reply=caption(server.port, bodies[0])))
        th.start()
        answered = []
        while th.is_alive():
            t = time.perf_counter()
            status, payload = healthz(server.port)
            answered.append(((t - t0) * 1e3, (time.perf_counter() - t) * 1e3, status, payload["status"]))
            time.sleep(0.25)
        status, payload, _, ms = box["reply"]
        if status != 500 or "wedged" not in payload.get("error", ""):
            fail(f"{where}: the stalled batch got {status}: {payload}")
        during = [a for a in answered if a[0] < wedge_ms]
        if not during or max(a[1] for a in answered) > 1000:
            fail(f"{where}: /healthz did not answer promptly during the stall: {answered}")
        if not any(a[2:] == (503, "degraded") for a in answered) and healthz(server.port)[0] != 503:
            fail(f"{where}: /healthz never said 503 degraded: {answered}")
        rewarm_s = wait_healthy(server.port, where)
        status, payload, _, _ = caption(server.port, bodies[0])
        if status != 200:
            fail(f"{where}: after the re-warm a request got {status}: {payload}")
    finally:
        server.shutdown()
        engine.encode_batch = encode_batch
    print(f"{where} on {card}: a {cycles / 1e9:.1f}e9-cycle spin ahead of the batch; the watchdog "
          f"failed it with 500 after {ms:.0f} ms (timeout {wedge_ms:.0f} ms); /healthz answered "
          f"{len(answered)} polls during the stall (slowest {max(a[1] for a in answered):.1f} ms, "
          f"{len(during)} before the timeout); ok again after {rewarm_s:.2f}s; then a request 200",
          flush=True)


def layer_overhead(torch, np, engine, config, card: str, bodies):
    """The same traffic (3 alone, 3 and 31 behind a lead) in turns with
    the telemetry registry off and with it on and the whole operations
    layer (tracer, metering, capacity, an SLO, heartbeat, trace export),
    twice each; the p50s and the layer's host time a request."""
    from sat_tpu_torch import telemetry
    from sat_tpu_torch.serve.server import CaptionServer

    where = "serve ops overhead"
    runs = {"off": [], "on": []}
    funnel_ns = []
    finish = CaptionServer._finish_request

    def timed_finish(self, *a, **k):
        t = time.perf_counter_ns()
        try:
            return finish(self, *a, **k)
        finally:
            funnel_ns.append(time.perf_counter_ns() - t)

    root = os.path.join(os.path.dirname(config.save_dir), "overhead")
    CaptionServer._finish_request = timed_finish
    try:
        for turn, state in enumerate(("off", "on", "off", "on")):
            if state == "on":
                telemetry.enable()
                cfg = config.replace(heartbeat_interval=1.0, slo_serve_p99_ms=1000.0, slo_error_ratio=0.5,
                                     trace_export=os.path.join(root, f"trace{turn}.json"),
                                     telemetry_dir=os.path.join(root, f"on{turn}"))
            else:
                telemetry.disable()
                cfg = config.replace(telemetry_dir=os.path.join(root, f"off{turn}"))
            engine._tel = telemetry.get()
            server = CaptionServer(cfg, engine, port=0, host="127.0.0.1")
            try:
                server.start()
                del funnel_ns[:]
                shapes, _, _ = send_traffic(server.port, bodies)
                # send_traffic sends its 3 lone requests first, one at a time
                runs[state].append((shapes, funnel_ns[:3]))
            finally:
                server.shutdown()
    finally:
        CaptionServer._finish_request = finish
        telemetry.disable()
        engine._tel = telemetry.get()
    for state in ("off", "on"):
        for shapes, _ in runs[state]:
            check_replies(np, config, shapes, where)
    p50 = {s: {k: statistics.median(r[2] for shapes, _ in runs[s] for r in shapes[k]) for k in ("alone", "burst")}
           for s in runs}
    funnel_us = {s: statistics.median(f for _, fs in runs[s] for f in fs) / 1e3 for s in runs}
    print(f"{where} on {card} (2 turns each, in turns): p50 alone off {p50['off']['alone']:.2f} ms, on "
          f"{p50['on']['alone']:.2f} ms ({p50['on']['alone'] / p50['off']['alone'] - 1:+.1%}); p50 of 31 "
          f"behind a lead off {p50['off']['burst']:.2f} ms, on {p50['on']['burst']:.2f} ms "
          f"({p50['on']['burst'] / p50['off']['burst'] - 1:+.1%}); a lone request's terminal funnel (access "
          f"log; on: + ledger, capacity) off {funnel_us['off']:.1f} us, on {funnel_us['on']:.1f} us: "
          f"{funnel_us['on'] / 1e3 / p50['on']['alone']:.3%} of its p50", flush=True)


def serve_ops_phase(torch, np, engine, config, card: str, bodies):
    """The operations layer: both modes through the CLI in fresh
    processes, then a real device stall and the layer's overhead
    in-process on the slice's engine.  Returns (B1 launches, B2
    launches) of the two processes."""
    tmp = os.path.dirname(config.save_dir)
    batch = serve_ops_process(np, config, card, "batch", tmp, bodies, wedge_at=3)
    cont = serve_ops_process(np, config, card, "continuous", tmp, bodies, wedge_at=4)
    device_stall(torch, np, engine, config, card, bodies)
    layer_overhead(torch, np, engine, config, card, bodies)
    return batch["launches"] + cont["launches"], batch["masked"] + cont["masked"]


# -- eval and test phases ------------------------------------------------------

# The eval fixture's ground truth: two captions an image, cycled.
EVAL_CAPTIONS = (
    "a man riding a horse on the beach.", "a group of people standing around a kitchen.",
    "two dogs playing with a red ball in the grass.", "a plate of food with rice and vegetables.",
    "a bus driving down a city street.", "a cat sitting on top of a wooden table.",
    "a woman holding an umbrella in the rain.", "a young boy throwing a frisbee in the park.",
    "several boats floating in the harbor near the dock.", "a train traveling down the tracks.",
    "a bird perched on a branch of a tree.", "a pizza with cheese and tomatoes on a plate.",
)
METRICS = ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr")

# Runs the port's CLI in a fresh process, counting what the eval path
# launched and how many batches and decode steps it ran, and timing the
# decode and the scoring; prints the tally as its last line.
CLI_HARNESS = r"""
import json, sys, time
from sat_tpu_torch import cli, runtime
from sat_tpu_torch.evalcap.eval import CocoEvalCap
from sat_tpu_torch.ops import beam_search as bs
from sat_tpu_torch.ops import fused_attend as fa

tally = {"batches": 0, "steps": 0, "decode_s": [], "score_s": []}
sealed, decode_batch = bs._sealed, runtime.decode_batch

def counted_sealed(*a):  # called once per decode step of the search
    tally["steps"] += 1
    return sealed(*a)

def counted_batch(*a, **k):
    tally["batches"] += 1
    return decode_batch(*a, **k)

def timed(fn, key):
    def run(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            tally[key].append(time.perf_counter() - t0)
    return run

bs._sealed = counted_sealed
runtime.decode_batch = counted_batch
runtime.decode_dataset = timed(runtime.decode_dataset, "decode_s")
CocoEvalCap.evaluate = timed(CocoEvalCap.evaluate, "score_s")
fa.fused_attend.launches = fa.fused_attend.masked_launches = 0
try:
    rc = cli.main(sys.argv[1:])
finally:
    tally.update(launches=fa.fused_attend.launches, masked=fa.fused_attend.masked_launches)
    print("chip_smoke counts " + json.dumps(tally), flush=True)
sys.exit(rc)
"""


def write_coco_fixture(np, root: str, n_images: int, seed: int, size: int = 256):
    """``n_images`` JPEGs of ``size`` px made with numpy and a COCO caption
    JSON, two captions an image; returns (image dir, caption file)."""
    image_dir = os.path.join(root, "images")
    os.makedirs(image_dir, exist_ok=True)
    images, annotations = [], []
    for i, body in enumerate(jpegs(np, n_images, size, seed)):
        name = f"COCO_smoke_{i:012d}.jpg"
        with open(os.path.join(image_dir, name), "wb") as f:
            f.write(body)
        images.append({"id": i + 1, "file_name": name})
        for j in range(2):
            annotations.append({"id": 1000 + 2 * i + j, "image_id": i + 1,
                                "caption": EVAL_CAPTIONS[(i + j) % len(EVAL_CAPTIONS)]})
    caption_file = os.path.join(root, "captions.json")
    with open(caption_file, "w") as f:
        json.dump({"images": images, "annotations": annotations}, f)
    return image_dir, caption_file


def caption_words():
    from sat_tpu_torch.data.tokenizer import tokenize

    words = []
    for c in EVAL_CAPTIONS:
        words += [w for w in tokenize(c) if w != "." and w not in words]
    return words


def run_cli(args, where: str, timeout: int = 600, rc: int = 0, env=None):
    """``sat_tpu_torch.cli`` with ``args`` in a fresh process (``env`` added
    to this one's); returns (its tally, its standard output), the tally
    holding the wall seconds and the end of standard error.  Fails on an
    exit code other than ``rc``."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", CLI_HARNESS, *args], cwd=here,
                         capture_output=True, text=True, timeout=timeout,
                         env=None if env is None else {**os.environ, **env})
    wall = time.perf_counter() - t0
    if out.returncode != rc:
        fail(f"{where}: python -m sat_tpu_torch.cli {' '.join(args)} exited {out.returncode}, "
             f"expected {rc}:\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    last = out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ""
    if not last.startswith("chip_smoke counts "):
        fail(f"{where}: no tally line:\n{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
    tally = json.loads(last[len("chip_smoke counts "):])
    tally["wall_s"] = wall
    tally["stderr"] = out.stderr[-4000:]
    return tally, out.stdout


def check_tally(tally, where: str, batches: int):
    """The kernel ran once a decode step, on every batch, and the masked
    body never."""
    if tally["batches"] != batches:
        fail(f"{where}: {tally['batches']} batches decoded, expected {batches}")
    if not batches <= tally["steps"] <= 20 * batches:
        fail(f"{where}: {tally['steps']} decode steps over {batches} batches")
    if tally["launches"] != tally["steps"]:
        fail(f"{where}: fused_attend launched {tally['launches']} times over {tally['steps']} decode "
             f"steps ({batches} batches): the kernel did not run once a step")
    if tally["masked"] != 0:
        fail(f"{where}: the masked fused_attend ran {tally['masked']} times on the monolithic path")


def printed_scores(np, stdout: str, where: str):
    """The last ``name: value`` line of each metric; each finite, BLEU,
    METEOR and ROUGE_L in [0, 1], CIDEr >= 0."""
    scores = {}
    for line in stdout.splitlines():
        name, _, value = line.partition(": ")
        if name in METRICS:
            scores[name] = float(value)
    if sorted(scores) != sorted(METRICS):
        fail(f"{where}: printed scores {scores}, expected {METRICS}")
    for k, v in scores.items():
        if not np.isfinite(v) or v < 0 or (k != "CIDEr" and v > 1):
            fail(f"{where}: {k} = {v} out of range")
    return scores


def eval_config(tmp: str):
    """The flagship model (``flagship_config``) on the eval fixture: batch
    20, 96 annotation ids over 48 images, so 5 batches, the last with 16
    images and 4 rows of padding."""
    image_dir, caption_file = os.path.join(tmp, "eval", "images"), os.path.join(tmp, "eval", "captions.json")
    return flagship_config(tmp).replace(
        phase="eval", save_dir=os.path.join(tmp, "eval", "models"),
        vocabulary_file=os.path.join(tmp, "eval", "vocabulary.csv"),
        eval_image_dir=image_dir, eval_caption_file=caption_file,
        eval_result_file=os.path.join(tmp, "eval", "results.json"),
        eval_result_dir=os.path.join(tmp, "eval", "results"),
        batch_size=20, max_eval_ann_num=96,
        test_image_dir=os.path.join(tmp, "test", "images"),
        test_result_dir=os.path.join(tmp, "test", "results"),
        test_result_file=os.path.join(tmp, "test", "results.csv"),
    )


def eval_phase(np, config, card: str):
    """``--phase eval`` on the newest checkpoint, then ``--sweep`` over
    both, each through the CLI in its own process.  Returns the B1
    launches of the two runs."""
    write_coco_fixture(np, os.path.dirname(config.eval_image_dir), 48, SEED + 40)
    words = caption_words()
    write_vocabulary(np, config.vocabulary_file, config.vocabulary_size, words)
    # the ground truth's words favoured, so captions share words with it
    # and every metric has matches to count
    favour = {i: 4.0 for i in range(2, 2 + len(words))}
    for step, seed in ((1000, SEED + 41), (2000, SEED + 42)):
        write_checkpoint(np, config, config.save_dir, step=step, seed=seed, bias_shift=favour)
    path = os.path.join(os.path.dirname(config.save_dir), "eval.json")
    config.save(path)

    tally, stdout = run_cli(["--config", path], "eval")
    check_tally(tally, "eval", batches=5)
    scores = printed_scores(np, stdout, "eval")
    with open(config.eval_result_file) as f:
        rows = json.load(f)
    if sorted(r["image_id"] for r in rows) != list(range(1, 49)):
        fail(f"eval: results.json has {len(rows)} rows, not one for each of the 48 images")
    decode_s, score_s = tally["decode_s"][0], tally["score_s"][0]
    print(f"eval flagship bf16 on {card}: 48 images (96 ids, 5 batches of 20) in {tally['wall_s']:.2f}s "
          f"(process start to exit); decode {decode_s:.3f}s ({48 / decode_s:.1f} images/s, first use "
          f"in the process), scoring {score_s:.3f}s; {tally['steps']} decode steps, fused_attend "
          f"launches {tally['launches']}, masked {tally['masked']}", flush=True)
    print(f"eval scores (random weights): {scores}", flush=True)
    print(f"eval sample caption (random weights): {rows[0]}", flush=True)

    sweep, stdout = run_cli(["--config", path, "--sweep"], "eval sweep")
    check_tally(sweep, "eval sweep", batches=10)
    steps = [line.split(":")[0] for line in stdout.splitlines() if line.startswith("step ")]
    if steps != ["step 1000", "step 2000"]:
        fail(f"eval sweep: printed {steps}, expected steps 1000 and 2000")
    for step in (1000, 2000):
        if not os.path.exists(os.path.join(config.save_dir, f"{step}.txt")):
            fail(f"eval sweep: no {step}.txt score dump")
    warm = sweep["decode_s"][1]
    print(f"eval sweep on {card}: 2 checkpoints in {sweep['wall_s']:.2f}s; decode {sweep['decode_s'][0]:.3f} / "
          f"{warm:.3f}s ({48 / warm:.1f} images/s on the second, warm), scoring "
          f"{sweep['score_s'][0]:.3f} / {sweep['score_s'][1]:.3f}s; fused_attend launches "
          f"{sweep['launches']} over {sweep['steps']} steps", flush=True)
    return tally["launches"] + sweep["launches"]


def test_phase(np, config, card: str):
    """``--phase test`` over 7 JPEGs: results.csv with 7 rows and a
    captioned JPEG for each.  Returns the B1 launches."""
    import csv

    os.makedirs(config.test_image_dir, exist_ok=True)
    for i, body in enumerate(jpegs(np, 7, 300, SEED + 43)):
        with open(os.path.join(config.test_image_dir, f"photo_{i}.jpg"), "wb") as f:
            f.write(body)
    path = os.path.join(os.path.dirname(config.test_image_dir), "test.json")
    config.replace(phase="test").save(path)
    tally, _ = run_cli(["--config", path], "test")
    check_tally(tally, "test", batches=1)
    with open(config.test_result_file, newline="") as f:
        rows = list(csv.DictReader(f))
    if len(rows) != 7 or not all(r["caption"] and float(r["prob"]) >= 0 for r in rows):
        fail(f"test: results.csv has {len(rows)} rows, expected 7 captioned: {rows}")
    rendered = sorted(n for n in os.listdir(config.test_result_dir) if n.endswith("_result.jpg"))
    if rendered != [f"photo_{i}_result.jpg" for i in range(7)]:
        fail(f"test: captioned JPEGs {rendered}")
    print(f"test flagship bf16 on {card}: 7 JPEGs in {tally['wall_s']:.2f}s (decode "
          f"{tally['decode_s'][0]:.3f}s), results.csv 7 rows, 7 captioned JPEGs; fused_attend "
          f"launches {tally['launches']} over {tally['steps']} steps", flush=True)
    return tally["launches"]


def eval_reference_phase(np, config):
    """The eval path at the small float32 size through ``runtime.evaluate``
    (attention maps on) and ``decode_dataset``, on the card and on the
    CPU: identical captions and scores, prob within 1e-4 relative, alphas
    within 1e-4."""
    from sat_tpu_torch import runtime
    from sat_tpu_torch.data.dataset import prepare_eval_data
    from sat_tpu_torch.ops import fused_attend as fa

    small = config.replace(
        image_size=32, dim_embedding=16, num_lstm_units=16, dim_initialize_layer=16,
        dim_attend_layer=16, dim_decode_layer=32, vocabulary_size=50, compute_dtype="float32",
        save_attention_maps=True, save_dir=os.path.join(os.path.dirname(config.save_dir), "small"),
        vocabulary_file=os.path.join(os.path.dirname(config.save_dir), "small.csv"),
    )
    write_vocabulary(np, small.vocabulary_file, small.vocabulary_size, caption_words())
    # the terminator's logit lowered: full-length captions, not ""
    path = write_checkpoint(np, small, small.save_dir, step=1, seed=SEED + 44, bias_shift={1: -2.0})
    res, launched = {}, {}
    for dev in ("cuda", "cpu"):
        cfg = small.replace(eval_result_file=os.path.join(small.save_dir, f"{dev}.json"),
                            eval_result_dir=os.path.join(small.save_dir, dev))
        before = fa.fused_attend.launches
        scores = runtime.evaluate(cfg, model_file=path, device=dev)
        launched[dev] = fa.fused_attend.launches - before
        with open(cfg.eval_result_file) as f:
            captions = json.load(f)
        state = runtime.setup_state(cfg, model_file=path, device=dev)
        _, dataset, vocab = prepare_eval_data(cfg)
        rows = runtime.decode_dataset(cfg, state, dataset, vocab, device=dev)
        res[dev] = (scores, captions, rows, sorted(os.listdir(cfg.eval_result_dir)))
    (gs, gc, gr, gf), (cs, cc, cr, cf) = res["cuda"], res["cpu"]
    if launched["cuda"] < 2 or launched["cpu"] != 0:
        fail(f"eval reference: fused_attend launched {launched['cuda']} times on cuda, "
             f"{launched['cpu']} on cpu")
    if gc != cc:
        fail(f"eval reference: captions differ between cuda and cpu:\n{gc[:3]}\n{cc[:3]}")
    if gs != cs:
        fail(f"eval reference: scores differ between cuda and cpu: {gs} vs {cs}")
    if gf != cf or not any(n.endswith("_attention.jpg") for n in gf):
        fail(f"eval reference: attention artifacts differ: {gf} vs {cf}")
    prob = max(abs(a["prob"] - b["prob"]) / b["prob"] for a, b in zip(gr, cr))
    alpha = max(float(np.abs(a["alphas"] - b["alphas"]).max()) for a, b in zip(gr, cr))
    if not (prob <= 1e-4 and alpha <= 1e-4):
        fail(f"eval reference: prob rel err {prob:.3e} or alpha err {alpha:.3e} over 1e-4")
    print(f"eval reference float32 small model, {len(gc)} images: cuda == cpu captions and scores "
          f"({gs}), prob max rel err {prob:.3e} (tol 1e-4), alpha max abs err {alpha:.3e} (tol 1e-4); "
          f"sample caption {gc[0]}", flush=True)


def steady_config(config):
    """``config`` on the eval steady fixture (written by that phase)."""
    root = os.path.join(os.path.dirname(os.path.dirname(config.eval_image_dir)), "steady")
    return config.replace(eval_image_dir=os.path.join(root, "images"),
                          eval_caption_file=os.path.join(root, "captions.json"), max_eval_ann_num=None,
                          shard_cache_dir=os.path.join(root, "shards"))


STEADY_IMAGES = 400   # 20 eval batches of 20
STEADY_SIZE = 480     # px a side: COCO's photos are 640 x 480


def eval_steady_phase(torch, np, config, card: str):
    """``decode_dataset`` as ``runtime.evaluate`` runs it (uint8 images
    from the prefetching loader, the pinned host→device feed, the mean
    subtracted on the card), over a fixture of 400 JPEGs: one pass to
    settle cuDNN and the allocator, two timed passes (images/s over all
    20 batches, the loader's fill before the first included), then one
    pass under torch.profiler: the card's busy share of its wall time and
    the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    from sat_tpu_torch import runtime
    from sat_tpu_torch.data.dataset import prepare_eval_data

    config = steady_config(config)
    write_coco_fixture(np, os.path.dirname(config.eval_image_dir), STEADY_IMAGES, SEED + 45, size=STEADY_SIZE)
    state = runtime.setup_state(config, load=True, device="cuda")
    _, dataset, vocab = prepare_eval_data(config)
    batches = dataset.num_batches

    def decode():
        t0 = time.perf_counter()
        rows = runtime.decode_dataset(config, state, dataset, vocab, device="cuda")
        torch.cuda.synchronize()
        if len(rows) != STEADY_IMAGES:
            fail(f"eval steady: {len(rows)} rows for {STEADY_IMAGES} images")
        return time.perf_counter() - t0

    decode()
    walls = [decode(), decode()]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled = decode()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    if busy == 0:
        fail("eval steady: torch.profiler recorded no device time")
    rates = ", ".join(f"{w:.3f}s = {STEADY_IMAGES / w:.1f} images/s" for w in walls)
    print(f"eval steady flagship bf16 on {card}: decode_dataset over {STEADY_IMAGES} JPEGs of "
          f"{STEADY_SIZE} px ({batches} batches of {config.batch_size}, {config.num_data_workers} decode "
          f"threads), two warm passes: {rates}", flush=True)
    print(f"profile eval steady on {card}: wall {profiled:.3f}s under the profiler, device busy "
          f"{busy:.3f}s ({busy / profiled:.1%} of that wall, {busy / min(walls):.1%} of the faster "
          f"unprofiled pass)", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"profile eval kernel {e.self_device_time_total / 1e3:8.3f} ms x{e.count:<5d} {e.key[:90]}",
              flush=True)


def shard_cache_phase(torch, np, config, card: str):
    """``decode_dataset`` over the eval steady fixture from the shard cache:
    ``shard_cache="on"`` builds it (timed), then two passes from it, whose
    captions and probs must be bitwise a live pass's, images/s beside the
    live pass's; then row 3 of the first shard rotted
    (``SAT_FI_CORRUPT_SHARD_ROW``) under ``verify_shards="full"``: the rot
    detected, the row decoded live, the captions unchanged."""
    from sat_tpu_torch import runtime, telemetry
    from sat_tpu_torch.data.dataset import prepare_eval_data
    from sat_tpu_torch.data.shards import resolve_shard_cache

    config = steady_config(config)
    state = runtime.setup_state(config, load=True, device="cuda")
    _, dataset, vocab = prepare_eval_data(config)

    def decode(cfg):
        t0 = time.perf_counter()
        rows = runtime.decode_dataset(cfg, state, dataset, vocab, device="cuda")
        torch.cuda.synchronize()
        if len(rows) != STEADY_IMAGES:
            fail(f"shard cache: {len(rows)} rows for {STEADY_IMAGES} images")
        return [(r["image_file"], r["caption"], r["prob"]) for r in rows], time.perf_counter() - t0

    live = config.replace(shard_cache="off")
    decode(live)
    want, live_s = decode(live)
    t0 = time.perf_counter()
    cache = resolve_shard_cache(config.replace(shard_cache="on"), dataset.image_files)
    build_s = time.perf_counter() - t0
    if cache is None or len(cache) != STEADY_IMAGES:
        fail(f"shard cache: the build covers {0 if cache is None else len(cache)} of {STEADY_IMAGES} images")
    cached = []
    for _ in range(2):
        got, wall = decode(config.replace(shard_cache="on"))
        if got != want:
            diff = sum(a != b for a, b in zip(got, want))
            fail(f"shard cache: {diff} of {STEADY_IMAGES} captions or probs differ from the live pass")
        cached.append(wall)
    os.environ["SAT_FI_CORRUPT_SHARD_ROW"] = "3"
    tel = telemetry.enable()
    try:
        got, rot_s = decode(config.replace(shard_cache="on", verify_shards="full"))
        counters = tel.counters()
    finally:
        del os.environ["SAT_FI_CORRUPT_SHARD_ROW"]
        telemetry.disable()
    if counters.get("data/corrupt_rows", 0) < 1 or counters.get("data/decode_fallback", 0) < 1:
        fail(f"shard cache: the rotted row was not caught and decoded live: {counters}")
    if got != want:
        fail("shard cache: captions over the rotted cache differ from the live pass")
    print(f"shard cache on {card}: built over {STEADY_IMAGES} JPEGs of {STEADY_SIZE} px in {build_s:.2f}s "
          f"({STEADY_IMAGES / build_s:.1f} images/s, {len(cache._shard_files)} shard(s)); decode_dataset "
          f"live {live_s:.3f}s = {STEADY_IMAGES / live_s:.1f} images/s, from the cache "
          + ", ".join(f"{w:.3f}s = {STEADY_IMAGES / w:.1f} images/s" for w in cached)
          + "; captions and probs bitwise the live pass's", flush=True)
    print(f"shard cache rot on {card}: verify_shards=full caught {counters['data/corrupt_rows']} rotted "
          f"row(s) over {counters.get('data/verify_rows', 0)} verified, {counters['data/decode_fallback']} "
          f"decoded live, captions unchanged; pass {rot_s:.3f}s", flush=True)


BULK_BAD = "zz_not_a_jpeg.jpg"


def bulk_outputs(out_dir: str) -> dict:
    return {n: open(os.path.join(out_dir, n), "rb").read() for n in sorted(os.listdir(out_dir))}


def bulk_phase(torch, np, tmp: str, card: str):
    """``python -m sat_tpu_torch.cli --phase bulk`` over the eval steady
    fixture's 400 JPEGs plus one file that is not a JPEG (401 files, two
    shards of ``bulk_shard_rows`` 256), the slice phase's flagship
    checkpoint and every ``Config`` default (16 slots x beam 3, decode
    depths 1/2/4/8, heartbeat every 10 s), each run in a fresh process:
    a control run; a run killed by ``SAT_FI_DIE_AT_STEP`` at half the
    control's decode steps, relaunched: the output directory bitwise the
    control's; a second relaunch: "nothing to do".  Then one shard decoded
    in-process, once warm and once under torch.profiler: the card's busy
    share.  Returns the B2 launches of the CLI runs."""
    from torch.profiler import ProfilerActivity, profile

    from sat_tpu_torch import telemetry
    from sat_tpu_torch.bulk import runner
    from sat_tpu_torch.bulk.corpus import resolve_corpus
    from sat_tpu_torch.data.vocabulary import Vocabulary
    from sat_tpu_torch.resilience.faultinject import FaultPlan
    from sat_tpu_torch.resilience.quarantine import QuarantineManager
    from sat_tpu_torch.resilience.watchdog import Watchdog
    from sat_tpu_torch.serve.engine import ServeEngine, load_serving_state
    from sat_tpu_torch.serve.slot_pool import PagedSlotPool

    root = os.path.join(tmp, "bulk")
    corpus = os.path.join(root, "corpus")
    os.makedirs(corpus)
    steady = os.path.join(tmp, "steady", "images")
    for name in sorted(os.listdir(steady)):
        os.link(os.path.join(steady, name), os.path.join(corpus, name))
    with open(os.path.join(corpus, BULK_BAD), "wb") as f:
        f.write(b"this file is not a JPEG\n")
    base = flagship_config(tmp).replace(phase="bulk", bulk_input=corpus)
    files = resolve_corpus(corpus)
    if len(files) != STEADY_IMAGES + 1:
        fail(f"bulk: the corpus holds {len(files)} files")

    def run(name, where, rc=0, env=None):
        config = base.replace(bulk_output=os.path.join(root, name),
                              summary_dir=os.path.join(root, name + "_summary"))
        path = os.path.join(root, name + ".json")
        config.save(path)
        tally, _ = run_cli(["--config", path], where, rc=rc, env=env)
        if tally["launches"] != 0:
            fail(f"{where}: the unmasked fused_attend ran {tally['launches']} times on the bulk path")
        return config, tally

    control, tally = run("control", "bulk")
    if tally["masked"] == 0:
        fail("bulk: the masked fused_attend was never launched on the bulk path")
    out = bulk_outputs(control.bulk_output)
    if sorted(n for n in out if n.endswith(".jsonl")) != ["captions_00000.jsonl", "captions_00001.jsonl"]:
        fail(f"bulk: output files {sorted(out)}")
    rows = [json.loads(line) for n in ("captions_00000.jsonl", "captions_00001.jsonl")
            for line in out[n].decode().splitlines()]
    if [r["file"] for r in rows] != files:
        fail("bulk: the rows are not one per corpus file, in corpus order")
    for r in rows:
        caps = r["captions"]
        if len(caps) != control.beam_size or not all(
                isinstance(c["caption"], str) and np.isfinite(c["log_prob"]) and np.isfinite(c["prob"])
                for c in caps):
            fail(f"bulk: row {r['file']} has captions {caps}")
    marked = [r for r in rows if r.get("quarantined")]
    if [os.path.basename(r["file"]) for r in marked] != [BULK_BAD] or marked[0]["substituted_from"] not in files:
        fail(f"bulk: quarantine markers {marked[:2]}")
    with open(os.path.join(control.summary_dir, "quarantine.jsonl")) as f:
        ledger = [json.loads(line) for line in f]
    if len(ledger) != 1 or os.path.basename(ledger[0]["file"]) != BULK_BAD:
        fail(f"bulk: ledger {ledger}")
    with open(os.path.join(control.summary_dir, "telemetry", "heartbeat.json")) as f:
        gauges = json.load(f)["bulk"]
    if gauges.get("images_done") != len(files) or not gauges.get("device_ms_per_image", 0) > 0:
        fail(f"bulk: heartbeat gauges {gauges}")
    steps = gauges["decode_steps"]
    complete = [line for line in tally["stderr"].splitlines() if "bulk: complete" in line]
    print(f"bulk flagship bf16 on {card}: {len(files)} files (1 not a JPEG, quarantined and substituted "
          f"from {os.path.basename(marked[0]['substituted_from'])}) in 2 shards, process start to exit "
          f"{tally['wall_s']:.2f}s; captions/s {gauges['captions_per_s']}, bulk/device_ms_per_image "
          f"{gauges['device_ms_per_image']}, decode steps {steps}; fused_attend masked launches "
          f"{tally['masked']}, unmasked 0", flush=True)
    print(f"bulk log: {complete[-1] if complete else '(no complete line)'}", flush=True)
    print(f"bulk heartbeat gauges: {json.dumps(gauges, sort_keys=True)}", flush=True)
    print(f"bulk sample row (random weights): {json.dumps(rows[0])[:300]}", flush=True)

    killed, kill_tally = run("killed", "bulk kill", rc=1, env={"SAT_FI_DIE_AT_STEP": str(steps // 2)})
    if "injected preemption" not in kill_tally["stderr"]:
        fail(f"bulk kill: the run did not stop on the injected preemption:\n{kill_tally['stderr'][-1500:]}")
    done = json.loads(bulk_outputs(killed.bulk_output)["bulk_manifest.json"])["completed"]
    if len(done) >= 2:
        fail(f"bulk kill: the kill at step {steps // 2} of {steps} left {len(done)} shards complete")
    _, resumed = run("killed", "bulk resume")
    if bulk_outputs(killed.bulk_output) != bulk_outputs(control.bulk_output):
        diff = [n for n, b in bulk_outputs(killed.bulk_output).items() if out.get(n) != b]
        fail(f"bulk resume: output files differ from the uninterrupted run's: {diff}")
    _, again = run("killed", "bulk resume again")
    if "nothing to do" not in again["stderr"] or again["masked"] != 0:
        fail(f"bulk resume again: expected nothing to do:\n{again['stderr'][-1000:]}")
    print(f"bulk kill on {card}: SAT_FI_DIE_AT_STEP={steps // 2} of {steps} exited 1 after "
          f"{kill_tally['wall_s']:.2f}s with {len(done)} shard(s) committed; the relaunch "
          f"({resumed['wall_s']:.2f}s) left the output directory bitwise the uninterrupted run's; a "
          f"second relaunch: nothing to do ({again['wall_s']:.2f}s)", flush=True)

    # one shard, in-process: the card's busy share of its decode
    tel = telemetry.enable()
    try:
        state, _ = load_serving_state(control, device="cuda")
        engine = ServeEngine(control, state, Vocabulary(control.vocabulary_size, control.vocabulary_file),
                             device="cuda", tel=tel)
        pool = PagedSlotPool(engine, tel=tel)
        pool.warmup()
        shard = files[:control.bulk_shard_rows]
        batch, _ = runner._assemble_rows(shard, engine.loader, None,
                                         QuarantineManager(os.path.join(root, "profile.jsonl")), 8)
        wd, fp = Watchdog({}), FaultPlan()
        runner._decode_shard(engine, pool, batch, fp, wd, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner._decode_shard(engine, pool, batch, fp, wd, 0)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            runner._decode_shard(engine, pool, batch, fp, wd, 0)
            torch.cuda.synchronize()
            profiled = time.perf_counter() - t0
    finally:
        telemetry.disable()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    if busy == 0:
        fail("bulk profile: torch.profiler recorded no device time")
    print(f"profile bulk shard on {card}: {len(shard)} images, warm {warm:.3f}s ({len(shard) / warm:.1f} "
          f"captions/s), under the profiler {profiled:.3f}s, device busy {busy:.3f}s ({busy / profiled:.1%} "
          f"of that wall, {busy / warm:.1%} of the warm pass)", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"profile bulk kernel {e.self_device_time_total / 1e3:8.3f} ms x{e.count:<5d} {e.key[:90]}",
              flush=True)
    return tally["masked"] + kill_tally["masked"] + resumed["masked"]


# -- serve planes: the encode cache, the tier handoff, the lifecycle, tenants, quality --------

PLANES_IMAGES = 12     # distinct JPEGs of the cache traffic, each sent 3 times
PLANES_BULK = 64       # the quality bulk run's files: the steady fixture's first 64


def planes_engine(config, model_file=None):
    """A serve engine on the card for ``config`` (warmed in batch mode;
    the server warms the pool in continuous mode), recording into the
    telemetry registry live when it is built."""
    from sat_tpu_torch.data.vocabulary import Vocabulary
    from sat_tpu_torch.serve.engine import ServeEngine, load_serving_state

    state, _ = load_serving_state(config, model_file=model_file, device="cuda")
    engine = ServeEngine(config, state, Vocabulary(config.vocabulary_size, config.vocabulary_file), device="cuda")
    if config.serve_mode == "batch":
        engine.warmup()
    return engine


def planes_server(config, engine):
    from sat_tpu_torch.serve.server import CaptionServer

    return CaptionServer(config, engine, port=0, host="127.0.0.1").start()


def beams(payload):
    return [(c["caption"], c["log_prob"]) for c in payload["captions"]]


def ok_reply(np, config, status, payload, where: str):
    if status != 200 or len(payload.get("captions", ())) != config.beam_size or not all(
            isinstance(c["caption"], str) and np.isfinite(c["log_prob"]) for c in payload["captions"]):
        fail(f"{where}: reply {status} {payload}")


def width_invariance(torch, np, engine, body) -> dict:
    """One image encoded at row 0 of batches of 1, 4, 16 and 32 (zeros
    elsewhere): the largest difference of its contexts from width 1's."""
    image = engine.preprocess(body)
    size = engine.config.image_size
    out, ref = {}, None
    with torch.inference_mode():
        for w in (1, 4, 16, 32):
            batch = np.zeros((w, size, size, 3), engine._image_dtype)
            batch[0] = image
            ctx = engine.encode_images(batch)[0].float()
            ref = ctx if ref is None else ref
            out[w] = float((ctx - ref).abs().max())
    return out


def cache_part(torch, np, fa, config, card: str, bodies, where: str, modes=("batch", "continuous")):
    """36 requests over 12 JPEGs in one seeded order, one at a time, to a
    server with the encode cache off and then on, in each mode: every
    repeat of an image bitwise its first (cold) reply; on against off
    bitwise when the encoder gives the same bits at every width (checked
    first), else the same words and the best log-prob within 1e-3
    relative; a 4-request concurrent burst of a new image: exactly one
    miss.  Returns (B1 launches, B2 launches, the batch-mode off engine)."""
    from sat_tpu_torch import telemetry

    order = np.random.default_rng(SEED + 60).permutation(np.repeat(np.arange(PLANES_IMAGES), 3))
    b1 = b2 = 0
    keep = None
    widths = None
    for mode in modes:
        replies = {}
        for cache in ("off", "on"):
            tel = telemetry.enable()
            cfg = config.replace(serve_mode=mode, encode_cache=cache,
                                 telemetry_dir=os.path.join(os.path.dirname(config.save_dir), f"t_{mode}_{cache}"))
            engine = planes_engine(cfg)
            if widths is None:
                widths = width_invariance(torch, np, engine, bodies[0])
                print(f"{where} encoder width invariance on {card}: one image's contexts at widths 1/4/16/32, "
                      f"max abs diff from width 1: {widths}", flush=True)
            server = planes_server(cfg, engine)
            try:
                fa.fused_attend.launches = fa.fused_attend.masked_launches = 0
                got = [caption(server.port, bodies[i]) for i in order]
                launched = (fa.fused_attend.launches, fa.fused_attend.masked_launches)
                stats = get_stats(server.port)
                burst = None
                if cache == "on":
                    before = dict(engine.encode_cache.stats())
                    _, burst = post_all(server.port, [bodies[PLANES_IMAGES]] * 4)
                    after = engine.encode_cache.stats()
                    burst = {k: after[k] - before[k] for k in ("misses", "hits", "coalesced")}
            finally:
                server.shutdown()
                telemetry.disable()
            for status, payload, _, _ in got:
                ok_reply(np, cfg, status, payload, f"{where} {mode} cache {cache}")
            cold = {}
            for i, (_, payload, _, _) in zip(order, got):
                if i in cold and beams(payload) != cold[i]:
                    fail(f"{where} {mode} cache {cache}: image {i} repeated is not bitwise its cold reply")
                cold.setdefault(i, beams(payload))
            if launched[0 if mode == "batch" else 1] == 0:
                fail(f"{where} {mode} cache {cache}: the {'unmasked' if mode == 'batch' else 'masked'} "
                     f"fused_attend never launched: {launched}")
            b1, b2 = b1 + launched[0], b2 + launched[1]
            replies[cache] = [p for _, p, _, _ in got]
            enc = stats["engine"].get("encode_ms", {})
            lat = statistics.median(g[3] for g in got)
            if cache == "on":
                block = stats["encode_cache"]
                want = len(order) - PLANES_IMAGES
                if block["hits"] + block["coalesced"] != want or block["misses"] != PLANES_IMAGES:
                    fail(f"{where} {mode}: cache block {block} for {len(order)} requests over {PLANES_IMAGES} images")
                if burst["misses"] != 1 or burst["hits"] + burst["coalesced"] != 3:
                    fail(f"{where} {mode}: a 4-request burst of one new image gave {burst}")
                gather = block.get("gather_ms", {})
                print(f"{where} {mode} cache on, {card}: hit ratio {block['hit_ratio']} ({block['hits']} hits, "
                      f"{block['coalesced']} coalesced, {block['misses']} misses of {len(order)}; ring "
                      f"{block['rows']} rows, {block['capacity_bytes'] / 2**20:.1f} MiB), serve/cache_gather p50 "
                      f"{gather.get('p50')} ms vs serve/encode p50 {enc.get('p50')} ms (misses only); request "
                      f"p50 {lat:.2f} ms; burst of 4 of one new image: {burst}; every hit bitwise its cold "
                      f"reply; launches B1 {launched[0]}, B2 {launched[1]}", flush=True)
            else:
                print(f"{where} {mode} cache off, {card}: serve/encode p50 {enc.get('p50')} ms (every request); "
                      f"request p50 {lat:.2f} ms; launches B1 {launched[0]}, B2 {launched[1]}", flush=True)
            if mode == "batch" and cache == "off" and keep is None:
                keep = engine
            del engine
        pairs = list(zip(replies["on"], replies["off"]))
        invariant = all(v == 0.0 for v in widths.values())
        if invariant:
            if any(beams(a) != beams(b) for a, b in pairs):
                fail(f"{where} {mode}: cache on and off differ though the encoder is width-invariant")
            verdict = "bitwise"
        else:
            for a, b in pairs:
                ba, bb = a["captions"][0], b["captions"][0]
                if [c["caption"] for c in a["captions"]] != [c["caption"] for c in b["captions"]] or \
                        abs(ba["log_prob"] - bb["log_prob"]) > 1e-3 * abs(bb["log_prob"]):
                    fail(f"{where} {mode}: cache on and off disagree past the gate: {a} vs {b}")
            verdict = "same words, best log-prob within 1e-3 relative"
        print(f"{where} {mode}: cache on vs off over {len(pairs)} requests: {verdict}", flush=True)
    return b1, b2, keep


def tier_part(torch, np, fa, config, card: str, bodies):
    """An encode-tier server (batch mode) and a decode-tier server
    (continuous mode) in this process: /encode frames caption on the
    decode tier (B2) and on the encode tier (B1) with the words the
    decode tier gives the image itself; a flipped bit 400, another step
    409; the frame's crc timed on each side."""
    from sat_tpu_torch import telemetry
    from sat_tpu_torch.serve import handoff

    tel = telemetry.enable()
    base = os.path.dirname(config.save_dir)
    enc_cfg = config.replace(serve_tier="encode", telemetry_dir=os.path.join(base, "t_encode"))
    dec_cfg = config.replace(serve_tier="decode", serve_mode="continuous", telemetry_dir=os.path.join(base, "t_decode"))
    enc_engine, dec_engine = planes_engine(enc_cfg), planes_engine(dec_cfg)
    enc, dec = planes_server(enc_cfg, enc_engine), planes_server(dec_cfg, dec_engine)
    try:
        if not enc_engine._enc_one_warm or healthz(enc.port)[1]["tier"] != "encode":
            fail("tiers: the encode tier did not warm its width-1 encode before ready")
        fa.fused_attend.launches = fa.fused_attend.masked_launches = 0
        encode_ms, frames = [], []
        for i in range(4):
            t0 = time.perf_counter()
            status, hdrs, frame = http(enc.port, "POST", "/encode", bodies[i], {"Content-Type": "image/jpeg"})
            encode_ms.append((time.perf_counter() - t0) * 1e3)
            if status != 200 or hdrs.get("Content-Type") != handoff.GRID_CONTENT_TYPE:
                fail(f"tiers: /encode gave {status} {hdrs.get('Content-Type')}: {frame[:200]}")
            frames.append(frame)
            grid_hdr = {"Content-Type": handoff.GRID_CONTENT_TYPE}
            words = {}
            for name, port in (("decode", dec.port), ("encode", enc.port)):
                status, _, raw = http(port, "POST", "/caption", frame, grid_hdr)
                payload = json.loads(raw)
                ok_reply(np, config, status, payload, f"tiers: a frame on the {name} tier")
                words[name] = [c["caption"] for c in payload["captions"]]
            status, payload, _, _ = caption(dec.port, bodies[i])
            ok_reply(np, config, status, payload, "tiers: an image on the decode tier")
            both = [c["caption"] for c in payload["captions"]]
            if words["decode"] != both or words["encode"] != both:
                fail(f"tiers: image {i}: frame words {words} vs the image's own {both}")
        launched = (fa.fused_attend.launches, fa.fused_attend.masked_launches)
        bad = bytearray(frames[0])
        bad[-7] ^= 0x10
        status, _, raw = http(dec.port, "POST", "/caption", bytes(bad), {"Content-Type": handoff.GRID_CONTENT_TYPE})
        if status != 400 or b"crc32c" not in raw:
            fail(f"tiers: a flipped bit gave {status} {raw[:200]}")
        grid, header = handoff.decode_grid(frames[0])
        stale = handoff.encode_grid(grid, step=int(header["step"]) + 1)
        status, _, raw = http(dec.port, "POST", "/caption", stale, {"Content-Type": handoff.GRID_CONTENT_TYPE})
        if status != 409:
            fail(f"tiers: a grid stamped with another step gave {status} {raw[:200]}")
        enc_crc = statistics.median(timed_call(lambda: handoff.encode_grid(grid, step=1)) for _ in range(20))
        dec_crc = statistics.median(timed_call(lambda: handoff.decode_grid(frames[0])) for _ in range(20))
    finally:
        enc.shutdown()
        dec.shutdown()
        telemetry.disable()
    if launched[0] == 0 or launched[1] == 0:
        fail(f"tiers: fused_attend launches {launched}: both bodies must run on the handoff paths")
    print(f"tiers on {card}: 4 /encode frames of {len(frames[0])} bytes ({grid.shape} {grid.dtype}) captioned on "
          f"the decode tier (continuous) and the encode tier (batch) with the image's own words; flipped bit "
          f"400, another step 409; /encode p50 {statistics.median(encode_ms):.2f} ms (client clock); the "
          f"frame's crc32c: framing {enc_crc:.2f} ms (encode side), checking {dec_crc:.2f} ms (decode side); "
          f"launches B1 {launched[0]}, B2 {launched[1]}", flush=True)
    return launched


def timed_call(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def stage_candidate(np, config, src: str, step: int, seed: int) -> str:
    """``src`` with its decoder's float tensors jittered (N(0, 0.02) from
    ``seed``) as ``<step>.npz`` in ``config.save_dir``, with its sidecar,
    and LAST_GOOD pointed at it."""
    from sat_tpu_torch.data.vocabulary import vocab_fingerprint
    from sat_tpu_torch.resilience import lineage

    rng = np.random.default_rng(seed)
    with np.load(src) as z:
        flat = {k: z[k] for k in z.files}
    for k in sorted(flat):
        if k.startswith("params/decoder/") and flat[k].dtype.kind == "f":
            flat[k] = (flat[k] + rng.normal(0, 0.02, flat[k].shape)).astype(flat[k].dtype)
    flat["global_step"] = np.asarray(step, np.int32)
    path = os.path.join(config.save_dir, f"{step}.npz")
    np.savez(path, **flat)
    lineage.write_sidecar(path, vocab=vocab_fingerprint(config.vocabulary_file, config.vocabulary_size))
    lineage.mark_last_good(config.save_dir, step)
    return path


def slot_ids(fraction: float, n: int = 3):
    from sat_tpu_torch.lifecycle.canary import CANARY, assign_slot

    inc, can, i = [], [], 0
    while len(inc) < n or len(can) < n:
        rid = f"planes-{i}"
        i += 1
        (can if assign_slot(rid, fraction) == CANARY else inc).append(rid)
    return inc[:n], can[:n]


def lifecycle_part(torch, np, fa, config, card: str, bodies):
    """Continuous mode, ``promote_policy="manual"``: a jittered candidate
    staged and ``POST /reload``ed while requests flow (their p50 beside
    the p50 before); canary ids get ``slot="canary"`` and the candidate's
    step (B2 through the clone pool); ``/promote``, after which the same
    ids get the canary's replies bitwise from the incumbent slot; a
    second candidate rolled back and rejected.  ``/healthz``'s
    ``lifecycle_state`` is polled throughout."""
    import shutil

    from sat_tpu_torch import telemetry
    from sat_tpu_torch.resilience import lineage

    root = os.path.join(os.path.dirname(config.save_dir), "planes_lifecycle")
    os.makedirs(root)
    src = lineage.last_good_checkpoint(config.save_dir)
    for name in (src, lineage.sidecar_path(src)):
        shutil.copy(name, root)
    base_step = lineage.last_good_step(config.save_dir)
    lineage.mark_last_good(root, base_step)
    cfg = config.replace(serve_mode="continuous", save_dir=root, promote_policy="manual", canary_fraction=0.5,
                         canary_window_s=600.0, model_reload=0.0,
                         telemetry_dir=os.path.join(root, "telemetry"))
    inc_ids, can_ids = slot_ids(cfg.canary_fraction)
    tel = telemetry.enable()
    engine = planes_engine(cfg)
    server = planes_server(cfg, engine)
    states, stop = [], threading.Event()

    def poll():
        while not stop.is_set():
            state = healthz(server.port)[1]["lifecycle_state"]
            if not states or states[-1] != state:
                states.append(state)
            time.sleep(0.01)

    def wait_state(want, limit_s=120.0):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < limit_s:
            if get_stats(server.port)["lifecycle"]["state"] == want:
                return
            time.sleep(0.02)
        fail(f"lifecycle: never reached {want}: {get_stats(server.port)['lifecycle']}")

    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    try:
        before = [caption(server.port, bodies[i % 4], inc_ids[i % 3]) for i in range(12)]
        during, flowing = [], threading.Event()

        def flow():
            i = 0
            while not flowing.is_set():
                during.append(caption(server.port, bodies[i % 4], inc_ids[i % 3]))
                i += 1

        stage_candidate(np, cfg, src, base_step + 1000, SEED + 80)
        flower = threading.Thread(target=flow, daemon=True)
        flower.start()
        t0 = time.perf_counter()
        status, _, raw = http(server.port, "POST", "/reload")
        if status != 200:
            fail(f"lifecycle: /reload gave {status} {raw[:300]}")
        wait_state("CANARY")
        load_s = time.perf_counter() - t0
        flowing.set()
        flower.join(timeout=120)
        hz = healthz(server.port)[1]
        if hz.get("candidate_step") != base_step + 1000:
            fail(f"lifecycle: /healthz during the canary: {hz}")
        fa.fused_attend.launches = fa.fused_attend.masked_launches = 0
        canary = {}
        for j, rid in enumerate(can_ids):
            status, payload, _, _ = caption(server.port, bodies[j], rid)
            ok_reply(np, cfg, status, payload, "lifecycle canary")
            if (payload["slot"], payload["model_step"]) != ("canary", base_step + 1000):
                fail(f"lifecycle: canary id {rid} got slot {payload['slot']} step {payload['model_step']}")
            canary[rid] = beams(payload)
        canary_b2 = fa.fused_attend.masked_launches
        clone = server.batcher._canary_pool
        if canary_b2 == 0 or clone is None or clone.engine is not engine or clone.param_slot != "canary":
            fail("lifecycle: the canary requests did not run B2 through a canary pool over the one engine")
        for j, rid in enumerate(inc_ids):
            status, payload, _, _ = caption(server.port, bodies[j], rid)
            if (status, payload.get("slot"), payload.get("model_step")) != (200, "incumbent", base_step):
                fail(f"lifecycle: incumbent id {rid} during the canary got {status} {payload}")
        status, _, raw = http(server.port, "POST", "/promote")
        if status != 200 or json.loads(raw)["model_step"] != base_step + 1000:
            fail(f"lifecycle: /promote gave {status} {raw[:300]}")
        blackout = get_stats(server.port)["lifecycle"]["last_cycle"]["blackout_ms"]
        for j, rid in enumerate(can_ids):
            status, payload, _, _ = caption(server.port, bodies[j], rid)
            if (payload.get("slot"), payload.get("model_step")) != ("incumbent", base_step + 1000) or \
                    beams(payload) != canary[rid]:
                fail(f"lifecycle: after the promote, id {rid} is not the canary's reply bitwise: {payload}")
        stage_candidate(np, cfg, src, base_step + 2000, SEED + 81)
        status, _, raw = http(server.port, "POST", "/reload")
        if status != 200:
            fail(f"lifecycle: the second /reload gave {status} {raw[:300]}")
        wait_state("CANARY")
        status, _, raw = http(server.port, "POST", "/rollback")
        if status != 200 or json.loads(raw)["state"] != "IDLE":
            fail(f"lifecycle: /rollback gave {status} {raw[:300]}")
        if not lineage.is_rejected(root, base_step + 2000):
            fail("lifecycle: the rolled-back step is not in the rejection ledger")
        status, _, raw = http(server.port, "POST", "/reload")
        if status != 409:
            fail(f"lifecycle: a rejected step reloaded: {status} {raw[:300]}")
        for j, rid in enumerate(can_ids):
            status, payload, _, _ = caption(server.port, bodies[j], rid)
            if payload.get("model_step") != base_step + 1000 or beams(payload) != canary[rid]:
                fail(f"lifecycle: after the rollback, id {rid} changed: {payload}")
        launches = (fa.fused_attend.launches, fa.fused_attend.masked_launches)
    finally:
        stop.set()
        poller.join(timeout=10)
        server.shutdown()
        telemetry.disable()
    for status, payload, _, _ in before + during:
        ok_reply(np, cfg, status, payload, "lifecycle: a request before or during the load")
    p_before = statistics.median(r[3] for r in before)
    p_during = statistics.median(r[3] for r in during) if during else float("nan")
    print(f"lifecycle on {card}: candidate load to CANARY {load_s:.2f}s; request p50 before {p_before:.2f} ms "
          f"(12), during the load {p_during:.2f} ms ({len(during)}); /healthz lifecycle_state sequence "
          f"{states}; canary ids slot canary at step {base_step + 1000} (B2 {canary_b2} launches through the "
          f"clone pool), promoted (blackout {blackout} ms: a promote "
          f"waits out captions in flight), the same ids then bitwise the canary's replies; step "
          f"{base_step + 2000} rolled back and rejected; launches after the reload B1 {launches[0]}, B2 "
          f"{launches[1]}", flush=True)
    return launches


def tenants_part(torch, np, fa, config, card: str, bodies):
    """Two tenants, ``pro`` (weight 2) and ``free`` (1 rps, burst 1), and
    a resident model ``alt`` (a second seeded checkpoint): ``X-Model:
    alt`` replies equal a server booted on that checkpoint alone, in
    continuous (B2) and batch (B1) mode; three quick ``free`` requests:
    the third is shed with 429, ``Retry-After`` and scope ``tenant``."""
    from sat_tpu_torch import telemetry

    root = os.path.join(os.path.dirname(config.save_dir), "planes_tenants")
    alt_dir = os.path.join(root, "alt")
    alt = write_checkpoint(np, config, alt_dir, step=5000, seed=SEED + 90)
    spec = os.path.join(root, "tenants.json")
    with open(spec, "w") as f:
        json.dump({"tenants": [{"name": "pro", "weight": 2}, {"name": "free", "rps": 1, "burst": 1}],
                   "models": {"alt": alt}}, f)
    telemetry.enable()
    try:
        alone_cfg = config.replace(serve_mode="continuous", save_dir=alt_dir,
                                   telemetry_dir=os.path.join(root, "t_alone"))
        server = planes_server(alone_cfg, planes_engine(alone_cfg))
        try:
            alone = [caption(server.port, bodies[i]) for i in range(4)]
        finally:
            server.shutdown()
        launches = [0, 0]
        for mode in ("continuous", "batch"):
            cfg = config.replace(serve_mode=mode, tenants=spec, telemetry_dir=os.path.join(root, f"t_{mode}"))
            server = planes_server(cfg, planes_engine(cfg))
            try:
                fa.fused_attend.launches = fa.fused_attend.masked_launches = 0
                got = []
                for i in range(4):
                    status, hdrs, raw = http(server.port, "POST", "/caption", bodies[i],
                                             {"Content-Type": "image/jpeg", "X-Tenant": "pro", "X-Model": "alt"})
                    got.append((status, json.loads(raw)))
                launches[0] += fa.fused_attend.launches
                launches[1] += fa.fused_attend.masked_launches
                if mode == "continuous" and server.batcher._model_pools["alt"].engine is not server.engine:
                    fail("tenants: the resident model's pool is not over the server's one engine")
                quick = [http(server.port, "POST", "/caption", bodies[0],
                              {"Content-Type": "image/jpeg", "X-Tenant": "free"}) for _ in range(3)]
                stats = get_stats(server.port)
            finally:
                server.shutdown()
            for (status, payload), (_, want, _, _) in zip(got, alone):
                ok_reply(np, cfg, status, payload, f"tenants {mode}: X-Model alt")
                if (payload["model"], payload["model_step"], payload["tenant"]) != ("alt", 5000, "pro"):
                    fail(f"tenants {mode}: X-Model alt reply {payload}")
                same = beams(payload) == beams(want) if mode == "continuous" else \
                    [c for c, _ in beams(payload)] == [c for c, _ in beams(want)]
                if not same:
                    fail(f"tenants {mode}: X-Model alt {payload} vs the checkpoint alone {want}")
            status, hdrs, raw = quick[2]
            body = json.loads(raw)
            if status != 429 or body.get("shed_scope") != "tenant" or hdrs.get("X-Shed-Scope") != "tenant" \
                    or not hdrs.get("Retry-After"):
                fail(f"tenants {mode}: the third quick free request got {status} {hdrs} {body}")
            if (mode == "batch" and fa.fused_attend.launches == 0) or \
                    (mode == "continuous" and fa.fused_attend.masked_launches == 0):
                fail(f"tenants {mode}: the resident model's requests launched no kernel")
            print(f"tenants {mode} on {card}: X-Model alt (step 5000) words equal a server booted on it alone"
                  f"{' (bitwise)' if mode == 'continuous' else ''}; free tenant's 3 quick requests "
                  f"{[q[0] for q in quick]}, the third 429 Retry-After {hdrs.get('Retry-After')} scope tenant; "
                  f"/stats tenants {sorted(stats['tenants'])}", flush=True)
    finally:
        telemetry.disable()
    return tuple(launches)


def quality_part(torch, np, fa, config, card: str, bodies, off_engine, corpus_dir: str):
    """``serve_quality="on"``, window 32: 40 requests, then
    ``/quality_reference`` 200 and a ``quality`` block in /stats; the p50
    of lone requests with quality off and on, in turns; ``--phase bulk``
    with quality on over the steady fixture's first 64 files (2 shards
    of 32) killed at half its decode steps and relaunched: the rows
    bitwise the uninterrupted run's, ``quality`` included."""
    from sat_tpu_torch import telemetry

    root = os.path.join(os.path.dirname(config.save_dir), "planes_quality")
    cfg = config.replace(serve_quality="on", serve_quality_window=32, telemetry_dir=os.path.join(root, "t_on"))
    off_cfg = config.replace(telemetry_dir=os.path.join(root, "t_off"))
    telemetry.enable()
    try:
        on_engine = planes_engine(cfg)
        servers = {"off": planes_server(off_cfg, off_engine), "on": planes_server(cfg, on_engine)}
        try:
            fa.fused_attend.launches = 0
            lat = {"off": [], "on": []}
            replies = []
            for turn in range(4):
                for name in ("off", "on"):
                    for i in range(10):
                        status, payload, _, ms = caption(servers[name].port, bodies[(turn * 10 + i) % 36])
                        ok_reply(np, cfg, status, payload, f"quality {name}")
                        lat[name].append(ms)
                        if name == "on":
                            replies.append(payload)
            b1 = fa.fused_attend.launches
            status, _, raw = http(servers["on"].port, "GET", "/quality_reference")
            stats = get_stats(servers["on"].port)
            status_off, _, _ = http(servers["off"].port, "GET", "/quality_reference")
        finally:
            for s in servers.values():
                s.shutdown()
    finally:
        telemetry.disable()
    ref = json.loads(raw)
    if status != 200 or "quality" not in stats or status_off != 404:
        fail(f"quality: /quality_reference {status} (off {status_off}), /stats keys {sorted(stats)}: {ref}")
    q = stats["quality"]
    print(f"quality on {card}: 40 requests, /quality_reference 200 ({len(json.dumps(ref))} bytes), 404 with it "
          f"off; /stats quality: {json.dumps(q)[:400]}", flush=True)
    print(f"quality p50 of a lone request on {card}, batch mode, off / on in 4 turns of 10: "
          f"{statistics.median(lat['off']):.2f} / {statistics.median(lat['on']):.2f} ms", flush=True)

    base = config.replace(phase="bulk", bulk_input=corpus_dir, bulk_shard_rows=32, serve_quality="on")

    def run(name, where, rc=0, env=None):
        c = base.replace(bulk_output=os.path.join(root, name), summary_dir=os.path.join(root, name + "_summary"))
        path = os.path.join(root, name + ".json")
        c.save(path)
        tally, _ = run_cli(["--config", path], where, rc=rc, env=env)
        return c, tally

    control, tally = run("control", "quality bulk")
    out = bulk_outputs(control.bulk_output)
    rows = [json.loads(line) for n in sorted(out) if n.endswith(".jsonl") for line in out[n].decode().splitlines()]
    keys = {"margin", "norm_logprob", "unk_rate", "coverage_dev"}
    if len(rows) != PLANES_BULK or not all(set(r.get("quality", ())) == keys for r in rows):
        fail(f"quality bulk: {len(rows)} rows, first {rows[:1]}")
    if tally["masked"] == 0 or tally["launches"] != 0:
        fail(f"quality bulk: launches {tally}")
    with open(os.path.join(control.summary_dir, "telemetry", "heartbeat.json")) as f:
        steps = json.load(f)["bulk"]["decode_steps"]
    killed, kill_tally = run("killed", "quality bulk kill", rc=1, env={"SAT_FI_DIE_AT_STEP": str(steps // 2)})
    _, resumed = run("killed", "quality bulk resume")
    if bulk_outputs(killed.bulk_output) != out:
        fail("quality bulk: the relaunched run's output is not bitwise the uninterrupted run's")
    print(f"quality bulk on {card}: {PLANES_BULK} files in 2 shards with serve_quality on: every row carries "
          f"{sorted(keys)}; killed at step {steps // 2} of {steps} and relaunched: output bitwise the "
          f"uninterrupted run's; sample {json.dumps(rows[0]['quality'])}", flush=True)
    return b1, tally["masked"] + kill_tally["masked"] + resumed["masked"]


def serve_planes_phase(torch, np, fa, config, card: str, tmp: str):
    """Part 1-5 at the flagship: returns (B1, B2) launches on their paths."""
    bodies = jpegs(np, 36, 256, SEED + 3)
    steady = os.path.join(tmp, "steady")
    if not os.path.isdir(os.path.join(steady, "images")):
        write_coco_fixture(np, steady, PLANES_BULK, SEED + 45, size=STEADY_SIZE)
    corpus = os.path.join(tmp, "planes_corpus")
    os.makedirs(corpus)
    for name in sorted(os.listdir(os.path.join(steady, "images")))[:PLANES_BULK]:
        os.link(os.path.join(steady, "images", name), os.path.join(corpus, name))
    b1, b2 = [0], [0]

    def add(pair):
        b1[0] += pair[0]
        b2[0] += pair[1]

    from sat_tpu_torch.ops import build

    built = {n: os.path.getmtime(os.path.join(build.BUILD_DIR, n)) for n in os.listdir(build.BUILD_DIR)}
    calls = [0]
    build_all = build.build_all

    def counted_build_all():
        calls[0] += 1
        return build_all()

    build.build_all = counted_build_all
    t0 = time.perf_counter()
    c1, c2, off_engine = cache_part(torch, np, fa, config, card, bodies, "cache")
    add((c1, c2))
    print(f"serve planes: cache part {time.perf_counter() - t0:.1f}s", flush=True)
    ready_calls = calls[0]
    t0 = time.perf_counter()
    add(tier_part(torch, np, fa, config, card, bodies))
    print(f"serve planes: tier part {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    add(lifecycle_part(torch, np, fa, config, card, bodies))
    print(f"serve planes: lifecycle part {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    add(tenants_part(torch, np, fa, config, card, bodies))
    print(f"serve planes: tenants part {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    add(quality_part(torch, np, fa, config, card, bodies, off_engine, corpus))
    print(f"serve planes: quality part {time.perf_counter() - t0:.1f}s", flush=True)
    build.build_all = build_all
    now = {n: os.path.getmtime(os.path.join(build.BUILD_DIR, n)) for n in os.listdir(build.BUILD_DIR)}
    if calls[0] != ready_calls or now != built:
        fail(f"serve planes: the kernel loader ran {calls[0] - ready_calls} more time(s) after the first "
             f"server was ready, or the build directory changed ({sorted(built)} -> {sorted(now)})")
    print(f"serve planes: ops/build loaded the kernel {calls[0]} time(s), none after the first server was "
          f"ready ({len(now)} built file(s) unchanged); every pool (canary, resident) over its server's one "
          f"engine", flush=True)
    return b1[0], b2[0]



# -- train phases ---------------------------------------------------------------

def small_train_config(**kw):
    """The tests' small float32 model (32 px, N=4) with dropout off."""
    from sat_tpu_torch.config import Config

    return Config(
        image_size=32, dim_embedding=16, num_lstm_units=16, dim_initialize_layer=16,
        dim_attend_layer=16, dim_decode_layer=32, vocabulary_size=50, compute_dtype="float32",
        max_caption_length=8, fc_drop_rate=0.0, lstm_drop_rate=0.0, **kw,
    )


def train_batch(np, config, B: int, seed: int):
    """uint8 images, word ids in [1, V) over rows of 3..T words, masks."""
    rng = np.random.default_rng(seed)
    T = config.max_caption_length
    masks = (np.arange(T)[None] < rng.integers(3, T + 1, size=(B, 1))).astype(np.float32)
    return {
        "images": rng.integers(0, 256, size=(B, config.image_size, config.image_size, 3), dtype=np.uint8),
        "word_idxs": (rng.integers(1, config.vocabulary_size, size=(B, T)) * masks).astype(np.int32),
        "masks": masks,
    }


def train_reference_phase(torch, np, fa):
    """The train path at the small float32 size, dropout off: 3 Adam steps
    on the card and on the CPU from the same weights and batch (losses
    within 1e-5 relative, parameters within 1e-5 absolute, and no kernel
    launched by a train step); the kernel refuses to be differentiated on
    the card; an eval-loss step on the card launches B1 once a decode step
    (T in all) and matches the CPU's metrics within 1e-5 relative."""
    from sat_tpu_torch.device import resolve_device
    from sat_tpu_torch.train.checkpoint import params_to_flat
    from sat_tpu_torch.train.step import (
        create_train_state, make_eval_loss_step, make_train_step, step_generator,
    )

    config = small_train_config()
    resolve_device("cuda")
    batch = train_batch(np, config, 4, SEED + 50)
    losses, flats, evals = {}, {}, {}
    for dev in ("cuda", "cpu"):
        state = create_train_state(config, torch.Generator().manual_seed(SEED), dev)
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        step = make_train_step(config)
        before = (fa.fused_attend.launches, fa.fused_attend.masked_launches)
        losses[dev] = []
        for s in range(3):
            state, metrics = step(state, tb, step_generator(SEED, s, dev))
            losses[dev].append(float(metrics["total_loss"]))
        if (fa.fused_attend.launches, fa.fused_attend.masked_launches) != before:
            fail("train reference: a train step launched fused_attend")
        flats[dev] = params_to_flat(state.params)
        before = fa.fused_attend.launches
        evals[dev] = {k: float(v) for k, v in make_eval_loss_step(config)(state, tb).items()}
        launched = fa.fused_attend.launches - before
        if launched != (config.max_caption_length if dev == "cuda" else 0):
            fail(f"train reference: the eval-loss step on {dev} launched fused_attend {launched} times")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    param_err = max(float(np.abs(flats["cuda"][k] - v).max()) for k, v in flats["cpu"].items())
    eval_err = max(abs(evals["cuda"][k] - v) / max(abs(v), 1e-30) for k, v in evals["cpu"].items())
    if not (loss_err <= 1e-5 and param_err <= 1e-5 and eval_err <= 1e-5):
        fail(f"train reference: cuda vs cpu loss rel err {loss_err:.3e}, param abs err {param_err:.3e}, "
             f"eval-loss rel err {eval_err:.3e} (tol 1e-5 each)")
    args = [x.requires_grad_(i == 2) for i, x in
            enumerate(attention_inputs(torch, 3, 196, 512, 512, torch.Generator(device="cuda").manual_seed(SEED)))]
    try:
        fa.fused_attend(*args)
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
    else:
        fail("train reference: fused_attend on the card accepted an input that requires grad")
    print(f"train reference float32 small model, 3 Adam steps: cuda vs cpu loss rel err {loss_err:.3e}, "
          f"param abs err {param_err:.3e}, eval-loss rel err {eval_err:.3e} (tol 1e-5); losses "
          f"{[round(x, 6) for x in losses['cuda']]}; eval-loss step launched fused_attend "
          f"{config.max_caption_length} times (T); the kernel refused a grad-requiring input", flush=True)


TRAIN_STEPS, TRAIN_SAVE, TRAIN_LOG = 60, 20, 10


def train_config(steady_root: str, tmp: str):
    """The flagship model as the repo trains it by default (``Config``'s
    defaults: VGG16 at 224 px, N=196, D=da=E=H=512, decode layer 1024,
    V=5000, bf16 compute with float32 params, dropout 0.5/0.3, Adam 1e-4,
    clip 5, batch 20, T=20, frozen CNN, async checkpoints) on the steady
    fixture's 400 JPEGs with two captions each: 800 pairs, 40 steps an
    epoch."""
    root = os.path.join(tmp, "train")
    return flagship_config(tmp).replace(
        phase="train",
        train_image_dir=os.path.join(steady_root, "images"),
        train_caption_file=os.path.join(steady_root, "captions.json"),
        vocabulary_file=os.path.join(root, "vocabulary.csv"),
        temp_annotation_file=os.path.join(root, "anns.csv"),
        temp_data_file=os.path.join(root, "data.npy"),
        save_dir=os.path.join(root, "models"), summary_dir=os.path.join(root, "summary"),
        max_steps=TRAIN_STEPS, save_period=TRAIN_SAVE, log_every=TRAIN_LOG,
        test_image_dir=os.path.join(tmp, "test", "images"),
        test_result_dir=os.path.join(root, "test_results"),
        test_result_file=os.path.join(root, "test_results.csv"),
    )


def metrics_rows(np, config, where: str):
    with open(os.path.join(config.summary_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    for r in rows:
        bad = [k for k, v in r.items() if k not in ("step", "wall_time", "mono_ns", "run_id")
               and not (isinstance(v, float) and np.isfinite(v))]
        if bad:
            fail(f"{where}: metrics.jsonl row of step {r['step']} has non-finite {bad}")
    return rows


def train_phase(np, config, card: str):
    """``python -m sat_tpu_torch.cli --phase train --config train.json`` in
    a fresh process at full width, 60 steps: exit 0, the train step
    launches neither kernel, 20/40/60.npz verify, LAST_GOOD 60, every
    metrics row finite and the loss falls; then ``--load`` to step 80 (the
    resume starts at 60, 80.npz holds the names 60.npz holds); then
    ``--phase test`` on 7 JPEGs with the trained checkpoint."""
    import csv

    from sat_tpu_torch.resilience import lineage
    from sat_tpu_torch.train.checkpoint import load_flat

    write_vocabulary(np, config.vocabulary_file, config.vocabulary_size, caption_words())
    path = os.path.join(os.path.dirname(config.save_dir), "train.json")
    config.save(path)
    tally, stdout = run_cli(["--phase", "train", "--config", path], "train")
    if tally["launches"] or tally["masked"]:
        fail(f"train: the train loop launched fused_attend {tally['launches']} / masked "
             f"{tally['masked']} times")
    steps = lineage.checkpoint_steps(config.save_dir)
    if steps != [20, 40, 60] or lineage.last_good_step(config.save_dir) != TRAIN_STEPS:
        fail(f"train: checkpoints {steps}, LAST_GOOD {lineage.last_good_step(config.save_dir)}")
    for step in steps:
        ok, reason = lineage.verify_checkpoint(os.path.join(config.save_dir, f"{step}.npz"))
        if not ok:
            fail(f"train: {step}.npz does not verify: {reason}")
    rows = metrics_rows(np, config, "train")
    if [r["step"] for r in rows] != list(range(TRAIN_LOG, TRAIN_STEPS + 1, TRAIN_LOG)):
        fail(f"train: metrics.jsonl steps {[r['step'] for r in rows]}")
    # 6 logged rows: the mean of the last 3 (steps 40-60) against the first 3
    losses = [r["total_loss"] for r in rows]
    first, last = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
    if not last < first:
        fail(f"train: total_loss did not fall: {losses}")
    print(f"train flagship on {card}: {TRAIN_STEPS} steps through the CLI in {tally['wall_s']:.2f}s "
          f"(process start to exit); total_loss at steps 10..60 {[round(x, 4) for x in losses]} "
          f"(mean {first:.4f} -> {last:.4f}); checkpoints {steps} verify, LAST_GOOD 60; fused_attend "
          f"launches 0, masked 0", flush=True)

    resumed, stdout = run_cli(["--phase", "train", "--config", path, "--load", "--set", "max_steps=80"],
                              "train resume")
    if "(step 60)" not in stdout:
        fail(f"train resume: did not restore step 60:\n{stdout[-2000:]}")
    rows = metrics_rows(np, config, "train resume")
    if [r["step"] for r in rows][-2:] != [70, 80] or lineage.last_good_step(config.save_dir) != 80:
        fail(f"train resume: metrics steps {[r['step'] for r in rows]}, LAST_GOOD "
             f"{lineage.last_good_step(config.save_dir)}")
    names60 = set(load_flat(os.path.join(config.save_dir, "60.npz")))
    names80 = set(load_flat(os.path.join(config.save_dir, "80.npz")))
    if names60 != names80:
        fail(f"train resume: 80.npz names differ from 60.npz's: {sorted(names60 ^ names80)[:6]}")
    print(f"train resume on {card}: --load from step 60 to 80 in {resumed['wall_s']:.2f}s; 80.npz holds "
          f"the {len(names80)} names of 60.npz; total_loss at 70, 80: "
          f"{[round(r['total_loss'], 4) for r in rows[-2:]]}", flush=True)

    model = os.path.join(config.save_dir, "80.npz")
    test_cfg = os.path.join(os.path.dirname(config.save_dir), "test.json")
    config.replace(phase="test", max_steps=0).save(test_cfg)
    tested, _ = run_cli(["--config", test_cfg, "--model_file", model], "train test")
    check_tally(tested, "train test", batches=1)
    with open(config.test_result_file, newline="") as f:
        captions = list(csv.DictReader(f))
    if len(captions) != 7:
        fail(f"train test: results.csv has {len(captions)} rows, expected 7")
    print(f"train test on {card}: --phase test with the trained 80.npz on 7 JPEGs, results.csv 7 rows; "
          f"fused_attend launches {tested['launches']} over {tested['steps']} steps; sample "
          f"{captions[0]['caption']!r}", flush=True)
    return tested["launches"]


def train_flops(config) -> float:
    """FLOPs of one flagship train step from its shapes: the frozen VGG16
    forward, and the decoder's forward and backward over T steps.  In
    the backward, ``fc_1a`` needs only its weight gradient (its input,
    the dropped-out contexts, takes none); every other dense layer needs
    both (2 × its forward)."""
    from sat_tpu_torch.models.vgg16 import VGG_LAYERS

    B, T, S = config.batch_size, config.max_caption_length, config.image_size
    cnn, cin, size = 0, 3, S
    for _name, cout, pool in VGG_LAYERS:
        cnn += size * size * 9 * cin * cout
        cin = cout
        if pool:
            size = -(-size // 2)
    N, D, da = config.num_ctx, config.dim_ctx, config.dim_attend_layer
    H, E, dd, V = config.num_lstm_units, config.dim_embedding, config.dim_decode_layer, config.vocabulary_size
    fc_1a = N * D * da
    rest = da * H + N * da + N * D + (D + E + H) * 4 * H + (H + D + E) * dd + dd * V
    decoder = T * (fc_1a * 2 + rest * 3)  # MACs, forward and backward
    return 2.0 * B * (cnn + decoder)


def train_steady_phase(torch, np, fa, config, card: str):
    """``runtime.train`` in-process at full width: 10 steps to warm, 30
    steps timed one by one (each ends in ``torch.cuda.synchronize``; the
    median), then 5 under torch.profiler (the card's busy share and top
    kernels), peak memory; then 5 steps driven by hand on one batch, the
    host time of forward, backward, update and the drain to the device
    apart; then one eval-loss step at full width with the launch counts
    zeroed just before and read just after (B1 once a decode step).
    Returns the eval-loss step's B1 launches."""
    from torch.profiler import ProfilerActivity, profile

    from sat_tpu_torch import runtime
    from sat_tpu_torch.data.dataset import prepare_train_data
    from sat_tpu_torch.train.step import make_eval_loss_step

    warm, timed, profiled = 10, 30, 5
    config = config.replace(
        save_dir=os.path.join(os.path.dirname(config.save_dir), "steady_models"),
        summary_dir=os.path.join(os.path.dirname(config.summary_dir), "steady_summary"),
        max_steps=warm + timed + profiled, save_period=0,
    )
    ends = []
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    real = runtime.make_train_step

    def timed_step(cfg):
        step = real(cfg)

        def run(state, batch, generator):
            if state.step == warm + timed:
                prof.__enter__()
            out = step(state, batch, generator)
            torch.cuda.synchronize()
            ends.append(time.perf_counter())
            if out[0].step == warm + timed + profiled:
                prof.__exit__(None, None, None)
            return out

        return run

    runtime.make_train_step = timed_step
    torch.cuda.reset_peak_memory_stats()
    try:
        state = runtime.train(config, device="cuda")
    finally:
        runtime.make_train_step = real
    peak = torch.cuda.max_memory_allocated()
    if state.step != warm + timed + profiled or len(ends) != state.step:
        fail(f"train steady: ran {state.step} steps, timed {len(ends)}")
    gaps = [b - a for a, b in zip(ends[warm - 1 : warm + timed - 1], ends[warm : warm + timed])]
    median = statistics.median(gaps)
    prof_wall = ends[-1] - ends[warm + timed - 1]
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    if busy == 0:
        fail("train steady: torch.profiler recorded no device time")
    flops = train_flops(config)
    print(f"train steady flagship on {card}: median step {median * 1e3:.2f} ms over {timed} warm steps "
          f"(min {min(gaps) * 1e3:.2f}, max {max(gaps) * 1e3:.2f}; each step ends in "
          f"torch.cuda.synchronize), {config.batch_size / median:.1f} training pairs/s; peak memory "
          f"{peak / 2**30:.2f} GiB (max_memory_allocated); {flops / 1e12:.3f} TFLOP a step from the "
          f"shapes, {flops / median / 1e12:.2f} TFLOP/s = {flops / median / 989e12:.2%} of 989 TFLOP/s "
          f"bf16", flush=True)
    print(f"profile train steady on {card}: {profiled} steps, wall {prof_wall:.3f}s under the profiler, "
          f"device busy {busy:.3f}s ({busy / prof_wall:.1%} of that wall)", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"profile train kernel {e.self_device_time_total / 1e3:8.3f} ms x{e.count:<5d} {e.key[:90]}",
              flush=True)

    dataset = prepare_train_data(config)
    loader = runtime.make_loader(config, dataset)
    feed = runtime.device_prefetch(loader, runtime.resolve_device("cuda"))
    try:
        batch = next(iter(feed))
    finally:
        feed.close()
    # where a step's host time goes: 5 steps driven by hand on this one
    # device batch, each part timed by the host clock (the card is idle
    # most of a step, so the enqueue time of a part is close to its wall)
    from sat_tpu_torch.models.captioner import compute_loss
    from sat_tpu_torch.train.optimizer import _leaves, make_optimizer
    from sat_tpu_torch.train.step import _like, split_trainable, step_generator

    optimizer = make_optimizer(config)
    trainable, _ = split_trainable(state.params, config)
    parts = {"forward": [], "backward": [], "update": [], "drain": []}
    for s in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        total, _ = compute_loss(state.params, config, batch, step_generator(SEED, s, batch["images"].device))
        t1 = time.perf_counter()
        grads = torch.autograd.grad(total, _leaves(trainable))
        t2 = time.perf_counter()
        optimizer.step(trainable, _like(trainable, grads), state.opt_state)
        t3 = time.perf_counter()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        if s:  # the first warms the allocator for this batch
            for k, v in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                parts[k].append(v * 1e3)
    split = ", ".join(f"{k} {statistics.median(v):.2f} ms" for k, v in parts.items())
    print(f"train host split on {card} (median of 5 hand-driven steps on one batch, host clock): {split}; "
          f"sum {sum(statistics.median(v) for v in parts.values()):.2f} ms", flush=True)

    fa.fused_attend.launches = fa.fused_attend.masked_launches = 0
    metrics = make_eval_loss_step(config)(state, batch)
    torch.cuda.synchronize()
    launches, masked = fa.fused_attend.launches, fa.fused_attend.masked_launches
    if launches != config.max_caption_length or masked:
        fail(f"train steady: the eval-loss step launched fused_attend {launches} times (masked {masked}), "
             f"expected T={config.max_caption_length}")
    values = {k: round(float(v), 4) for k, v in metrics.items()}
    if not all(np.isfinite(v) for v in values.values()):
        fail(f"train steady: eval-loss metrics not finite: {values}")
    print(f"train eval-loss flagship on {card}: B1 launched {launches} times (T), masked 0; metrics {values}",
          flush=True)
    return launches


# -- ResNet50, the reference formats and the quantized encoder ------------------

def resnet50_config(tmp: str):
    """The flagship with the repo's other encoder: ResNet50 at 224 px
    (N=49, D=2048) and every other ``Config`` default."""
    return flagship_config(tmp).replace(
        cnn="resnet50", save_dir=os.path.join(tmp, "r50", "models"),
        vocabulary_file=os.path.join(tmp, "r50", "vocabulary.csv"),
    )


def resnet50_reference_phase(torch, np, fa, tmp: str):
    """The small float32 ResNet50 (64 px, N=4, D=2048) on the card and on
    the CPU: contexts within 1e-4 of max|ctx| (cuDNN's float32 convs, TF32
    off, against the CPU's), the same words in batch mode with log-probs
    within 1e-5 relative, B1 launched on the card's run only; then the
    continuous path (B2) as for VGG16."""
    from sat_tpu_torch.config import Config
    from sat_tpu_torch.data.vocabulary import Vocabulary
    from sat_tpu_torch.serve.engine import ServeEngine, load_serving_state

    config = Config(
        cnn="resnet50", image_size=64, dim_embedding=16, num_lstm_units=16, dim_initialize_layer=16,
        dim_attend_layer=16, dim_decode_layer=32, vocabulary_size=50, compute_dtype="float32",
        beam_size=3, serve_buckets=(4,), serve_max_batch=4,
        save_dir=os.path.join(tmp, "r50_small"), vocabulary_file=os.path.join(tmp, "r50_small.csv"),
    )
    write_vocabulary(np, config.vocabulary_file, config.vocabulary_size)
    write_checkpoint(np, config, config.save_dir, step=1, seed=SEED + 60, bias_shift={1: -2.0})
    vocab = Vocabulary(config.vocabulary_size, config.vocabulary_file)
    res, contexts, launched = {}, {}, {}
    for dev in ("cuda", "cpu"):
        engine = ServeEngine(config, load_serving_state(config, device=dev)[0], vocab, device=dev)
        images = np.stack([engine.preprocess(b) for b in jpegs(np, 4, 96, SEED + 61)])
        contexts[dev] = engine.encode_images(images).float().cpu().numpy()
        before = fa.fused_attend.launches
        res[dev] = engine.drain_output(engine.dispatch(images), 4)
        launched[dev] = fa.fused_attend.launches - before
    if contexts["cuda"].shape != (4, 4, 2048):
        fail(f"resnet50 reference: contexts of shape {contexts['cuda'].shape}")
    ctx_err = float(np.abs(contexts["cuda"] - contexts["cpu"]).max() / np.abs(contexts["cpu"]).max())
    if not ctx_err <= 1e-4:
        fail(f"resnet50 reference: contexts differ by {ctx_err:.3e} of max|ctx| (tol 1e-4)")
    if not np.array_equal(res["cuda"][0], res["cpu"][0]) or not np.array_equal(res["cuda"][1], res["cpu"][1]):
        fail(f"resnet50 reference: words differ between cuda and cpu:\n{res['cuda'][0]}\n{res['cpu'][0]}")
    err = float((np.abs(res["cuda"][2] - res["cpu"][2]) / np.abs(res["cpu"][2])).max())
    if not err <= 1e-5:
        fail(f"resnet50 reference: log-prob max rel err {err:.3e} over 1e-5")
    if launched["cuda"] == 0 or launched["cpu"] != 0:
        fail(f"resnet50 reference: B1 launched {launched['cuda']} times on cuda, {launched['cpu']} on cpu")
    print(f"resnet50 reference float32 small model (64 px, N=4, D=2048): contexts cuda vs cpu "
          f"{ctx_err:.3e} of max|ctx| (tol 1e-4); cuda == cpu words, log-prob max rel err {err:.3e} "
          f"(tol 1e-5); B1 launched {launched['cuda']} times on cuda, 0 on cpu", flush=True)
    continuous_reference(np, config.replace(serve_mode="continuous", serve_slot_pages=2,
                                            serve_page_width=2), vocab, images)


def resnet50_bulk(np, tmp: str, config, card: str):
    """``--phase bulk`` through the CLI over the bulk phase's corpus (the
    steady fixture's JPEGs and one file that is not a JPEG) with the
    ResNet50 checkpoint: one row a file with finite captions, B2 launched
    and B1 not.  Returns the B2 launches."""
    root = os.path.join(tmp, "r50_bulk")
    corpus = os.path.join(tmp, "bulk", "corpus")
    bulk = config.replace(phase="bulk", bulk_input=corpus, bulk_output=os.path.join(root, "out"),
                          summary_dir=os.path.join(root, "summary"))
    os.makedirs(root)
    path = os.path.join(root, "bulk.json")
    bulk.save(path)
    tally, _ = run_cli(["--config", path], "resnet50 bulk")
    if tally["masked"] == 0 or tally["launches"] != 0:
        fail(f"resnet50 bulk: B2 launched {tally['masked']} times, B1 {tally['launches']}")
    rows = [json.loads(line) for n in sorted(os.listdir(bulk.bulk_output)) if n.endswith(".jsonl")
            for line in open(os.path.join(bulk.bulk_output, n))]
    if len(rows) != len(os.listdir(corpus)) or not all(
            len(r["captions"]) == bulk.beam_size and all(np.isfinite(c["log_prob"]) for c in r["captions"])
            for r in rows):
        fail(f"resnet50 bulk: {len(rows)} rows for {len(os.listdir(corpus))} files, or a malformed row")
    with open(os.path.join(bulk.summary_dir, "telemetry", "heartbeat.json")) as f:
        gauges = json.load(f)["bulk"]
    print(f"resnet50 bulk bf16 on {card}: {len(rows)} files, process start to exit {tally['wall_s']:.2f}s; "
          f"captions/s {gauges['captions_per_s']}, bulk/device_ms_per_image "
          f"{gauges['device_ms_per_image']}, decode steps {gauges['decode_steps']}; B2 launches "
          f"{tally['masked']}, B1 0", flush=True)
    return tally["masked"]


def resnet50_eval_phase(np, tmp: str, card: str):
    """``--phase eval`` through the CLI on the eval phase's fixture (48
    JPEGs, 96 ids, 5 batches of 20) with a full-width ResNet50 checkpoint:
    B1 once a decode step, one row an image, seven finite scores.
    Returns the B1 launches."""
    config = eval_config(tmp).replace(
        cnn="resnet50", save_dir=os.path.join(tmp, "eval", "r50_models"),
        eval_result_file=os.path.join(tmp, "eval", "r50_results.json"),
        eval_result_dir=os.path.join(tmp, "eval", "r50_results"),
    )
    favour = {i: 4.0 for i in range(2, 2 + len(caption_words()))}
    write_checkpoint(np, config, config.save_dir, step=1000, seed=SEED + 62, bias_shift=favour)
    path = os.path.join(tmp, "eval", "r50_eval.json")
    config.save(path)
    tally, stdout = run_cli(["--config", path], "resnet50 eval")
    check_tally(tally, "resnet50 eval", batches=5)
    scores = printed_scores(np, stdout, "resnet50 eval")
    with open(config.eval_result_file) as f:
        rows = json.load(f)
    if sorted(r["image_id"] for r in rows) != list(range(1, 49)):
        fail(f"resnet50 eval: results.json has {len(rows)} rows, not one for each of the 48 images")
    decode_s = tally["decode_s"][0]
    print(f"resnet50 eval flagship bf16 on {card}: 48 images (5 batches of 20) in {tally['wall_s']:.2f}s "
          f"(process start to exit); decode {decode_s:.3f}s ({48 / decode_s:.1f} images/s, first use in "
          f"the process); {tally['steps']} decode steps, B1 launches {tally['launches']}, B2 "
          f"{tally['masked']}; scores (random weights) {scores}", flush=True)
    return tally["launches"]


R50_TRAIN_STEPS, R50_TRAIN_SAVE, R50_TRAIN_LOG, R50_TRAIN_WARM = 20, 10, 5, 10


def resnet50_train_phase(torch, np, tmp: str, card: str):
    """``--train_cnn`` at full width (ResNet50, batch 20, every other
    training default) on the steady fixture: ``runtime.train`` in-process
    for 20 steps, each ending in ``torch.cuda.synchronize`` (the median of
    the 10 after the first 10), peak memory; checkpoints 10 and 20 verify
    and hold ``batch_stats/``, which moved between them; the loss finite
    and falling; then ``python -m sat_tpu_torch.cli --phase train
    --train_cnn --load`` from a copy holding 10.npz alone, to 20: its
    20.npz against the in-process one (bitwise, or the largest difference
    printed; cuDNN's backward convs need not be deterministic)."""
    import shutil

    from sat_tpu_torch import runtime
    from sat_tpu_torch.resilience import lineage
    from sat_tpu_torch.train.checkpoint import load_flat

    root = os.path.join(tmp, "r50_train")
    config = train_config(os.path.join(tmp, "steady"), tmp).replace(
        cnn="resnet50", train_cnn=True, save_dir=os.path.join(root, "models"),
        summary_dir=os.path.join(root, "summary"), max_steps=R50_TRAIN_STEPS,
        save_period=R50_TRAIN_SAVE, log_every=R50_TRAIN_LOG,
    )
    ends = []
    real = runtime.make_train_step

    def timed_step(cfg):
        step = real(cfg)

        def run(state, batch, generator):
            out = step(state, batch, generator)
            torch.cuda.synchronize()
            ends.append(time.perf_counter())
            return out

        return run

    runtime.make_train_step = timed_step
    torch.cuda.reset_peak_memory_stats()
    try:
        state = runtime.train(config, device="cuda")
    finally:
        runtime.make_train_step = real
    peak = torch.cuda.max_memory_allocated()
    if state.step != R50_TRAIN_STEPS or len(ends) != R50_TRAIN_STEPS:
        fail(f"resnet50 train: ran {state.step} steps, timed {len(ends)}")
    gaps = [b - a for a, b in zip(ends[R50_TRAIN_WARM - 1:-1], ends[R50_TRAIN_WARM:])]
    median = statistics.median(gaps)
    steps = lineage.checkpoint_steps(config.save_dir)
    if steps != [10, 20]:
        fail(f"resnet50 train: checkpoints {steps}")
    flats = {}
    for step in steps:
        path = os.path.join(config.save_dir, f"{step}.npz")
        ok, reason = lineage.verify_checkpoint(path)
        if not ok:
            fail(f"resnet50 train: {step}.npz does not verify: {reason}")
        flats[step] = load_flat(path)
    stats = [k for k in flats[20] if k.startswith("batch_stats/")]
    moved = [k for k in stats if not np.array_equal(flats[10][k], flats[20][k])]
    if len(stats) != 106 or set(stats) - set(flats[10]) or len(moved) != len(stats):
        fail(f"resnet50 train: {len(stats)} batch_stats entries, {len(moved)} moved between 10 and 20")
    rows = metrics_rows(np, config, "resnet50 train")
    losses = [r["total_loss"] for r in rows]
    if [r["step"] for r in rows] != [5, 10, 15, 20] or not losses[-1] < losses[0]:
        fail(f"resnet50 train: metrics steps {[r['step'] for r in rows]}, total_loss {losses}")
    print(f"resnet50 train --train_cnn flagship on {card}: median step {median * 1e3:.2f} ms over "
          f"{len(gaps)} warm steps (min {min(gaps) * 1e3:.2f}, max {max(gaps) * 1e3:.2f}), "
          f"{config.batch_size / median:.1f} training pairs/s; peak memory {peak / 2**30:.2f} GiB; "
          f"total_loss at 5..20 {[round(x, 4) for x in losses]}; checkpoints {steps} verify, each with "
          f"{len(stats)} batch_stats entries, all moved between 10 and 20", flush=True)

    resumed = os.path.join(root, "resumed")
    shutil.copytree(config.save_dir, resumed)
    for name in os.listdir(resumed):
        if name.startswith("20.npz"):
            os.remove(os.path.join(resumed, name))
    lineage.mark_last_good(resumed, 10)
    path = os.path.join(root, "resume.json")
    config.replace(save_dir=resumed, summary_dir=os.path.join(root, "resumed_summary")).save(path)
    tally, stdout = run_cli(["--phase", "train", "--config", path, "--train_cnn", "--load"], "resnet50 resume")
    if "(step 10)" not in stdout:
        fail(f"resnet50 resume: did not restore step 10:\n{stdout[-2000:]}")
    again = load_flat(os.path.join(resumed, "20.npz"))
    if set(again) != set(flats[20]):
        fail("resnet50 resume: 20.npz names differ from the uninterrupted run's")
    diff = max(float(np.abs(again[k].astype(np.float64) - flats[20][k]).max()) for k in again)
    if not diff <= 1e-2:
        fail(f"resnet50 resume: 20.npz differs from the uninterrupted run's by {diff:.3e}")
    print(f"resnet50 resume on {card}: --train_cnn --load from 10.npz to 20 through the CLI in "
          f"{tally['wall_s']:.2f}s; 20.npz against the uninterrupted run's: "
          f"{'bitwise' if diff == 0 else f'max abs diff {diff:.3e}'}", flush=True)
    return config


def write_resnet50_no_fc(np, path: str, seed: int):
    """A layout-exact ``resnet50_no_fc.npy`` (the reference's nested
    caffe-export format: 53 bias-free convs as ``weights`` HWIO, 53 batch
    norms as ``mean``/``variance``/``scale``/``offset``) from ``seed``;
    returns the nested dict."""
    from sat_tpu_torch.models.resnet50 import conv_specs

    rng = np.random.default_rng(seed)
    nested = {}
    for _block, conv, bn, k, cin, cout, _stride in conv_specs():
        nested[conv] = {"weights": rng.normal(0, (2.0 / (k * k * cin)) ** 0.5, (k, k, cin, cout)).astype(np.float32)}
        nested[bn] = {
            "mean": rng.normal(0, 0.1, cout).astype(np.float32),
            "variance": rng.uniform(0.5, 1.5, cout).astype(np.float32),
            "scale": rng.uniform(0.9, 1.1, cout).astype(np.float32),
            "offset": rng.normal(0, 0.01, cout).astype(np.float32),
        }
    np.save(path, np.array(nested, dtype=object), allow_pickle=True)
    return nested


def import_phase(np, config, card: str):
    """A layout-exact ``resnet50_no_fc.npy`` through ``--phase train
    --load_cnn --cnn_model_file`` (5 steps, CNN frozen): all 265 tensors
    imported and carried unchanged into 5.npz; then that state exported
    with ``export_reference_checkpoint`` to the reference's flat npy, and
    ``--phase test --model_file x.npy`` captions the 7 test JPEGs with it
    (B1 once a decode step).  Returns the B1 launches."""
    import csv

    from sat_tpu_torch.train.checkpoint import export_reference_checkpoint, load_flat, state_from_flat

    root = os.path.join(os.path.dirname(os.path.dirname(config.save_dir)), "r50_import")
    os.makedirs(root)
    npy = os.path.join(root, "resnet50_no_fc.npy")
    nested = write_resnet50_no_fc(np, npy, SEED + 63)
    train = config.replace(train_cnn=False, save_dir=os.path.join(root, "models"),
                           summary_dir=os.path.join(root, "summary"), max_steps=5, save_period=5, log_every=5)
    path = os.path.join(root, "train.json")
    train.save(path)
    tally, stdout = run_cli(["--phase", "train", "--config", path, "--load_cnn", "--cnn_model_file", npy],
                            "import train")
    if "265 pretrained CNN tensors loaded." not in stdout:
        fail(f"import train: the CNN import did not load 265 tensors:\n{stdout[-2000:]}")
    flat = load_flat(os.path.join(train.save_dir, "5.npz"))
    checks = {"params/cnn/res4c/res4c_branch2b/conv/kernel": nested["res4c_branch2b"]["weights"],
              "params/cnn/bn_conv1/bias": nested["bn_conv1"]["offset"],
              "batch_stats/res3a/bn3a_branch1/var": nested["bn3a_branch1"]["variance"]}
    for name, want in checks.items():
        if not np.array_equal(flat[name], want):
            fail(f"import train: {name} in 5.npz is not the imported tensor")
    state = state_from_flat(flat, train, "cuda", "5.npz")
    ref = os.path.join(root, "exported.npy")
    count = export_reference_checkpoint(state, ref)
    test = train.replace(phase="test", test_result_dir=os.path.join(root, "test_results"),
                         test_result_file=os.path.join(root, "test_results.csv"))
    test_path = os.path.join(root, "test.json")
    test.save(test_path)
    tested, stdout = run_cli(["--config", test_path, "--model_file", ref], "import test")
    check_tally(tested, "import test", batches=1)
    if f"{count} tensors loaded from checkpoint" not in stdout:
        fail(f"import test: the exported npy did not load its {count} tensors:\n{stdout[-2000:]}")
    with open(test.test_result_file, newline="") as f:
        captions = list(csv.DictReader(f))
    if len(captions) != 7:
        fail(f"import test: results.csv has {len(captions)} rows, expected 7")
    print(f"import on {card}: resnet50_no_fc.npy (265 tensors) through --load_cnn into a 5-step train "
          f"({tally['wall_s']:.2f}s), carried unchanged into 5.npz; exported {count} tensors to the "
          f"reference's npy; --phase test --model_file exported.npy: 7 captions, B1 launches "
          f"{tested['launches']} over {tested['steps']} steps; sample {captions[0]['caption']!r}", flush=True)
    return tested["launches"]


# tests/test_quant.py's context-divergence gate of the JAX package (max
# |quantized - float32| over max|float32|), the bound a quantized encoder
# is held to there
CTX_BOUNDS = {"int8": 0.10, "bf16": 0.05}


def encoder_quant_phase(torch, np, tmp: str, card: str):
    """Both flagship checkpoints (VGG16 and ResNet50, bf16) served with
    ``encoder_quant`` off, bf16 and int8: quantized once at engine load
    (seconds printed), contexts of a bucket-32 batch within the JAX
    package's gate of the unquantized ones, the caption agreement with
    the unquantized path over 36 images, the encode time of a bucket-32
    batch beside ``off``; one int8 conv's int32 accumulators on the card
    bitwise the CPU's; and a candidate's int8 ``qcnn`` from its host tree
    bitwise that of the tree moved whole to the card, with the seconds
    and the peak device memory of both."""
    from sat_tpu_torch.data.vocabulary import Vocabulary
    from sat_tpu_torch.lifecycle.loader import load_candidate
    from sat_tpu_torch.models.captioner import _preprocess
    from sat_tpu_torch.nn import quant
    from sat_tpu_torch.resilience import lineage
    from sat_tpu_torch.serve.engine import ServeEngine, load_serving_state
    from sat_tpu_torch.train import checkpoint

    bodies = jpegs(np, 36, 256, SEED + 3)
    for config in (flagship_config(tmp), resnet50_config(tmp)):
        cnn = config.cnn
        state, _ = load_serving_state(config, device="cuda")
        vocab = Vocabulary(config.vocabulary_size, config.vocabulary_file)
        out = {}
        for mode in ("off", "bf16", "int8"):
            engine = ServeEngine(config.replace(encoder_quant=mode), state, vocab, device="cuda")
            images = np.stack([engine.preprocess(b) for b in bodies])
            ctx = engine.encode_images(images[:32])
            times = []
            for _ in range(6):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engine.encode_images(images[:32])
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            words = np.concatenate([engine.drain_output(engine.dispatch(engine.pad_batch(list(chunk))[0]), len(chunk))[0]
                                    for chunk in (images[:32], images[32:])])
            out[mode] = dict(ctx=ctx.float(), ms=statistics.median(times[1:]), words=words,
                             seconds=engine.quantize_seconds, engine=engine)
        base = out["off"]
        scale = float(base["ctx"].abs().max())
        for mode in ("bf16", "int8"):
            rel = float((out[mode]["ctx"] - base["ctx"]).abs().max()) / scale
            if not rel <= CTX_BOUNDS[mode]:
                fail(f"encoder_quant {cnn} {mode}: contexts diverge by {rel:.3e} of max|ctx| "
                     f"(the JAX package's gate: {CTX_BOUNDS[mode]})")
            top = float(np.mean([np.array_equal(a[0], b[0]) for a, b in zip(out[mode]["words"], base["words"])]))
            print(f"encoder_quant {cnn} {mode} on {card}: quantized at load in {out[mode]['seconds']:.2f}s; "
                  f"contexts {rel:.3e} of max|ctx| from off (gate {CTX_BOUNDS[mode]}); best caption "
                  f"identical to off for {top:.0%} of 36 images; encode of a bucket-32 batch "
                  f"{out[mode]['ms']:.2f} ms vs off {base['ms']:.2f} ms (host clock, synchronized, median "
                  f"of 5)", flush=True)
        qcnn = out["int8"]["engine"]._params["qcnn"]
        first = "conv1_1" if cnn == "vgg16" else "conv1"
        spec, stride = qcnn[first], 1 if cnn == "vgg16" else 2
        x = _preprocess(torch.from_numpy(np.stack([out["int8"]["engine"].preprocess(b) for b in bodies[:8]])))
        x = x.permute(0, 3, 1, 2)
        xq = torch.clamp(torch.round(x / spec["act_scale"]), -127, 127).to(torch.int8)
        on_card = quant.int8_conv(xq.cuda(), spec["kernel"], stride).cpu()
        on_cpu = quant.int8_conv(xq, spec["kernel"].cpu(), stride)
        if not torch.equal(on_card, on_cpu):
            fail(f"encoder_quant {cnn}: int8 accumulators of {first} differ between card and CPU by "
                 f"{int((on_card - on_cpu).abs().max())}")
        print(f"encoder_quant {cnn} int8 {first} on 8 images: int32 accumulators {tuple(on_card.shape)} "
              f"bitwise the CPU's (max |acc| {int(on_card.abs().max())})", flush=True)
        # C13: the whole tree moved to the card and quantized there (how
        # slot_params took a host tree before C13), beside the same tree
        # left on the host and folded on the card one conv at a time, and
        # the lifecycle loader's candidate: every qcnn bitwise the
        # incumbent's, which was quantized from a tree already on the card
        engine = out["int8"]["engine"]
        path = lineage.last_good_checkpoint(config.save_dir)
        flat = checkpoint.load_flat(path)
        params = checkpoint.params_from_flat(flat, config, "cpu")
        stats = checkpoint.batch_stats_from_flat(flat, config, "cpu")

        def measured(fn):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            result = fn()
            torch.cuda.synchronize()
            return result, time.perf_counter() - t0, (torch.cuda.max_memory_allocated() - before) / 2**20

        with engine.on_device():
            whole, whole_s, whole_mib = measured(
                lambda: engine.slot_params(checkpoint.to_device(params, engine.device),
                                           checkpoint.to_device(stats, engine.device)))
            del whole["decoder"]
            host, host_s, host_mib = measured(lambda: engine.slot_params(params, stats))
        staged = load_candidate(engine, engine.config, path)
        for what, tree in (("whole tree quantized on the card", whole["qcnn"]),
                           ("host tree folded on the card", host["qcnn"]),
                           ("loader's candidate", staged["variables"]["qcnn"])):
            for name, spec in qcnn.items():
                for key, value in spec.items():
                    other = tree[name][key]
                    same = torch.equal(value, other) if isinstance(value, torch.Tensor) else value == other
                    if not same:
                        fail(f"encoder_quant {cnn}: the {what}: qcnn {name}/{key} differs from the incumbent's")
        print(f"encoder_quant {cnn} int8 on {card}, C13: a checkpoint's qcnn bitwise the incumbent's "
              f"({len(qcnn)} convs) when the whole tree is moved to the card first, when the host tree is "
              f"folded on the card one conv at a time, and through the loader ({staged['load_seconds']:.2f}s "
              f"with the file read); slot_params {whole_s:.2f}s and peak device memory +{whole_mib:.1f} MiB "
              f"with the whole tree moved, {host_s:.2f}s and +{host_mib:.1f} MiB from the host tree",
              flush=True)
        del staged, whole, host
        del out


# -- route and supervise (the fleet router and the crash-only supervisor) ----

ROUTE_ALONE = 12   # images sent one at a time, through the router and to one server


def free_base_port(n: int) -> int:
    """A port with the ``n - 1`` ports after it free too (best-effort: the
    ports are released before the fleet binds them)."""
    import socket

    for _ in range(64):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        if base + n > 65535:
            continue
        socks = []
        try:
            for port in range(base, base + n):
                socks.append(socket.socket())
                socks[-1].bind(("127.0.0.1", port))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    fail("no run of free ports on 127.0.0.1")


def child_pids(parent: int) -> dict:
    """{replica name: pid} of the ``--phase serve`` children a router
    process started (their command names ``replica_<i>``)."""
    out = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            if ppid != parent:
                continue
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmd = f.read().decode(errors="replace")
        except (OSError, ValueError, IndexError):
            continue
        for i in range(8):
            if f"replica_{i}" in cmd:
                out[f"r{i}"] = int(entry)
    return out


def pid_alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def stop_groups(procs) -> None:
    """SIGKILL each process's group (the process and whatever it spawned
    and did not stop); a group already empty is skipped."""
    for p in procs:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        p.wait(10)


def wait_for(predicate, limit_s: float, what: str, poll_s: float = 0.1):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < limit_s:
        value = predicate()
        if value:
            return time.perf_counter() - t0
        time.sleep(poll_s)
    fail(f"{what} (waited {limit_s:.0f}s)")


def replica_counts(port: int, where: str):
    """(B1 launches, B2 launches) a replica reports on /stats; fails unless
    it serves from ``cuda:0``."""
    stats = get_stats(port)
    if stats.get("device") != "cuda:0":
        fail(f"{where}: replica on port {port} reports device {stats.get('device')!r}, not 'cuda:0'")
    k = stats["kernels"]["fused_attend"]
    return k["launches"], k["masked_launches"]


def routable(port: int, n: int):
    try:
        status, payload = healthz(port)
    except (OSError, ValueError):
        return False
    return status == 200 and payload.get("replicas_routable") == n


def access_records(path: str):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def p50(replies) -> float:
    return statistics.median(r[-1] for r in replies)


def one_server_replies(np, config, mode: str, bodies):
    """One port server on the flagship checkpoint in ``mode``: the
    ``ROUTE_ALONE`` images sent one at a time, then 31 behind a lead."""
    from sat_tpu_torch import telemetry
    from sat_tpu_torch.data.vocabulary import Vocabulary
    from sat_tpu_torch.serve.engine import ServeEngine, load_serving_state
    from sat_tpu_torch.serve.server import CaptionServer

    cfg = config.replace(serve_mode=mode)
    telemetry.enable()
    state, _ = load_serving_state(cfg, device="cuda")
    engine = ServeEngine(cfg, state, Vocabulary(cfg.vocabulary_size, cfg.vocabulary_file), device="cuda")
    if mode == "batch":
        engine.warmup()
    server = CaptionServer(cfg, engine, port=0, host="127.0.0.1")
    try:
        server.start()
        alone = [post(server.port, bodies[i]) for i in range(ROUTE_ALONE)]
        lead, burst = post_all(server.port, bodies[4:35], lead=bodies[35])
    finally:
        server.shutdown()
        telemetry.disable()
    for status, payload, _ in alone + burst + [lead]:
        if status != 200:
            fail(f"route {mode}: the single server answered {status}: {payload}")
    return alone, burst


def route_phase(torch, np, config, card: str, mode: str, tmp: str):
    """``python -m sat_tpu_torch.cli --phase route --num_replicas 2`` over
    the flagship checkpoint in ``mode`` (batch: B1 in the replicas;
    continuous: B2).  Returns (B1, B2) launches the replicas counted
    between their readiness and their end."""
    from sat_tpu_torch.serve.replica import LocalFleet

    where = f"route {mode}"
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(tmp, f"route_{mode}")
    os.makedirs(root)
    bodies = jpegs(np, 36, 256, SEED + 3)
    single_alone, single_burst = one_server_replies(np, config, mode, bodies)
    torch.cuda.empty_cache()

    base, rport = free_base_port(2), free_base_port(1)
    cfg = config.replace(phase="route", serve_mode=mode, summary_dir=os.path.join(root, "summary"),
                         route_replica_base_port=base, route_poll_interval_s=0.2)
    cfg_path = os.path.join(root, "route.json")
    cfg.save(cfg_path)
    fleet_dir = os.path.join(cfg.summary_dir, "fleet")
    logs = [open(os.path.join(root, n), "w+") for n in ("router.out", "router.err")]
    t0 = time.perf_counter()
    # its own process group, which the replicas it spawns join: a failure
    # below stops them all at once
    proc = subprocess.Popen(
        [sys.executable, "-m", "sat_tpu_torch.cli", "--config", cfg_path, "--num_replicas", "2",
         "--port", str(rport)], cwd=here, stdout=logs[0], stderr=logs[1], start_new_session=True,
    )
    own = {}  # replicas this script starts itself (the respawn)

    def tail():
        logs[1].flush()
        logs[1].seek(0)
        return logs[1].read()[-3000:]

    try:
        while not routable(rport, 2):
            if proc.poll() is not None:
                fail(f"{where}: the router exited {proc.returncode} during boot:\n{tail()}")
            if time.perf_counter() - t0 > 300:
                fail(f"{where}: the fleet was not ready within 300s:\n{tail()}")
            time.sleep(0.1)
        boot_s = time.perf_counter() - t0
        pids = child_pids(proc.pid)
        if sorted(pids) != ["r0", "r1"]:
            fail(f"{where}: the router's children are {pids}, expected r0 and r1")
        ports = {"r0": base, "r1": base + 1}
        counts = {}  # incarnation -> [B1, B2] at readiness, then at its end
        for name, port in ports.items():
            counts[name] = [replica_counts(port, where), None]

        # traffic: ROUTE_ALONE alone, each with its own request id, then 31 behind a lead
        alone, rids = [], []
        for i in range(ROUTE_ALONE):
            rid = f"route-{mode}-{i}"
            status, payload, echoed, ms = caption(rport, bodies[i], rid)
            if status != 200 or echoed != rid or payload.get("request_id") != rid:
                fail(f"{where}: request {rid} got {status}, echoed {echoed!r}: {payload}")
            alone.append((status, payload, ms))
            rids.append(rid)
        lead, burst = post_all(rport, bodies[4:35], lead=bodies[35])
        check_replies(np, config, {"alone": alone, "burst": burst, "lead": [lead]}, where)
        lp = same_words([(a[1], s[1]) for a, s in zip(alone, single_alone)],
                        f"{where}: routed alone vs one server alone")
        agree = sum(identical_captions([(b[1], s[1])])[0] for b, s in zip(burst, single_burst))
        print(f"{where} on {card}: fleet of 2 ready in {boot_s:.2f}s (router start to both replicas "
              f"routable); {ROUTE_ALONE} images alone: the words of one port server alone, log-prob max abs "
              f"diff {lp:.2e}; 31 behind a lead: {agree}/31 with the one server's words in its own burst "
              f"(bf16 encode depends on the batch geometry, so counted, not required)", flush=True)
        print(f"{where} p50 request latency on {card} (client clock): through the router alone "
              f"{p50(alone):.2f} ms, 31 behind a lead {p50(burst):.2f} ms; one server alone "
              f"{p50(single_alone):.2f} ms, 31 behind a lead {p50(single_burst):.2f} ms", flush=True)

        # each id in the router's access log once, and in exactly one replica's
        router_log = os.path.join(cfg.summary_dir, "telemetry", "access.jsonl")
        replica_logs = {n: os.path.join(fleet_dir, f"replica_{n[1]}", "telemetry", "access.jsonl") for n in ports}

        def stitched():
            hops = [r for r in access_records(router_log) if r.get("trace_id") in rids]
            served = {n: {r.get("trace_id") for r in access_records(p)} for n, p in replica_logs.items()}
            if len(hops) != len(rids):
                return False
            for hop in hops:
                if hop.get("hop") != "route" or hop.get("status") != 200:
                    return False
                if [n for n, ids in served.items() if hop["trace_id"] in ids] != [hop.get("replica")]:
                    return False
            return True

        wait_for(stitched, 10, f"{where}: request ids do not stitch across the router and one replica")

        # SIGKILL r1 mid-burst: every request still answered, through the one retry
        counts["r1"][1] = replica_counts(ports["r1"], where)
        retries0 = get_stats(rport)["counters"].get("route/retries", 0)
        result = {}
        sender = threading.Thread(target=lambda: result.update(
            zip(("lead", "burst"), post_all(rport, bodies[4:35], lead=bodies[35]))))
        sender.start()
        # killed while it holds requests, so the router has some to retry
        wait_for(lambda: healthz(ports["r1"])[1]["in_flight"] > 0, 30,
                 f"{where}: r1 never held a request of the burst", poll_s=0.005)
        os.kill(pids["r1"], signal.SIGKILL)
        sender.join(timeout=600)
        codes = [r[0] for r in result.get("burst", [])] + [result["lead"][0]] if "lead" in result else []
        if len(codes) != 32 or any(c != 200 for c in codes):
            fail(f"{where}: a request failed while r1 was killed: {codes}")
        retries = get_stats(rport)["counters"].get("route/retries", 0) - retries0
        if retries < 1:
            fail(f"{where}: r1 was killed holding requests, yet the router retried none")
        wait_for(lambda: get_stats(rport)["replicas"]["r1"]["reachable"] is False, 10,
                 f"{where}: the fleet view does not show the killed r1 unreachable")
        # respawn it as the fleet respawns it: its command on its port
        t1 = time.perf_counter()
        log = open(os.path.join(root, "respawn_r1.log"), "w")
        own["r1"] = subprocess.Popen(
            LocalFleet.replica_argv(fleet_dir, 1),
            cwd=here, stdout=log, stderr=subprocess.STDOUT, start_new_session=True,
        )
        log.close()
        wait_for(lambda: routable(rport, 2), 300, f"{where}: the respawned r1 did not come back routable")
        respawn_s = time.perf_counter() - t1
        counts["r1'"] = [replica_counts(ports["r1"], where), None]
        print(f"{where}: r1 SIGKILLed in a burst of 32 while holding requests: 32/32 answered 200, "
              f"route/retries +{retries}; the fleet view showed r1 unreachable; respawned r1 routable again in "
              f"{respawn_s:.2f}s", flush=True)

        # drain r0: the router SIGTERMs it and sends everything to r1; then undrain
        counts["r0"][1] = replica_counts(ports["r0"], where)
        status, _, raw = http(rport, "POST", "/drain?replica=r0")
        if status != 200 or json.loads(raw).get("mechanism") != "sigterm":
            fail(f"{where}: POST /drain?replica=r0 gave {status} {raw!r}")
        wait_for(lambda: not pid_alive(pids["r0"]), 60, f"{where}: the drained r0 did not exit")
        wait_for(lambda: get_stats(rport)["replicas"]["r0"]["drain_state"] == "drained", 10,
                 f"{where}: r0 never reached 'drained'")
        routed = []
        for i in range(6):
            status, hdrs, raw = http(rport, "POST", "/caption", bodies[i], {"Content-Type": "image/jpeg"})
            routed.append((status, hdrs.get("X-Routed-Replica")))
        if any(r != (200, "r1") for r in routed):
            fail(f"{where}: with r0 drained, replies came from {routed}")
        status, _, raw = http(rport, "POST", "/undrain?replica=r0")
        if status != 200 or get_stats(rport)["replicas"]["r0"]["drain_state"] != "in":
            fail(f"{where}: POST /undrain?replica=r0 gave {status} {raw!r}")
        counts["r1'"][1] = replica_counts(ports["r1"], where)
        print(f"{where}: POST /drain?replica=r0 -> r0 exited (SIGTERM drain), 6/6 requests answered by "
              f"r1; POST /undrain -> r0 back 'in' rotation", flush=True)

        # SIGTERM the router: exit 0, and no replica it started is left
        stats = get_stats(rport)
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            fail(f"{where}: the router did not exit within 60s of SIGTERM:\n{tail()}")
        if rc != 0 or "router drained cleanly" not in tail():
            fail(f"{where}: the router exited {rc} on SIGTERM:\n{tail()}")
        if any(pid_alive(pid) for pid in pids.values()):
            fail(f"{where}: a replica the router started outlived it: {pids}")
        own["r1"].send_signal(signal.SIGTERM)
        if own["r1"].wait(timeout=60) != 0:
            fail(f"{where}: the respawned r1 exited {own['r1'].returncode} on SIGTERM")
    finally:
        stop_groups([proc, *own.values()])
        for f in logs:
            f.close()
    lat = stats["latency_ms"]
    print(f"{where}: SIGTERM -> router exit 0, every replica it started gone; router spans "
          + ", ".join(f"{k} p50 {v['p50']:.2f} ms" for k, v in sorted(lat.items()) if "p50" in v), flush=True)
    b1 = b2 = 0
    for name, (start, end) in counts.items():
        d1, d2 = end[0] - start[0], end[1] - start[1]
        b1, b2 = b1 + d1, b2 + d2
        print(f"{where} replica {name}: fused_attend launches {d1}, masked {d2} (its /stats, from "
              f"readiness to its end; r1's launches after its kill are lost)", flush=True)
    if (mode == "batch" and b1 == 0) or (mode == "continuous" and b2 == 0):
        fail(f"{where}: the replicas launched B1 {b1} and B2 {b2} times")
    return b1, b2


def supervise_phase(np, tmp: str, card: str):
    """The flagship trained 6 steps through the CLI (a control), then the
    same run under ``--supervise`` with ``SAT_FI_WEDGE_AT_STEP=5`` and the
    watchdog armed by ``--watchdog``: the child is aborted with exit 86
    and a stack dump, the supervisor restarts it once from LAST_GOOD (3)
    and it ends at 6.  Prints the max abs difference of the two 6.npz."""
    from sat_tpu_torch.resilience import lineage
    from sat_tpu_torch.train.checkpoint import load_flat

    where = "supervise"
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(tmp, "supervise")
    image_dir, caption_file = write_coco_fixture(np, os.path.join(root, "data"), 40, SEED + 9)
    base = flagship_config(tmp).replace(
        phase="train", train_image_dir=image_dir, train_caption_file=caption_file,
        vocabulary_file=os.path.join(root, "vocabulary.csv"), max_steps=6, save_period=3, log_every=1,
        watchdog_step_s=5.0, watchdog_data_wait_s=120.0, watchdog_dispatch_s=120.0,
        watchdog_checkpoint_s=120.0, watchdog_grace_s=0.3, supervise_backoff_s=0.1,
    )
    write_vocabulary(np, base.vocabulary_file, base.vocabulary_size, caption_words())
    runs = {}
    for name in ("control", "supervised"):
        d = os.path.join(root, name)
        cfg = base.replace(save_dir=os.path.join(d, "models"), summary_dir=os.path.join(d, "summary"),
                           temp_annotation_file=os.path.join(d, "anns.csv"),
                           temp_data_file=os.path.join(d, "data.npy"))
        os.makedirs(d)
        path = os.path.join(d, "train.json")
        cfg.save(path)
        args = ["--config", path, "--watchdog", "0.2"] + (["--supervise"] if name == "supervised" else [])
        env = {**os.environ, "SAT_FI_WEDGE_AT_STEP": "5"} if name == "supervised" else None
        t0 = time.perf_counter()
        # a group of its own: the supervisor's child goes down with it
        proc = subprocess.Popen([sys.executable, "-m", "sat_tpu_torch.cli", *args], cwd=here, env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                start_new_session=True)
        try:
            stdout, stderr = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            stop_groups([proc])
            fail(f"{where} {name}: did not finish within 600s")
        finally:
            stop_groups([proc])
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"{where} {name}: exited {proc.returncode}:\n{stdout[-2000:]}\n{stderr[-3000:]}")
        if lineage.last_good_step(cfg.save_dir) != 6:
            fail(f"{where} {name}: LAST_GOOD {lineage.last_good_step(cfg.save_dir)}, expected 6")
        runs[name] = (cfg, wall, stderr)
    cfg, wall, err = runs["supervised"]
    for line in ("sat_tpu_torch watchdog: phase 'step' exceeded", "aborting with exit code 86",
                 "watchdog abort (wedged run; LAST_GOOD landed)", "run completed after 1 restart(s)"):
        if line not in err:
            fail(f"{where}: {line!r} is not in the supervisor's stderr:\n{err[-3000:]}")
    dump = os.path.join(cfg.summary_dir, "telemetry", "watchdog_stacks.txt")
    if not os.path.isfile(dump):
        fail(f"{where}: no stack dump at {dump}")
    got = load_flat(os.path.join(cfg.save_dir, "6.npz"))
    want = load_flat(os.path.join(runs["control"][0].save_dir, "6.npz"))
    if sorted(got) != sorted(want):
        fail(f"{where}: the two 6.npz hold different names")
    diffs = {k: float(np.max(np.abs(np.asarray(got[k], np.float64) - np.asarray(want[k], np.float64))))
             for k in want if np.asarray(want[k]).size}
    worst = max(diffs, key=diffs.get)
    differing = sum(1 for v in diffs.values() if v != 0)
    print(f"{where} on {card}: control 6 flagship steps through the CLI in {runs['control'][1]:.2f}s; "
          f"--supervise with SAT_FI_WEDGE_AT_STEP=5: child aborted with exit 86 (stack dump written), "
          f"restarted once from LAST_GOOD 3, ended at 6, in {wall:.2f}s; final 6.npz vs the control's: "
          f"max abs difference {diffs[worst]:.3e} ({worst}), {differing}/{len(diffs)} arrays differ", flush=True)
    return diffs[worst]


def served(np, config) -> None:
    """The vocabulary and the step-1000 checkpoint that ``slice_phase``
    writes for ``config``, for a phase run without it (``--only``)."""
    if not os.path.exists(os.path.join(config.save_dir, "1000.npz")):
        os.makedirs(os.path.dirname(config.vocabulary_file), exist_ok=True)
        write_vocabulary(np, config.vocabulary_file, config.vocabulary_size)
        write_checkpoint(np, config, config.save_dir, step=1000, seed=SEED)


def phases(torch, np, fa, card: str):
    """The full run's phases in order: (name, the phases it needs before
    it, its function of the run's scratch directory).  What a phase
    returns is kept under its name; later phases read the launches and
    the serve engine from there."""
    got = {}

    def slice_(tmp):
        engine, launches, bodies, first = slice_phase(np, fa, flagship_config(tmp), card)
        got["engine"], got["bodies"], got["batch_first"] = engine, bodies, first
        return launches

    def continuous(tmp):
        return continuous_phase(torch, np, fa, flagship_config(tmp).replace(serve_mode="continuous"), card,
                                got["bodies"], got["batch_first"])

    def serve_ops(tmp):
        return serve_ops_phase(torch, np, got.pop("engine"), flagship_config(tmp), card, got["bodies"])

    def train_steady(tmp):
        print(f"device memory allocated before train steady: {torch.cuda.memory_allocated() / 2**30:.3f} GiB "
              f"(torch.cuda.memory_allocated, {card})", flush=True)
        return train_steady_phase(torch, np, fa, train_config(os.path.join(tmp, "steady"), tmp), card)

    def r50_serve_and_bulk(tmp):
        r50 = resnet50_config(tmp)
        engine, launches, bodies, first = slice_phase(np, fa, r50, card, where="resnet50 slice")
        profile_phase(torch, engine, bodies, where="resnet50 profile")
        del engine
        masked = continuous_phase(torch, np, fa, r50.replace(serve_mode="continuous"), card, bodies, first,
                                  where="resnet50 continuous", log_prob_rtol=1e-3)
        return launches, masked, resnet50_bulk(np, tmp, r50, card)

    def r50_planes(tmp):
        r50 = resnet50_config(tmp)
        served(np, r50)
        return cache_part(torch, np, fa, r50, card, jpegs(np, 36, 256, SEED + 3), "resnet50 cache",
                          modes=("continuous",))[1]

    def r50_eval_and_train(tmp):
        launches = resnet50_eval_phase(np, tmp, card)
        got["r50_train"] = resnet50_train_phase(torch, np, tmp, card)
        return launches

    def encoder_quant(tmp):
        for config in (flagship_config(tmp), resnet50_config(tmp)):
            served(np, config)
        encoder_quant_phase(torch, np, tmp, card)

    def route(mode):
        def run(tmp):
            config = flagship_config(tmp)
            served(np, config)
            return route_phase(torch, np, config, card, mode, tmp)
        return run

    def planes(tmp):
        config = flagship_config(tmp)
        served(np, config)
        return serve_planes_phase(torch, np, fa, config, card, tmp)

    return [
        ("kernel", (), lambda tmp: kernel_phase(torch, fa)),
        ("masked", (), lambda tmp: masked_phase(torch, fa)),
        ("reference", (), lambda tmp: reference_phase(torch, np, tmp)),
        ("slice", (), slice_),
        ("profile", ("slice",), lambda tmp: profile_phase(torch, got["engine"], got["bodies"])),
        ("continuous", ("slice",), continuous),
        ("serve ops", ("slice",), serve_ops),
        ("eval", (), lambda tmp: eval_phase(np, eval_config(tmp), card)),
        ("test", ("eval",), lambda tmp: test_phase(np, eval_config(tmp), card)),
        ("eval reference", ("eval",), lambda tmp: eval_reference_phase(np, eval_config(tmp))),
        ("eval steady", ("eval",), lambda tmp: eval_steady_phase(torch, np, eval_config(tmp), card)),
        ("shard cache", ("eval steady",), lambda tmp: shard_cache_phase(torch, np, eval_config(tmp), card)),
        ("bulk", ("slice", "eval steady"), lambda tmp: bulk_phase(torch, np, tmp, card)),
        ("serve planes", (), planes),
        ("route batch", (), route("batch")),
        ("route continuous", (), route("continuous")),
        ("train reference", (), lambda tmp: train_reference_phase(torch, np, fa)),
        ("train", ("eval steady",),
         lambda tmp: train_phase(np, train_config(os.path.join(tmp, "steady"), tmp), card)),
        ("supervise", (), lambda tmp: supervise_phase(np, tmp, card)),
        ("train steady", ("train",), train_steady),
        ("resnet50 reference", (), lambda tmp: resnet50_reference_phase(torch, np, fa, tmp)),
        ("resnet50 serve and bulk", ("bulk",), r50_serve_and_bulk),
        ("resnet50 serve planes", (), r50_planes),
        ("resnet50 eval and train", ("eval", "train"), r50_eval_and_train),
        ("import", ("resnet50 eval and train",), lambda tmp: import_phase(np, got["r50_train"], card)),
        ("encoder_quant", (), encoder_quant),
    ]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bench", action="store_true", help="build and kernel bench only")
    ap.add_argument("--only", default="", help="comma-separated phases to run (with what they need)")
    args = ap.parse_args()
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "sat_tpu_torch")):
        fail("the sat_tpu_torch package is not beside this script")
    if "SAT_TORCH_DEVICE" in os.environ:
        fail(f"SAT_TORCH_DEVICE={os.environ['SAT_TORCH_DEVICE']!r} is set: every phase here must take the card")
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
        print(f"build {name}: {log['seconds']:.1f}s", flush=True)
        for line in log["ptxas"]:
            print(f"build {name} ptxas {line}", flush=True)
    phase("build", t0)
    if args.bench:
        bench_phase(torch, fa)
        return 0
    plan = phases(torch, np, fa, card)
    names = [name.replace(" ", "_") for name, _, _ in plan]
    chosen = set(names)
    if args.only:
        want = [n.strip() for n in args.only.split(",") if n.strip()]
        unknown = sorted(set(want) - chosen)
        if unknown:
            fail(f"--only: no phase {unknown}; the phases are {', '.join(names)}")
        chosen = set(want)
        for name, needs, _ in reversed(plan):
            if name.replace(" ", "_") in chosen:
                chosen.update(n.replace(" ", "_") for n in needs)
    got = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for (name, _, run), key in zip(plan, names):
            if key in chosen:
                t0 = time.perf_counter()
                got[name] = run(tmp)
                phase(name, t0)
                value = got[name]
                if args.only and (isinstance(value, int) or isinstance(value, tuple) and all(
                        isinstance(v, int) for v in value)):
                    print(f"{name} launches {value}", flush=True)
    if args.only:
        return 0
    rows, (masked_rows, masked_err) = got["kernel"], got["masked"]
    launches, masked_launches, (ops_launches, ops_masked) = got["slice"], got["continuous"], got["serve ops"]
    eval_launches, test_launches, bulk_launches = got["eval"], got["test"], got["bulk"]
    planes_b1, planes_b2 = got["serve planes"]
    route_b1 = got["route batch"][0] + got["route continuous"][0]
    route_b2 = got["route batch"][1] + got["route continuous"][1]
    train_test_launches, eval_loss_launches = got["train"], got["train steady"]
    r50_launches, r50_masked, r50_bulk = got["resnet50 serve and bulk"]
    r50_planes, r50_eval, import_launches = (got["resnet50 serve planes"], got["resnet50 eval and train"],
                                             got["import"])

    for B, N, what in ((60, 196, "eval: batch 20 x beam 3"), (20, 196, "eval-loss step: batch 20"),
                       (96, 49, "ResNet50 bucket 32 x beam 3"), (60, 49, "ResNet50 eval: batch 20 x beam 3")):
        row = next(r for r in rows if (r["B"], r["N"], r["dtype"]) == (B, N, "bfloat16"))
        print(f"kernel fused_attend bf16 B={B} N={N} D={row['D']} ({what}) on {card}: {row['ms'] * 1e3:.1f} us, "
              f"bound {row['bound_ms'] * 1e3:.1f} us ({row['bound_by']}, "
              f"{row['bound_ms'] / row['ms']:.1%} of it), plain {row['plain_ms'] * 1e3:.1f} us", flush=True)
    vgg_b1 = (launches + ops_launches + eval_launches + test_launches + train_test_launches + eval_loss_launches
              + planes_b1 + route_b1)
    r50_b1 = r50_launches + r50_eval + import_launches
    print(f"fused_attend launches on the main paths: VGG16 batch serve {launches}, serve ops "
          f"{ops_launches} (masked {ops_masked}), eval and sweep "
          f"{eval_launches}, test {test_launches}, test after training {train_test_launches}, eval-loss "
          f"step {eval_loss_launches}, serve planes {planes_b1}, route replicas {route_b1}; ResNet50 batch "
          f"serve {r50_launches}, eval "
          f"{r50_eval}, test of the imported npy {import_launches}; train steps 0; masked: VGG16 continuous "
          f"serve {masked_launches}, bulk {bulk_launches}, serve planes {planes_b2}, route replicas "
          f"{route_b2}; ResNet50 continuous "
          f"serve {r50_masked}, bulk {r50_bulk}, serve planes {r50_planes}", flush=True)
    main_row = next(r for r in rows if (r["B"], r["N"], r["dtype"]) == (96, 196, "bfloat16"))
    r50_row = next(r for r in rows if (r["B"], r["N"], r["dtype"]) == (96, 49, "bfloat16"))
    masked_row = next(r for r in masked_rows if (r["N"], r["live"]) == (196, 48))
    r50_masked_row = next(r for r in masked_rows if (r["N"], r["live"]) == (49, 48))
    print(json.dumps({"kernels": [{
        "name": "fused_attend",
        "route": "cuda",
        "source": "sat_tpu_torch/csrc/fused_attend.cu",
        "replaces": "sat_tpu/ops/pallas_attention.py:65",
        "launches": vgg_b1 + r50_b1,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"],
        "kernel_ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "shape": "B=96 N=196 da=D=512 bfloat16 (bucket 32 x beam 3)",
        "launches_resnet50": r50_b1,
        "launches_route_replicas": route_b1,
        "resnet50": {"shape": "B=96 N=49 da=512 D=2048 bfloat16", "ms": r50_row["ms"],
                     "plain_ms": r50_row["plain_ms"], "bound_ms": r50_row["bound_ms"],
                     "bound_by": r50_row["bound_by"]},
    }, {
        "name": "fused_attend_masked",
        "route": "cuda",
        "source": "sat_tpu_torch/csrc/fused_attend.cu",
        "replaces": "sat_tpu/ops/pallas_attention.py:95",
        "launches": (masked_launches + ops_masked + bulk_launches + planes_b2 + route_b2 + r50_masked + r50_bulk
                     + r50_planes),
        "max_abs_err": masked_err,
        "ms": masked_row["ms"],
        "kernel_ms": masked_row["ms"],
        "plain_ms": masked_row["plain_ms"],
        "bound_ms": masked_row["bound_ms"],
        "bound_by": masked_row["bound_by"],
        "library_ms": None,
        "shape": "B=48 N=196 da=D=512 bfloat16, 48 rows live (16 slots x beam 3)",
        "launches_resnet50": r50_masked + r50_bulk + r50_planes,
        "launches_route_replicas": route_b2,
        "resnet50": {"shape": "B=48 N=49 da=512 D=2048 bfloat16, 48 rows live", "ms": r50_masked_row["ms"],
                     "plain_ms": r50_masked_row["plain_ms"], "bound_ms": r50_masked_row["bound_ms"],
                     "bound_by": r50_masked_row["bound_by"]},
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
