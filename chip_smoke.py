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
   batch mode (continuous mode's wedge in a fresh process is the chaos
   phase's ``serve_wedge_continuous``), with the wedge watchdog (3 s), a 1 s
   heartbeat, ``--trace_export``, ``--blackbox`` and an error-ratio SLO,
   and ``SAT_FI_WEDGE_SERVE_BATCH`` wedging one batch: 200s
   with ``X-Request-Id`` echoed and minted, a fast 500 "wedged",
   ``/healthz`` 503 "degraded" then "ok" after the re-warm, the same
   words as before; a ``/profile`` capture while 32 requests flow
   holding the kernel's events, opened by ``python -m
   sat_tpu_torch.tools.profile_trace --live`` (a second call, the
   tool's ``main`` in-process as the reply arrives, returns 1 with the
   409; a bad duration 400);
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
   decode and scoring).  The sweep runs with ``--telemetry --blackbox``,
   a heartbeat and a ``profile_dir``: ``trace-decode.json``,
   ``breakdown-decode.json`` (phases within 5% of ``decode/batch``'s
   wall), ``compile_report-decode.json`` with both decode functions, a
   heartbeat naming the card with non-zero ``hbm_bytes_in_use``, a
   torch.profiler window a decode holding B1's events, no postmortem.
10. test — ``--phase test`` over 7 JPEGs through ``cli.main`` in this
   process: results.csv with 7 rows and 7 captioned ``*_result.jpg``.
11. eval reference — the eval path at the small float32 size through
   ``runtime.evaluate`` (attention maps on) and ``decode_dataset`` over
   the fixture's first 12 images, on the card and on the CPU: the same captions and scores, prob and
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
   control's decode steps with ``--blackbox`` (a postmortem bundle),
   relaunched: the output directory bitwise the control's.
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
   steady fixture's first 64 files: a quality block on every row.  B1
   and B2 counted on every part.
14b. route — ``python -m sat_tpu_torch.cli --phase route --num_replicas
   2`` over the flagship checkpoint, once in batch mode (B1 in the
   replicas) and once in continuous mode (B2), replicas on free ports:
   the fleet's boot seconds; every replica's ``/stats`` device
   "cuda:0"; 12 images sent alone (each with its own ``X-Request-Id``)
   with the words one in-process port server gives them alone, then 31
   behind a lead (counted against that server's burst, not required:
   the bf16 encode depends on the batch geometry); p50s beside the
   single server's; each id once in the router's ``access.jsonl`` and
   in exactly one replica's; in batch mode (the router is the same in
   both) r1 SIGKILLed in a burst of 32 once it holds requests (32
   answered 200, at least one retried, the fleet view showing r1
   unreachable), then respawned by the command the fleet spawns it with
   (``LocalFleet.replica_argv``); ``POST /drain?replica=r0`` (r0 exits, 6 requests all answered
   by r1) and ``/undrain``; SIGTERM: the router exits 0 and no replica
   it started is left.  The replicas' kernel counts come from their
   ``/stats``, read at readiness and at each one's end.
15. train reference — the train path at the small float32 size, dropout
   off: 3 Adam steps on the card and on the CPU from the same weights
   and batch (losses within 1e-5 relative, parameters within 1e-5
   absolute, no kernel launched by a train step); ``fused_attend``
   refusing an input that requires grad on the card; an eval-loss step
   launching the kernel once a decode step, its metrics the CPU's
   within 1e-5 relative.  Then the train layer's run-health metrics on
   the card at that size (``train_metrics_check``, the tests' fixture):
   two epochs with a NaN step under ``anomaly_policy=rollback`` and a
   poisoned caption row count one ``sentinel/anomalies`` and one
   ``sentinel/rollbacks``, end at ``data/epoch`` 1 with the heartbeat's
   ``epoch`` 1 and the quarantine record's epoch set; a run whose newest
   checkpoint is rotted and then preempted resumes with one
   ``ckpt/walkbacks``.
16. train — the flagship model with ``Config``'s training defaults
   (dropout 0.5/0.3, Adam 1e-4, clip 5, batch 20, frozen CNN, async
   checkpoints) on the eval steady fixture with two captions an image
   (800 pairs): ``python -m sat_tpu_torch.cli --phase train`` in a fresh
   process for 30 steps (checkpoints 10, 20, 30 verify, LAST_GOOD 30,
   finite metrics, the loss falls, no kernel launched); a ``--load``
   resume is the elastic and the ResNet50 train phases' work, ``--phase
   test`` the test phase's, a trained checkpoint's decode the quality
   phase's.  The 30-step run has ``--telemetry --blackbox
   --diag_level full --metrics_port`` and a ``profile_dir``: the trace,
   a breakdown within 5%, ``telemetry.jsonl`` one row a boundary with
   finite ``diag/*``, ``diag/*`` columns in metrics.jsonl, a final
   heartbeat with ``supervisor/restarts`` 0, ``compile_report.json``'s
   ``train_step`` FLOPs beside ``train_flops``, one ``/metrics`` scrape
   and one ``SIGUSR2`` capture during the run.
17. train steady — ``runtime.train`` in-process at full width: the median
   of 30 warm steps (each ending in ``torch.cuda.synchronize``),
   training pairs/s, peak memory, FLOPs a step from the shapes against
   989 TFLOP/s bf16; 5 steps under torch.profiler (busy share, top
   kernels); the host time of forward, backward and update apart; one
   eval-loss step at full width launching the kernel T times;
   3 steps with diag full bitwise diag off and 6 with ``remat_decoder``
   bitwise remat off (dropout on), each in turns with its median and
   peak memory.  Before it, ``torch.cuda.memory_allocated()``, the
   allocator's ``memory_stats`` and the largest live CUDA tensors.
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
   then ``--phase train --train_cnn --load`` through ``cli.main`` in this
   process from a copy holding 10.npz alone: its 20.npz against the
   uninterrupted run's.
   Between the two, 4 ``--train_cnn`` steps with ``remat_cnn`` against 4
   without, in turns, on one batch: losses, parameters and
   ``batch_stats/`` bitwise, median step and peak memory of each.
21. import — a layout-exact ``resnet50_no_fc.npy`` written from a seed
   through ``--load_cnn --cnn_model_file`` into a 5-step train (265
   tensors, carried unchanged into 5.npz); that state exported with
   ``export_reference_checkpoint``; ``--phase test --model_file
   exported.npy`` captions 7 JPEGs; both through ``cli.main`` in this
   process.
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

23. mesh train — parallel training and mesh decode over torch.distributed,
   two ranks sharing this card under gloo (NCCL refuses two ranks on one
   device): one ``python -m torch.distributed.run --standalone
   --nproc_per_node 2`` launch over the port's CLI (``MESH_HARNESS`` runs
   each argument list through ``cli.main`` in the same two ranks, which
   form each mesh's groups in turn, and counts per rank and list) trains
   the flagship (``Config``'s training defaults, bf16) 6 steps on the
   eval fixture at global batch 20 with ``--fleet_telemetry`` and the 5th
   step profiled on each mesh: (2,1), then (1,2), then (1,2) with
   ``context_parallel=2``; after each, ``--phase eval`` in the same
   ranks (the (2,1) run's 6.npz throughout; the context-parallel one in
   float32 and bf16).  Rank 0 must report the shared-card gloo choice.
   Then one process (the reference): the same training, the (2,1) 6.npz
   evaluated at the ranks' batch of 10, in float32 and at batch 20, and
   the (2,1) 6.npz resumed for 2 more steps (the elastic phase's run).
   Held for (2,1): losses within 1e-4 and gradient norms within 1e-3
   relative at every step, at least 85% of 6.npz's parameter elements
   within 1e-6 of the reference's (``train_parity``), every leaf bitwise
   equal across the ranks, ``fleet.json`` with both rows, B1 once a
   decode step in each rank, results.json the reference's eval of the
   same 6.npz at batch 10 (and counted against batch 20).  Each rank's
   median step (the fleet rows), its share of the profiled step inside
   all_reduce and its peak memory are printed for every mesh.
24. vocab parallel — the (1,2) run: the embedding rows and the last
   decode layer's columns a block a rank, the gathered 6.npz full width,
   the (2,1) run's limits against the reference, the replicated leaves
   bitwise equal, its
   eval's words the reference's batch-20 eval of the same 6.npz.
25. context parallel — the (1,2) ``context_parallel=2`` run: the loss
   falls, both ranks' leaves bitwise equal; the (2,1) 6.npz decoded in
   float32 (words the reference's float32 eval's) and in bf16 (caption
   parity: at least 90% of the captions and every score within 0.05).
   The context-parallel attend is plain tensor code (as the JAX
   package's is), so B1 does not run there.
26. elastic — the reference's resume of the (2,1) 6.npz in one process:
   ``ckpt/elastic_restores`` 1 in its heartbeat and the stderr line, the
   6.npz sidecar recording 2 processes and mesh [2, 1], 8.npz one.
27. quality — the quality protocol through its tool at full width
   (``python -m sat_tpu_torch.tools.quality_run``: VGG16 at 224 px,
   ``--train_cnn``, the basic corpus cut to 16 images, batch 8, the
   protocol's vocabulary of 200, bf16) for 200 steps (of its 1200), then
   the untrained init (``--steps 0``) evaluated the same way: BLEU-4 at
   least 0.5 trained and at most 0.05 untrained, B1 once a decode step of
   each beam eval and never in training; ``export_reference`` and
   ``trim_model`` on the trained checkpoint (the
   exported npy imports back bitwise, the trimmed npz holds every
   non-optimizer array bitwise).
28. replay — the trained checkpoint served in batch and in continuous
   mode with the quality plane on (every request an outlier, the
   recorder's rate limit off, both into one exemplar directory): bursts
   of 6 concurrent corpus JPEGs, then ``python -m
   sat_tpu_torch.tools.replay_exemplar --all`` in a fresh process exits
   0 (every exemplar replayed bitwise in the geometry it was captured in,
   some captured in a bucket or lane wider than 1; B1 for the batch
   rows, B2 for the continuous ones); the rows captured wider than 1
   replayed alone at bucket 1 as well (how many captions and alphas
   digests then differ, reported), and ``--diff`` against the untrained
   init reports each exemplar's divergence.
29. multihost — ``python -m sat_tpu_torch.tools.multihost_demo --fleet
   --procs 2`` at flagship widths in bf16 (``--extra-set``): two OS
   processes started by the tool share the card under gloo, train 40
   steps with worker 0 stalled ``MULTIHOST_SLOW_MS`` a step, checkpoint
   and run the mesh eval with the attention panels.  rc 0 and the
   banner; ``fleet.json`` with 2 hosts and process 0 the straggler (its
   skew and each rank's own step printed; the stall above the other
   rank's p95); B1 launched in each rank's eval.
30. vocab5000 — ``python -m sat_tpu_torch.tools.vocab5000_run --steps 8
   --eval-anns 8 --image-size 224`` over its 1700-image rich corpus: the
   vocabulary exactly 5000 words, 3 tensors sharded over ``model``, the
   loss parity of one process and the (2,4) mesh of eight ranks sharing
   the card under gloo under 5e-2 at every record, finite scores both
   ways, B1 in the one-process eval and in every rank's; each arm's
   median step.
31. chaos — the port's chaos campaign (``python -m
   sat_tpu_torch.tools.chaos_campaign --keep --workdir``) at flagship
   widths (``--extra-set image_size=224 dim_embedding=512 ...``, float32)
   on ``control``, ``wedge_watchdog``, ``poison_quarantine_replay``,
   ``wedge_postmortem``, ``systemic_no_restart`` and
   ``serve_wedge_continuous``, as three campaigns side by side: all pass.  From
   the kept workdirs: the supervised wedge's stack dump, exit 86, one
   restart from LAST_GOOD 3, LAST_GOOD 6, its 6.npz bitwise the
   control's; the wedge's postmortem bundle; the poisoned run's
   heartbeat ``epoch`` and its quarantine records' epochs set; B2
   launched on cuda:0 by the serve wedge's child.
   In the full run the campaigns start before the mesh phases and run
   beside them (elastic waits for them); vocab5000 and the bench
   children likewise beside quality and replay (replay waits for them).
   Each phase line says what ran beside it, and the wait for a child
   counts in the phase that joins it.
32. bench children, bench tools — every measurement vehicle
   (``sat_tpu_torch/tools/bench_*.py``, the ports of
   ``scripts/bench_*.py``) once at the JAX scripts' small flags and
   flagship widths: bulk, the eval A/B, the early-exit run and the
   fleet, which start children of their own as the JAX scripts do, as
   children of this script side by side (their times are smoke); every
   other through its ``main`` in this process, one at a time and beside
   nothing.  Each row the JAX script's metric and unit at the same flags, a finite value,
   ``device_kind`` the card's name and power limit ("host-only" for
   the six host vehicles and the input A/B); B1 and B2 counted around
   each (from the rows for the children's), and each vehicle that
   should launch a kernel launched it; then ``tools.check_regression``
   over the rows against themselves (0), with one throughput halved (2,
   naming it) and in compile-report mode over the eval sweep's
   ``compile_report-decode.json`` (0).

Prints a ``{"kernels": [...]}`` line (each kernel's launches on the
VGG16 and ResNet50 main paths, its time and bound at both grids), then
as its last line ``{"ok": true, "device": {...}}``.  Exits non-zero
without a card or without the package beside it.

``python3 chip_smoke.py --only route_batch,chaos`` runs the build
and the named phases (spaces in a name become ``_``; an unknown name
fails with the list), with the phases they need before them; it prints
each phase's launches and no kernels or ok line.

Fails when ``SAT_TORCH_DEVICE`` is set: every phase takes the card.

``python3 chip_smoke.py --layouts OUT`` runs the build and the multihost
demo in the five layouts of the JAX package's test (dp, cp, tp, 2x2 cp
and 2x2 tp with loss parity) at flagship widths, into
``OUT/result.json`` and ``OUT/summary.md``; ``--profile-trace OUT``
runs the profile tool's default mode (25 flagship steps at batch 32)
and summarizes its capture.

``python3 chip_smoke.py --bench-tools OUT`` runs the build, the eval
phase and every measurement vehicle at its default sizes, its rows into
``OUT/bench_tools.json``.

``python3 chip_smoke.py --bench`` runs only the build and a kernel
bench: the kernel at every timed shape beside what bounds it there, the
timing floor (a one-float memset), torch's sum over the same bytes, and
both timed after a flush that reads instead of writes (no dirty lines to
write back); and the host time to enqueue one call.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import glob
import io
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

SEED = 0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str, t0: float) -> None:
    print(f"phase {name}: ok in {time.perf_counter() - t0:.1f}s", flush=True)


# processes this script starts to run beside its own work: stopped at its
# exit, whatever the exit
STARTED = []


@atexit.register
def stop_started() -> None:
    for proc in STARTED:
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except OSError:
                pass
            proc.wait()


def start_child(base: str, argv, env=None):
    """``python argv`` from the checkout in a session of its own (no
    inherited fault knob), its standard output and error into
    ``base``.out and ``base``.err; returns what :func:`finish_child`
    reads."""
    here = os.path.dirname(os.path.abspath(__file__))
    child_env = {k: v for k, v in os.environ.items() if not k.startswith("SAT_FI_")}
    child_env.update(env or {}, PYTHONPATH=here)
    with open(base + ".out", "w") as out, open(base + ".err", "w") as err:
        proc = subprocess.Popen([sys.executable, *argv], cwd=here, stdout=out, stderr=err, env=child_env,
                                start_new_session=True)
    STARTED.append(proc)
    return proc, base, time.time()


def finish_child(started, where: str, timeout: int = 600):
    """Wait for a :func:`start_child` process (its whole group is killed
    past ``timeout`` seconds from its start); (exit code, standard
    output, standard error, seconds from its start to its last output,
    which a later wait does not lengthen)."""
    proc, base, t0 = started
    try:
        rc = proc.wait(timeout=max(1.0, timeout - (time.time() - t0)))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        fail(f"{where}: no end within {timeout}s")
    seconds = max(os.path.getmtime(base + ".out"), os.path.getmtime(base + ".err")) - t0
    with open(base + ".out") as f:
        out = f.read()
    with open(base + ".err") as f:
        err = f.read()
    return rc, out, err, seconds


# -- kernel phase ------------------------------------------------------------

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
    from sat_tpu_torch.utils.benchmarking import attention_inputs, masked_bound_ms, time_ms

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
            clean = attention_inputs(B, N, da, D, gen)
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
        args = attention_inputs(B, N, da, D, gen)
        for live in (48, 24, 3):
            mask = torch.arange(B, device="cuda") < live
            ms = time_ms(lambda: fa.fused_attend(*args, row_mask=mask, compute_dtype=dtype), flush)
            plain_ms = time_ms(lambda: fa.fused_attend_reference(*args, row_mask=mask, compute_dtype=dtype), flush)
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
    from sat_tpu_torch.utils.benchmarking import attention_bound_ms, attention_inputs, time_ms

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    rows = []
    for (B, N, da, D) in KERNEL_SHAPES + RESNET50_SHAPES:
        plan = fa.attend_plan(N, da, D)
        print(f"plan fused_attend N={N} da={da} D={D}: {plan.cluster} blocks a row, "
              f"{plan.smem_bytes} bytes of shared memory a block, {plan._asdict()}", flush=True)
        for dtype in ("float32", "bfloat16"):
            args = attention_inputs(B, N, da, D, gen)
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
            ms = time_ms(lambda: fa.fused_attend(*args, compute_dtype=dtype), flush)
            plain_ms = time_ms(lambda: fa.fused_attend_reference(*args, compute_dtype=dtype), flush)
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
    from sat_tpu_torch.utils.benchmarking import attention_inputs

    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    row = attention_inputs(1, N, da, D, gen)
    cases = 0
    for dtype in ("float32", "bfloat16"):
        want = fa.fused_attend(*row, compute_dtype=dtype)
        for B in (1, 3, 48, 96, 108):
            t1, t2, _, ctx = attention_inputs(B, N, da, D, gen)
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
    from sat_tpu_torch.utils.benchmarking import attention_bound_ms, attention_inputs, masked_bound_ms, time_ms

    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    one = torch.zeros(1, device="cuda")
    print(f"bench floor: one 4-byte memset timed the same way {time_ms(one.zero_, flush) * 1e3:.1f} us",
          flush=True)
    cases = [(B, None, dt) for B in (96, 48, 12, 3) for dt in ("float32", "bfloat16")]
    cases += [(48, live, "bfloat16") for live in (48, 24, 3)]
    for B, live, dtype in cases:
        N, da, D = 196, 512, 512
        args = attention_inputs(B, N, da, D, gen)
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
        us = time_ms(fn, flush) * 1e3
        bound_ms, _ = attention_bound_ms(B, N, da, D) if live is None else masked_bound_ms(B, live, N, da, D)
        # a yardstick for the bytes, not the function: torch's sum over as
        # many floats as the live rows' t1 and contexts
        same_bytes = torch.ones((live or B) * N * (da + D), device="cuda")
        sum_us = time_ms(same_bytes.sum, flush) * 1e3
        clean = [time_ms(f, flush, read_flush=True) * 1e3 for f in (fn, same_bytes.sum)]
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


def kernel_body(name: str):
    """The MASKED template argument of a ``fused_attend_kernel<...>`` event
    name ("false" for B1, "true" for B2), None for any other kernel."""
    if "fused_attend_kernel<" not in name:
        return None
    args = name[name.index("fused_attend_kernel<"):].split(">")[0].split(", ")
    return args[1] if len(args) > 1 else None


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
        # a capture started through the live mode of the profile tool (the
        # reply comes once the profiler runs), 32 requests sent into it, a
        # second capture through the tool refused meanwhile.  The tool's
        # output is unbuffered, so its reply line arrives while the window
        # is open, however slowly its interpreter exits; the second call
        # is the tool's own main() in this process, since a second
        # interpreter can take longer to start than the 500 ms window
        from sat_tpu_torch.tools import profile_trace

        live = ["--live", f"127.0.0.1:{port}", "500"]
        live_err = tempfile.TemporaryFile(mode="w+")
        first = subprocess.Popen([sys.executable, "-u", "-m", "sat_tpu_torch.tools.profile_trace", *live],
                                 stdout=subprocess.PIPE, stderr=live_err, text=True, cwd=here)
        reply = first.stdout.readline()
        t_reply = time.perf_counter()
        second_out = io.StringIO()
        with contextlib.redirect_stdout(second_out):
            second_rc = profile_trace.main(live)
        second_ms = (time.perf_counter() - t_reply) * 1e3
        flow = {}
        flow_thread = threading.Thread(target=lambda: flow.update(zip(("lead", "rest"), post_all(
            port, bodies[4:35], lead=bodies[35]))))
        flow_thread.start()
        rest = first.stdout.read()  # the tool's own HTTP timeout bounds this
        first.wait(timeout=120)
        live_err.seek(0)
        first_err = live_err.read()
        live_err.close()
        bad, _, _ = http(port, "POST", "/profile?duration_ms=soon")
        flow_thread.join(timeout=600)
        said = (reply + rest).strip().splitlines()
        second_said = second_out.getvalue().strip().splitlines()
        if first.returncode != 0 or said[-1:] != ["profiler window open for 500 ms"] or second_rc != 1 \
                or second_said[-1:] != ["capture already in progress (409)"] or bad != 400:
            fail(f"{where}: profile_trace --live gave rc {first.returncode} {reply + rest!r} {first_err[-2000:]!r}, "
                 f"then rc {second_rc} {second_out.getvalue()!r} {second_ms:.0f} ms after the first reply "
                 f"(want 1, the 409), a bad duration {bad} (want 400)")
        for st, pl, _ in [flow["lead"]] + flow["rest"]:
            if st != 200:
                fail(f"{where}: a request of the flow got {st}: {pl}")
        trace = os.path.join(json.loads(said[0])["profile_dir"], "trace.json")
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
        print(f"{where} profile capture (python -m sat_tpu_torch.tools.profile_trace --live, 500 ms while 32 "
              f"requests flowed): {len(kernels)} kernel events, {len(ours)} of fused_attend ({names}; "
              f"MASKED={body_name} expected), device busy {busy:.1f} ms; a second call {second_ms:.0f} ms after the "
              f"first reply returned 1 with the 409, "
              f"a bad duration 400", flush=True)
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
    """The operations layer: batch mode through the CLI in a fresh
    process (continuous mode's wedge, re-warm and recovery in a fresh
    process are the chaos phase's ``serve_wedge_continuous``), then a real
    device stall and the layer's overhead in-process on the slice's
    engine.  Returns (B1 launches, B2 launches) of the process."""
    tmp = os.path.dirname(config.save_dir)
    batch = serve_ops_process(np, config, card, "batch", tmp, bodies, wedge_at=3)
    device_stall(torch, np, engine, config, card, bodies)
    layer_overhead(torch, np, engine, config, card, bodies)
    return batch["launches"], batch["masked"]


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


# Runs ``main(argv)`` of the tool module named first (``sat_tpu_torch.
# tools.<name>``) in a fresh process with CLI_HARNESS's counts and timers.
TOOL_HARNESS = CLI_HARNESS.replace("from sat_tpu_torch import cli, runtime", "import importlib\nfrom sat_tpu_torch import runtime").replace(
    "rc = cli.main(sys.argv[1:])", "rc = importlib.import_module(sys.argv[1]).main(sys.argv[2:])")


def run_cli(args, where: str, timeout: int = 600, rc: int = 0, env=None, harness: str = CLI_HARNESS):
    """``sat_tpu_torch.cli`` with ``args`` in a fresh process (``env`` added
    to this one's; with ``harness=TOOL_HARNESS`` the tool module named by
    ``args[0]``); returns (its tally, its standard output), the tally
    holding the wall seconds and the end of standard error.  Fails on an
    exit code other than ``rc``."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", harness, *args], cwd=here,
                         capture_output=True, text=True, timeout=timeout,
                         env=None if env is None else {**os.environ, **env})
    wall = time.perf_counter() - t0
    if out.returncode != rc:
        what = "python -m sat_tpu_torch.cli" if harness is CLI_HARNESS else "python -m"
        fail(f"{where}: {what} {' '.join(args)} exited {out.returncode}, "
             f"expected {rc}:\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    return harness_tally(out.stdout, out.stderr, wall, where), out.stdout


def harness_tally(stdout: str, stderr: str, wall: float, where: str) -> dict:
    """The counts a harness prints as its last line, with the wall seconds
    and the end of standard error."""
    last = stdout.strip().splitlines()[-1] if stdout.strip() else ""
    if not last.startswith("chip_smoke counts "):
        fail(f"{where}: no tally line:\n{stdout[-2000:]}\n{stderr[-2000:]}")
    tally = json.loads(last[len("chip_smoke counts "):])
    tally["wall_s"] = wall
    tally["stderr"] = stderr[-4000:]
    return tally


def cli_here(args, where: str):
    """``sat_tpu_torch.cli.main(args)`` in this process, with CLI_HARNESS's
    counts (a fresh process's start-up saved); returns (its tally, its
    standard output).  Fails on an exit code other than 0."""
    import contextlib
    import io

    from sat_tpu_torch import cli, runtime
    from sat_tpu_torch.ops import beam_search as bs
    from sat_tpu_torch.ops import fused_attend as fa

    tally = {"batches": 0, "steps": 0, "decode_s": []}
    sealed, decode_batch, decode_dataset = bs._sealed, runtime.decode_batch, runtime.decode_dataset

    def counted_sealed(*a):  # called once per decode step of the search
        tally["steps"] += 1
        return sealed(*a)

    def counted_batch(*a, **k):
        tally["batches"] += 1
        return decode_batch(*a, **k)

    def timed_dataset(*a, **k):
        t0 = time.perf_counter()
        try:
            return decode_dataset(*a, **k)
        finally:
            tally["decode_s"].append(time.perf_counter() - t0)

    bs._sealed, runtime.decode_batch, runtime.decode_dataset = counted_sealed, counted_batch, timed_dataset
    fa.fused_attend.launches = fa.fused_attend.masked_launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(args)
    finally:
        bs._sealed, runtime.decode_batch, runtime.decode_dataset = sealed, decode_batch, decode_dataset
    tally.update(launches=fa.fused_attend.launches, masked=fa.fused_attend.masked_launches,
                 wall_s=time.perf_counter() - t0)
    if rc != 0:
        fail(f"{where}: cli.main({' '.join(args)}) returned {rc}:\n{out.getvalue()[-3000:]}")
    return tally, out.getvalue()


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

    # the sweep with the observability knobs: spans, the flight recorder,
    # a heartbeat and a torch.profiler window a decode
    tdir, pdir = os.path.join(os.path.dirname(config.save_dir), "tel"), os.path.join(
        os.path.dirname(config.save_dir), "prof")
    sweep, stdout = run_cli(["--config", path, "--sweep", "--telemetry", "--blackbox", "--heartbeat_interval",
                             "0.5", "--set", f"telemetry_dir={tdir}", "--set", f"profile_dir={pdir}"],
                            "eval sweep")
    check_tally(sweep, "eval sweep", batches=10)
    decode_artifacts(config, tdir, pdir, card, "eval sweep")
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


def decode_artifacts(config, tdir: str, pdir: str, card: str, where: str) -> None:
    """What a decode with ``--telemetry --blackbox`` and a ``profile_dir``
    leaves: the decode trace, a breakdown whose phases sum within 5% of
    ``decode/batch``'s wall, a compile report of both decode functions, a
    heartbeat naming the card with its allocated bytes, a torch.profiler
    window a decode holding B1's kernel events, and no postmortem (the
    exit was clean)."""
    import torch

    names = set(os.listdir(tdir))
    want = {"trace-decode.json", "breakdown-decode.json", "compile_report-decode.json", "heartbeat.json",
            "blackbox"}
    if not want <= names or any(n.startswith("postmortem_") for n in names):
        fail(f"{where}: telemetry dir holds {sorted(names)}, expected {sorted(want)} and no postmortem")
    with open(os.path.join(tdir, "breakdown-decode.json")) as f:
        report = json.load(f)
    phases = sum(p["total_s"] for k, p in report["phases"].items() if k != "other")
    if not abs(report["phase_total_s"] - report["wall_s"]) <= 0.05 * report["wall_s"] or phases <= 0:
        fail(f"{where}: breakdown phases {report['phase_total_s']}s against decode/batch wall {report['wall_s']}s")
    with open(os.path.join(tdir, "compile_report-decode.json")) as f:
        compiled = json.load(f)
    fns = compiled["functions"]
    if sorted(fns) != ["decode/beam_search", "decode/encode"] or compiled.get("device_kind") != \
            torch.cuda.get_device_name(0) or not all(f["cost"]["flops"] > 0 and f["memory"] for f in fns.values()):
        fail(f"{where}: compile report {json.dumps(compiled)[:800]}")
    with open(os.path.join(tdir, "heartbeat.json")) as f:
        hb = json.load(f)
    hbm = hb.get("hbm_bytes_in_use") or {}
    if hb.get("device_kind") != torch.cuda.get_device_name(0) or not hbm or not all(v > 0 for v in hbm.values()):
        fail(f"{where}: heartbeat device_kind {hb.get('device_kind')!r}, hbm_bytes_in_use {hbm}")
    windows = sorted(glob.glob(os.path.join(pdir, "*", "trace.json")))
    b1 = [[e for e in trace_kernels(w) if kernel_body(e["name"]) == "false"] for w in windows]
    if not windows or not all(b1):
        fail(f"{where}: profiler windows {windows} with B1 events {[len(x) for x in b1]}")
    line = " ".join(f"{n} {f['cost']['flops'] / 1e9:.2f} GFLOP (temp {f['memory']['temp_bytes'] / 2**20:.1f} MiB, "
                    f"compile {f['compile_seconds']:.3f}s)" for n, f in sorted(fns.items()))
    print(f"{where} telemetry on {card}: breakdown {report['steps']} batches, wall {report['wall_s']:.3f}s, "
          + ", ".join(f"{k} {p['total_s']:.3f}s" for k, p in report["phases"].items())
          + f"; compile report {line}; heartbeat device_kind {hb['device_kind']!r}, hbm_bytes_in_use "
          f"{hbm}; {len(windows)} profiler windows, B1 events {[len(x) for x in b1]}; no postmortem",
          flush=True)


def test_phase(np, config, card: str):
    """``--phase test`` over 7 JPEGs through ``cli.main`` in this process:
    results.csv with 7 rows and a captioned JPEG for each.  Returns the B1
    launches."""
    import csv

    os.makedirs(config.test_image_dir, exist_ok=True)
    for i, body in enumerate(jpegs(np, 7, 300, SEED + 43)):
        with open(os.path.join(config.test_image_dir, f"photo_{i}.jpg"), "wb") as f:
            f.write(body)
    path = os.path.join(os.path.dirname(config.test_image_dir), "test.json")
    config.replace(phase="test").save(path)
    tally, _ = cli_here(["--config", path], "test")
    check_tally(tally, "test", batches=1)
    with open(config.test_result_file, newline="") as f:
        rows = list(csv.DictReader(f))
    if len(rows) != 7 or not all(r["caption"] and float(r["prob"]) >= 0 for r in rows):
        fail(f"test: results.csv has {len(rows)} rows, expected 7 captioned: {rows}")
    rendered = sorted(n for n in os.listdir(config.test_result_dir) if n.endswith("_result.jpg"))
    if rendered != [f"photo_{i}_result.jpg" for i in range(7)]:
        fail(f"test: captioned JPEGs {rendered}")
    print(f"test flagship bf16 on {card}: 7 JPEGs through cli.main in this process in {tally['wall_s']:.2f}s (decode "
          f"{tally['decode_s'][0]:.3f}s), results.csv 7 rows, 7 captioned JPEGs; fused_attend "
          f"launches {tally['launches']} over {tally['steps']} steps", flush=True)
    return tally["launches"]


def eval_reference_phase(np, config):
    """The eval path at the small float32 size through ``runtime.evaluate``
    (attention maps on) and ``decode_dataset`` over the eval fixture's
    first 12 images (24 annotation ids), on the card and on the CPU:
    identical captions and scores, prob within 1e-4 relative, alphas
    within 1e-4."""
    from sat_tpu_torch import runtime
    from sat_tpu_torch.data.dataset import prepare_eval_data
    from sat_tpu_torch.ops import fused_attend as fa

    small = config.replace(
        image_size=32, dim_embedding=16, num_lstm_units=16, dim_initialize_layer=16,
        dim_attend_layer=16, dim_decode_layer=32, vocabulary_size=50, compute_dtype="float32",
        save_attention_maps=True, max_eval_ann_num=24,
        save_dir=os.path.join(os.path.dirname(config.save_dir), "small"),
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
    control's.  Returns the B2 launches of the CLI runs."""
    from sat_tpu_torch.bulk.corpus import resolve_corpus

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

    def run(name, where, rc=0, env=None, args=()):
        config = base.replace(bulk_output=os.path.join(root, name),
                              summary_dir=os.path.join(root, name + "_summary"))
        path = os.path.join(root, name + ".json")
        config.save(path)
        tally, _ = run_cli(["--config", path, *args], where, rc=rc, env=env)
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

    killed, kill_tally = run("killed", "bulk kill", rc=1, env={"SAT_FI_DIE_AT_STEP": str(steps // 2)},
                             args=("--blackbox",))
    if "injected preemption" not in kill_tally["stderr"]:
        fail(f"bulk kill: the run did not stop on the injected preemption:\n{kill_tally['stderr'][-1500:]}")
    bundles = glob.glob(os.path.join(killed.summary_dir, "telemetry", "postmortem_*"))
    if len(bundles) != 1:
        fail(f"bulk kill: --blackbox left postmortem bundles {bundles}")
    with open(os.path.join(bundles[0], "manifest.json")) as f:
        manifest = json.load(f)
    if manifest["reason"] != "simulated_preemption" or manifest["exit_code"] != 1:
        fail(f"bulk kill: postmortem manifest {manifest}")
    done = json.loads(bulk_outputs(killed.bulk_output)["bulk_manifest.json"])["completed"]
    if len(done) >= 2:
        fail(f"bulk kill: the kill at step {steps // 2} of {steps} left {len(done)} shards complete")
    _, resumed = run("killed", "bulk resume")
    if bulk_outputs(killed.bulk_output) != bulk_outputs(control.bulk_output):
        diff = [n for n, b in bulk_outputs(killed.bulk_output).items() if out.get(n) != b]
        fail(f"bulk resume: output files differ from the uninterrupted run's: {diff}")
    print(f"bulk kill on {card}: SAT_FI_DIE_AT_STEP={steps // 2} of {steps} with --blackbox exited 1 after "
          f"{kill_tally['wall_s']:.2f}s with {len(done)} shard(s) committed and a postmortem bundle "
          f"({sorted(os.listdir(bundles[0]))}); the relaunch "
          f"({resumed['wall_s']:.2f}s) left the output directory bitwise the uninterrupted run's", flush=True)
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
    of 32): every row carries its ``quality`` block.  (The bulk phase
    holds a killed and relaunched run bitwise.)"""
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
    print(f"quality bulk on {card}: {PLANES_BULK} files in 2 shards with serve_quality on: every row carries "
          f"{sorted(keys)}; sample {json.dumps(rows[0]['quality'])}", flush=True)
    return b1, tally["masked"]


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
    from sat_tpu_torch.utils.benchmarking import attention_inputs

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
            enumerate(attention_inputs(3, 196, 512, 512, torch.Generator(device="cuda").manual_seed(SEED)))]
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


class fault_env:
    """``SAT_FI_*`` knobs in this process's environment for a block (the
    train loop reads them when it starts)."""

    def __init__(self, **knobs):
        self.knobs = {f"SAT_FI_{k}": str(v) for k, v in knobs.items()}

    def __enter__(self):
        os.environ.update(self.knobs)

    def __exit__(self, *exc):
        for k in self.knobs:
            os.environ.pop(k, None)


def train_metrics_check(np, tmp: str, card: str) -> None:
    """The train layer's run-health metrics on the card, in this process at
    the small float32 size on the tests' COCO fixture (24 captions, 6 steps
    an epoch): two epochs under ``anomaly_policy=rollback`` with
    SAT_FI_NAN_AT_STEP=5 and SAT_FI_BAD_CAPTION_AT=30 count one
    ``sentinel/anomalies`` and one ``sentinel/rollbacks`` (in the registry
    and in the last ``telemetry.jsonl`` row), end with ``data/epoch`` 1 and
    a heartbeat ``epoch`` of 1, and the quarantined caption's record
    carries its epoch; then a run whose 4.npz is rotted
    (SAT_FI_CORRUPT_CKPT_STEP=4) and preempted at step 5 resumes from
    2.npz with one ``ckpt/walkbacks``."""
    from sat_tpu_torch import runtime, telemetry
    from sat_tpu_torch.resilience.faultinject import SimulatedPreemption
    from sat_tpu_torch.resilience.quarantine import ledger_path_for
    from sat_tpu_torch.telemetry import spans
    from sat_tpu_torch.tools.fixtures import make_coco_fixture
    from sat_tpu_torch.train.checkpoint import restore_checkpoint

    where = "train metrics"
    root = os.path.join(tmp, "train_metrics")
    base = make_coco_fixture(os.path.join(root, "fixture"))["config"].replace(
        image_size=32, dim_embedding=16, num_lstm_units=16, dim_initialize_layer=16, dim_attend_layer=16,
        dim_decode_layer=32, compute_dtype="float32", log_every=1, num_data_workers=2, save_period=2,
    )
    before = spans._impl   # the registry the earlier phases left, put back below
    try:
        cfg = base.replace(save_dir=os.path.join(root, "rollback", "models"),
                           summary_dir=os.path.join(root, "rollback", "summary"), anomaly_policy="rollback",
                           num_epochs=2, save_period=4, telemetry=True, heartbeat_interval=0.05)
        with fault_env(NAN_AT_STEP=5, BAD_CAPTION_AT=30):
            state = runtime.train(cfg)
        tel = telemetry.get()
        counters, gauges = tel.counters(), tel.gauges()
        tdir = os.path.join(cfg.summary_dir, "telemetry")
        with open(os.path.join(tdir, "telemetry.jsonl")) as f:
            last = [json.loads(line) for line in f if line.strip()][-1]["counters"]
        with open(os.path.join(tdir, "heartbeat.json")) as f:
            beat = json.load(f)
        with open(ledger_path_for(cfg)) as f:
            records = [json.loads(line) for line in f if line.strip()]
        got = {k: (counters.get(k, 0), last.get(k, 0)) for k in ("sentinel/anomalies", "sentinel/rollbacks")}
        if int(state.step) != 12 or got != {"sentinel/anomalies": (1, 1), "sentinel/rollbacks": (1, 1)} or \
                gauges.get("data/epoch") != 1 or beat.get("epoch") != 1 or not records or \
                any(r.get("epoch") is None for r in records):
            fail(f"{where}: step {int(state.step)}, (registry, telemetry.jsonl) {got}, data/epoch "
                 f"{gauges.get('data/epoch')}, heartbeat epoch {beat.get('epoch')}, quarantine records {records}")

        cfg = base.replace(save_dir=os.path.join(root, "walkback", "models"),
                           summary_dir=os.path.join(root, "walkback", "summary"))
        try:
            with fault_env(CORRUPT_CKPT_STEP=4, DIE_AT_STEP=5):
                runtime.train(cfg)
        except SimulatedPreemption:
            pass
        else:
            fail(f"{where}: SAT_FI_DIE_AT_STEP=5 did not preempt the run")
        tel = telemetry.enable()
        restored, _ = restore_checkpoint(runtime.setup_train_state(cfg), save_dir=cfg.save_dir)
        walkbacks = tel.counters().get("ckpt/walkbacks", 0)
        if int(restored.step) != 2 or walkbacks != 1:
            fail(f"{where}: the resume restored step {int(restored.step)} with ckpt/walkbacks {walkbacks}")
    finally:
        spans._impl = before
    print(f"{where} on {card}: 2 epochs with a NaN step 5 under anomaly_policy=rollback and caption row 30 "
          f"poisoned: sentinel/anomalies 1, sentinel/rollbacks 1 (registry and telemetry.jsonl), data/epoch "
          f"{gauges['data/epoch']}, heartbeat epoch {beat['epoch']}, quarantine record epochs "
          f"{[r['epoch'] for r in records]} (steps {[r['step'] for r in records]}); 4.npz rotted, preempted at "
          f"5: the resume walked back to 2.npz with ckpt/walkbacks {walkbacks}", flush=True)


TRAIN_STEPS, TRAIN_SAVE, TRAIN_LOG = 30, 10, 5


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
    a fresh process at full width, 30 steps: exit 0, the train step
    launches neither kernel, 10/20/30.npz verify, LAST_GOOD 30, every
    metrics row finite and the loss falls."""
    from sat_tpu_torch.resilience import lineage

    write_vocabulary(np, config.vocabulary_file, config.vocabulary_size, caption_words())
    path = os.path.join(os.path.dirname(config.save_dir), "train.json")
    config.save(path)
    # the observability knobs on: a /metrics scrape and a SIGUSR2 while it runs;
    # the profile_dir window (steps 1-3) closes before the first log boundary
    # (step 5), where the SIGUSR2 capture starts: two live captures refuse
    tdir, pdir = os.path.join(os.path.dirname(config.save_dir), "tel"), os.path.join(
        os.path.dirname(config.save_dir), "prof")
    port = free_base_port(1)
    poked = {}
    poker = threading.Thread(target=scrape_and_signal, args=(port, poked), daemon=True)
    poker.start()
    tally, stdout = run_cli(["--phase", "train", "--config", path, "--telemetry", "--blackbox", "--diag_level",
                             "full", "--metrics_port", str(port), "--heartbeat_interval", "1", "--set",
                             f"telemetry_dir={tdir}", "--set", f"profile_dir={pdir}", "--set",
                             "profile_start_step=1", "--set", "profile_window_ms=1000"], "train")
    poker.join(timeout=30)
    if tally["launches"] or tally["masked"]:
        fail(f"train: the train loop launched fused_attend {tally['launches']} / masked "
             f"{tally['masked']} times")
    steps = lineage.checkpoint_steps(config.save_dir)
    if steps != list(range(TRAIN_SAVE, TRAIN_STEPS + 1, TRAIN_SAVE)) or lineage.last_good_step(
            config.save_dir) != TRAIN_STEPS:
        fail(f"train: checkpoints {steps}, LAST_GOOD {lineage.last_good_step(config.save_dir)}")
    for step in steps:
        ok, reason = lineage.verify_checkpoint(os.path.join(config.save_dir, f"{step}.npz"))
        if not ok:
            fail(f"train: {step}.npz does not verify: {reason}")
    rows = metrics_rows(np, config, "train")
    if [r["step"] for r in rows] != list(range(TRAIN_LOG, TRAIN_STEPS + 1, TRAIN_LOG)):
        fail(f"train: metrics.jsonl steps {[r['step'] for r in rows]}")
    # 6 logged rows: the mean of the last 3 (steps 20-30) against the first 3
    losses = [r["total_loss"] for r in rows]
    first, last = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
    if not last < first:
        fail(f"train: total_loss did not fall: {losses}")
    print(f"train flagship on {card}: {TRAIN_STEPS} steps through the CLI in {tally['wall_s']:.2f}s "
          f"(process start to exit, telemetry, recorder and diag full on); total_loss at steps {TRAIN_LOG}..{TRAIN_STEPS} "
          f"{[round(x, 4) for x in losses]} (mean {first:.4f} -> {last:.4f}); checkpoints {steps} verify, "
          f"LAST_GOOD {TRAIN_STEPS}; fused_attend launches 0, masked 0", flush=True)
    train_artifacts(config, tdir, pdir, rows, poked, card)


def scrape_and_signal(port: int, out: dict, limit_s: float = 300.0) -> None:
    """While a train run with ``--metrics_port port`` runs: poll its
    ``/healthz`` for the process id, scrape ``/metrics`` once a step is
    gauged, then send the process one ``SIGUSR2``.  Fills ``out``."""
    deadline = time.time() + limit_s
    while time.time() < deadline:
        try:
            hz = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=5).read())
            text = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=5).read().decode()
        except (OSError, ValueError):
            time.sleep(0.05)
            continue
        if hz.get("pid") and 'sat_gauge{name="train/step"}' in text:
            out.update(pid=hz["pid"], step=hz.get("step"), metrics=text)
            os.kill(hz["pid"], signal.SIGUSR2)
            return
        time.sleep(0.05)


def train_artifacts(config, tdir: str, pdir: str, rows, poked: dict, card: str) -> None:
    """What the train CLI run with ``--telemetry --blackbox --diag_level
    full --metrics_port`` and a ``profile_dir`` leaves: the trace, a
    breakdown whose phases sum within 5% of ``train/step``'s wall,
    ``telemetry.jsonl`` one row a log boundary with finite ``diag/*``
    gauges, ``diag/*`` columns in metrics.jsonl, a final heartbeat with
    ``supervisor/restarts`` 0, a compile report whose ``train_step`` FLOPs
    are printed beside :func:`train_flops`, the scrape of ``/metrics``, the
    ``SIGUSR2`` capture and the ``profile_dir`` window, and no
    postmortem."""
    import torch

    names = set(os.listdir(tdir))
    want = {"trace.json", "breakdown.json", "telemetry.jsonl", "heartbeat.json", "compile_report.json",
            "blackbox", "profiles"}
    if not want <= names or any(n.startswith("postmortem_") for n in names):
        fail(f"train: telemetry dir holds {sorted(names)}, expected {sorted(want)} and no postmortem")
    with open(os.path.join(tdir, "breakdown.json")) as f:
        report = json.load(f)
    if report["steps"] != TRAIN_STEPS or not abs(report["phase_total_s"] - report["wall_s"]) <= 0.05 * report["wall_s"]:
        fail(f"train: breakdown {report['steps']} steps, phases {report['phase_total_s']}s, wall {report['wall_s']}s")
    with open(os.path.join(tdir, "telemetry.jsonl")) as f:
        tel_rows = [json.loads(line) for line in f]
    boundaries = list(range(TRAIN_LOG, TRAIN_STEPS + 1, TRAIN_LOG))
    diag = [{k: v for k, v in r["gauges"].items() if k.startswith("diag/")} for r in tel_rows]
    if [r["step"] for r in tel_rows] != boundaries or not all(
            len(d) > 20 and all(isinstance(v, float) and v == v and abs(v) != float("inf") for v in d.values())
            for d in diag):
        fail(f"train: telemetry.jsonl steps {[r['step'] for r in tel_rows]}, diag {diag[-1] if diag else None}")
    if not all({"diag/param_norm", "diag/grad_norm/decoder.lstm", "diag/attn_entropy"} <= set(r) for r in rows):
        fail(f"train: metrics.jsonl lacks diag columns: {sorted(rows[-1])}")
    with open(os.path.join(tdir, "heartbeat.json")) as f:
        hb = json.load(f)
    if hb.get("supervisor") != {"restarts": 0} or hb.get("step") != TRAIN_STEPS or hb.get(
            "device_kind") != torch.cuda.get_device_name(0) or not hb.get("hbm_bytes_in_use"):
        fail(f"train: final heartbeat {json.dumps(hb)[:600]}")
    with open(os.path.join(tdir, "compile_report.json")) as f:
        entry = json.load(f)["functions"]["train_step"]
    counted, shapes = entry["cost"]["flops"], train_flops(config)
    if not poked.get("metrics") or "sat_up 1" not in poked["metrics"]:
        fail(f"train: no /metrics scrape during the run: {poked}")
    captures = glob.glob(os.path.join(tdir, "profiles", "*", "trace.json"))
    windows = glob.glob(os.path.join(pdir, "*", "trace.json"))
    if len(captures) != 1 or len(windows) != 1:
        fail(f"train: SIGUSR2 captures {captures}, profile_dir windows {windows}")
    last = diag[-1]
    print(f"train telemetry on {card}: breakdown " + ", ".join(
        f"{k} {p['total_s']:.3f}s" for k, p in report["phases"].items()) + f" of {report['wall_s']:.3f}s; "
        f"telemetry.jsonl {len(tel_rows)} rows with {len(last)} finite diag gauges (step {TRAIN_STEPS}: param_norm "
        f"{last['diag/param_norm']:.4f}, update_ratio {last['diag/update_ratio']:.3e}, attn_entropy_frac "
        f"{last['diag/attn_entropy_frac']:.4f}, alpha_coverage_dev {last['diag/alpha_coverage_dev']:.4f}, "
        f"grad_nonfinite {last['diag/grad_nonfinite']:.0f}); heartbeat supervisor/restarts 0, "
        f"hbm_bytes_in_use {hb['hbm_bytes_in_use']}; compile report train_step {counted / 1e12:.4f} TFLOP "
        f"(FlopCounterMode) against {shapes / 1e12:.4f} TFLOP from the shapes (train_flops, ratio "
        f"{counted / shapes:.4f}), temp {entry['memory']['temp_bytes'] / 2**20:.1f} MiB, compile "
        f"{entry['compile_seconds']:.3f}s; /metrics scraped at step {poked.get('step')}, SIGUSR2 capture "
        f"{os.path.relpath(captures[0], tdir)}; profile_dir window {os.path.relpath(windows[0], pdir)}",
        flush=True)


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

    def timed_step(cfg, mesh=None):
        step = real(cfg, mesh)

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

    diag_and_remat(torch, np, config, batch, card)

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


def hand_steps(torch, config, batch, n: int):
    """``n`` train steps of a fresh state (seeded by ``config.seed``) on one
    device batch, driven by hand, each ending in a synchronize: (the state
    as a flat dict, each step's metrics as floats, the step times, the
    peak rise of allocated memory over the steps)."""
    from sat_tpu_torch import runtime
    from sat_tpu_torch.train.checkpoint import state_to_flat
    from sat_tpu_torch.train.step import make_train_step, step_generator

    state = runtime.setup_train_state(config, device="cuda")
    step = make_train_step(config)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    metrics, times = [], []
    for s in range(n):
        t0 = time.perf_counter()
        state, m = step(state, batch, step_generator(SEED, s, batch["images"].device))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append(m)
    peak = torch.cuda.max_memory_allocated() - base
    host = [{k: float(v) for k, v in m.items()} for m in metrics]
    return state_to_flat(state), host, times, peak


def bitwise_diff(np, a: dict, b: dict):
    """Names whose arrays differ (bitwise) between two flat states."""
    if sorted(a) != sorted(b):
        return ["<names>"]
    return [k for k in a if not np.array_equal(a[k], b[k])]


def diag_and_remat(torch, np, config, batch, card: str) -> None:
    """On one device batch at full width, dropout on: 3 steps with
    ``diag_level="full"`` bitwise 3 steps with it off (state and every
    non-diag metric); then 6 steps with ``remat_decoder`` against 6
    without: losses and state bitwise, the median of the last 5 steps and
    the peak rise of allocated memory of each."""
    # log_every 1: every step ends a log interval, so every step is tapped
    off = hand_steps(torch, config.replace(log_every=1), batch, 3)
    full = hand_steps(torch, config.replace(diag_level="full", log_every=1), batch, 3)
    differ = bitwise_diff(np, off[0], full[0])
    plain = [{k: v for k, v in m.items() if not k.startswith("diag/")} for m in full[1]]
    if differ or plain != off[1] or not all(len(m) - len(p) > 20 for m, p in zip(full[1], plain)):
        fail(f"diag: diag_level=full differs from off: {differ[:5]}, metrics {plain[-1]} vs {off[1][-1]}")
    print(f"diag bitwise on {card}: 3 flagship steps with dropout on, diag_level=full against off: the state "
          f"({len(off[0])} arrays) and every non-diag metric bitwise, {len(full[1][-1]) - len(plain[-1])} diag "
          f"taps a step", flush=True)
    rows = {}
    for name, cfg in (("off", config), ("on", config.replace(remat_decoder=True)),
                      ("off again", config), ("on again", config.replace(remat_decoder=True))):
        rows[name] = hand_steps(torch, cfg, batch, 6)
    differ = bitwise_diff(np, rows["off"][0], rows["on"][0])
    if differ or rows["off"][1] != rows["on"][1]:
        fail(f"remat_decoder: not bitwise remat off: {differ[:5]}, losses "
             f"{[m['total_loss'] for m in rows['on'][1]]} vs {[m['total_loss'] for m in rows['off'][1]]}")
    line = "; ".join(f"{name} median {statistics.median(r[2][1:]) * 1e3:.2f} ms, peak +{r[3] / 2**20:.1f} MiB"
                     for name, r in rows.items())
    print(f"remat_decoder on {card}: 6 flagship steps on one batch, dropout on: losses and state bitwise remat "
          f"off's (total_loss {[round(m['total_loss'], 4) for m in rows['on'][1]]}); in turns: {line} "
          f"(max_memory_allocated over the steps above the state's)", flush=True)


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
    and falling; then ``--phase train --train_cnn --load`` through
    ``cli.main`` in this process from a copy holding 10.npz alone, to 20: its
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

    def timed_step(cfg, mesh=None):
        step = real(cfg, mesh)

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

    remat_cnn_check(torch, np, config, card)

    resumed = os.path.join(root, "resumed")
    shutil.copytree(config.save_dir, resumed)
    for name in os.listdir(resumed):
        if name.startswith("20.npz"):
            os.remove(os.path.join(resumed, name))
    lineage.mark_last_good(resumed, 10)
    path = os.path.join(root, "resume.json")
    config.replace(save_dir=resumed, summary_dir=os.path.join(root, "resumed_summary")).save(path)
    tally, stdout = cli_here(["--phase", "train", "--config", path, "--train_cnn", "--load"], "resnet50 resume")
    if "(step 10)" not in stdout:
        fail(f"resnet50 resume: did not restore step 10:\n{stdout[-2000:]}")
    again = load_flat(os.path.join(resumed, "20.npz"))
    if set(again) != set(flats[20]):
        fail("resnet50 resume: 20.npz names differ from the uninterrupted run's")
    diff = max(float(np.abs(again[k].astype(np.float64) - flats[20][k]).max()) for k in again)
    if not diff <= 1e-2:
        fail(f"resnet50 resume: 20.npz differs from the uninterrupted run's by {diff:.3e}")
    print(f"resnet50 resume on {card}: --train_cnn --load from 10.npz to 20 through cli.main in this process in "
          f"{tally['wall_s']:.2f}s; 20.npz against the uninterrupted run's: "
          f"{'bitwise' if diff == 0 else f'max abs diff {diff:.3e}'}", flush=True)
    return config


def remat_cnn_check(torch, np, config, card: str) -> None:
    """``--train_cnn`` ResNet50 at full width on one device batch, dropout
    on: 4 steps with ``remat_cnn`` against 4 without, in turns (off, on,
    on, off): losses, parameters, Adam slots and ``batch_stats/``
    bitwise, the median of the last 3 steps and the peak rise of
    allocated memory of each."""
    from sat_tpu_torch import runtime
    from sat_tpu_torch.data.dataset import prepare_train_data

    feed = runtime.device_prefetch(runtime.make_loader(config, prepare_train_data(config)),
                                   runtime.resolve_device("cuda"))
    try:
        batch = next(iter(feed))
    finally:
        feed.close()
    rows = {}
    for name, cfg in (("off", config), ("on", config.replace(remat_cnn=True)),
                      ("on again", config.replace(remat_cnn=True)), ("off again", config)):
        rows[name] = hand_steps(torch, cfg, batch, 4)
    differ = bitwise_diff(np, rows["off"][0], rows["on"][0])
    stats = [k for k in rows["on"][0] if k.startswith("batch_stats/")]
    if differ or rows["off"][1] != rows["on"][1] or len(stats) != 106:
        fail(f"remat_cnn: not bitwise remat off: {differ[:5]} ({len(stats)} batch_stats entries), losses "
             f"{[m['total_loss'] for m in rows['on'][1]]} vs {[m['total_loss'] for m in rows['off'][1]]}")
    line = "; ".join(f"{name} median {statistics.median(r[2][1:]) * 1e3:.2f} ms, peak +{r[3] / 2**30:.3f} GiB"
                     for name, r in rows.items())
    print(f"remat_cnn resnet50 --train_cnn on {card}: 4 steps on one batch of {config.batch_size}, dropout on: "
          f"losses, parameters, slots and {len(stats)} batch_stats entries bitwise remat off's; in turns: "
          f"{line} (max_memory_allocated over the steps above the state's)", flush=True)


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
    (B1 once a decode step).  Both through the CLI's ``main`` in this
    process.  Returns the B1 launches."""
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
    tally, stdout = cli_here(["--phase", "train", "--config", path, "--load_cnn", "--cnn_model_file", npy],
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
    tested, stdout = cli_here(["--config", test_path, "--model_file", ref], "import test")
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


# -- route (the fleet router over replicas on this card) ---------------------

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

        # SIGKILL r1 mid-burst (batch mode; the router is the same in both):
        # every request still answered, through the one retry
        last_r1 = "r1"
        if mode == "batch":
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
            last_r1 = "r1'"
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
        counts[last_r1][1] = replica_counts(ports["r1"], where)
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
        if "r1" in own:
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
              f"readiness to its end" + ("; r1's launches after its kill are lost)" if mode == "batch" else ")"),
              flush=True)
    if (mode == "batch" and b1 == 0) or (mode == "continuous" and b2 == 0):
        fail(f"{where}: the replicas launched B1 {b1} and B2 {b2} times")
    return b1, b2


# -- parallel training and mesh decode (torch.distributed, two ranks) --------

# Runs argument lists through the port's CLI in turn, in this process (one
# rank of a torchrun launch, or a plain process), counting per list what
# the path launched and decoded, each rank's peak memory, and a sha256 of
# every parameter leaf the train phase returns; writes tally_rank<r>.json.
MESH_HARNESS = r"""
import hashlib, json, os, sys, time
import torch
from sat_tpu_torch import cli, runtime
from sat_tpu_torch.ops import beam_search as bs
from sat_tpu_torch.ops import fused_attend as fa
from sat_tpu_torch.parallel import train as ptrain
from sat_tpu_torch.parallel.mesh import initialize_distributed, rank, shutdown_distributed
from sat_tpu_torch.train.checkpoint import named_leaves

out_dir, argvs = sys.argv[1], json.loads(sys.argv[2])
sealed, decode_batch, mesh_decode, train = bs._sealed, runtime.decode_batch, ptrain.mesh_decode_batch, runtime.train
cur = {}

def counted_sealed(*a):
    cur["steps"] += 1
    return sealed(*a)

def counted_batch(*a, **k):
    cur["batches"] += 1
    return decode_batch(*a, **k)

def counted_mesh(*a, **k):
    cur["batches"] += 1
    return mesh_decode(*a, **k)

def fingerprinted(*a, **k):
    state = train(*a, **k)
    cur["params"] = {name: [list(t.shape), hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()]
                     for name, t, _ in named_leaves(state.params, "params/")}
    return state

bs._sealed, runtime.decode_batch, ptrain.mesh_decode_batch = counted_sealed, counted_batch, counted_mesh
runtime.train = fingerprinted
initialize_distributed()
tally, rc = {}, 0
try:
    for i, argv in enumerate(argvs):
        cur = {"argv": argv, "steps": 0, "batches": 0}
        fa.fused_attend.launches = fa.fused_attend.masked_launches = 0
        card = torch.cuda.is_available()
        if card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rc = cli.main(argv)
        cur.update(wall_s=time.perf_counter() - t0, launches=fa.fused_attend.launches,
                   masked=fa.fused_attend.masked_launches,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30 if card else 0.0, rc=rc)
        tally[str(i)] = cur
        if rc:
            break
finally:
    with open(os.path.join(out_dir, f"tally_rank{rank()}.json"), "w") as f:
        json.dump(tally, f)
    shutdown_distributed()
sys.exit(rc)
"""

MESH_STEPS = 6
SHARED_CARD = "backend gloo, rank 0 on cuda:0 (the host's one card, shared by every local rank)"


def mesh_base(np, tmp: str):
    """The flagship as the repo trains it (``Config``'s training defaults:
    dropout 0.5/0.3, Adam 1e-4, clip 5, batch 20, bf16) on the eval
    fixture (48 JPEGs, two captions each: 96 pairs, 5 batches an epoch),
    6 steps, the checkpoint at the end (none inside the timed steps);
    written first when the eval phase did not run."""
    config = eval_config(tmp)
    if not os.path.exists(config.eval_caption_file):
        write_coco_fixture(np, os.path.dirname(config.eval_image_dir), 48, SEED + 40)
        write_vocabulary(np, config.vocabulary_file, config.vocabulary_size, caption_words())
    return config.replace(
        phase="train", train_image_dir=config.eval_image_dir, train_caption_file=config.eval_caption_file,
        max_steps=MESH_STEPS, save_period=0, log_every=1,
    )


def mesh_run_config(base, tmp: str, tag: str, **kw):
    """``base`` with its own save, summary, cache and result paths under
    ``<tmp>/mesh/<tag>``, saved as ``config.json`` there."""
    root = os.path.join(tmp, "mesh", tag)
    os.makedirs(root, exist_ok=True)
    config = base.replace(
        save_dir=os.path.join(root, "models"), summary_dir=os.path.join(root, "summary"),
        temp_annotation_file=os.path.join(root, "anns.csv"), temp_data_file=os.path.join(root, "data.npy"),
        eval_result_file=os.path.join(root, "results.json"), eval_result_dir=os.path.join(root, "results"),
        **kw,
    )
    config.save(os.path.join(root, "config.json"))
    return config, os.path.join(root, "config.json")


def profiled(tmp: str, tag: str):
    """A train argument list's profiler window: step 5 of 6 (the first
    step carries the first-call costs), under ``<tmp>/mesh/<tag>/prof``."""
    return ["--set", f"profile_dir={os.path.join(tmp, 'mesh', tag, 'prof')}", "--set", "profile_start_step=4",
            "--set", "profile_num_steps=1"]


def mesh_launch(tmp: str, tag: str, nproc: int, argvs, where: str, timeout: int = 600):
    """``argvs`` through ``MESH_HARNESS`` in ``nproc`` ranks: ``python -m
    torch.distributed.run --standalone --nproc_per_node 2`` (every rank on
    this card) or, for 1, a plain process.  Returns (each rank's tally,
    stdout, stderr, wall seconds)."""
    here = os.path.dirname(os.path.abspath(__file__))
    harness = os.path.join(tmp, "mesh", "harness.py")
    if not os.path.exists(harness):
        with open(harness, "w") as f:
            f.write(MESH_HARNESS)
    out_dir = os.path.join(tmp, "mesh", "tally", tag)
    os.makedirs(out_dir, exist_ok=True)
    cmd = ([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(nproc)]
           if nproc > 1 else [sys.executable]) + [harness, out_dir, json.dumps(argvs)]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=here, env={**os.environ, "PYTHONPATH": here}, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        stop_groups([proc])
        fail(f"{where}: did not finish within {timeout}s")
    finally:
        stop_groups([proc])
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"{where}: {' '.join(cmd[:7])} ... exited {proc.returncode}:\n{stdout[-2500:]}\n{stderr[-5000:]}")
    tallies = []
    for r in range(nproc):
        with open(os.path.join(out_dir, f"tally_rank{r}.json")) as f:
            tallies.append(json.load(f))
    return tallies, stdout, stderr, wall


def allreduce_share(path: str) -> tuple:
    """(share of the profiled window inside all_reduce calls, window ms)
    from a torch.profiler trace: the union of the intervals of events
    named like an all_reduce over the span of every timed event."""
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", []) if "dur" in e and "ts" in e]
    if not events:
        return 0.0, 0.0
    start = min(float(e["ts"]) for e in events)
    end = max(float(e["ts"]) + float(e["dur"]) for e in events)
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                   if "allreduce" in e["name"].lower().replace("_", ""))
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in spans:
        if cur_e is None or a > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += 0.0 if cur_e is None else cur_e - cur_s
    window = end - start
    return (busy / window if window > 0 else 0.0), window / 1e3


def mesh_train_report(np, config, tallies, where: str, card: str, index: str = "0"):
    """The train half of a launch: finite losses at every step, the fleet
    document with every rank's row; prints each rank's median step (the
    fleet row's p50 of the 6 steps), its share of the profiled step inside
    all_reduce and its peak memory (of the tallies' argument list
    ``index``).  Returns the metrics rows."""
    rows = metrics_rows(np, config, where)
    if [r["step"] for r in rows] != list(range(1, MESH_STEPS + 1)):
        fail(f"{where}: metrics.jsonl steps {[r['step'] for r in rows]}")
    tdir = os.path.join(config.summary_dir, "telemetry")
    with open(os.path.join(tdir, "fleet.json")) as f:
        fleet = json.load(f)
    n = len(tallies)
    if [h["process_index"] for h in fleet["hosts"]] != list(range(n)) or fleet["process_count"] != n:
        fail(f"{where}: fleet.json rows {[h['process_index'] for h in fleet['hosts']]}, expected {n} ranks")
    parts = []
    for r, tally in enumerate(tallies):
        host = fleet["hosts"][r]
        prof = os.path.join(os.path.dirname(config.save_dir), "prof")
        traces = glob.glob(os.path.join(prof, f"rank{r}" if n > 1 else "", "*", "trace.json"))
        share, window = allreduce_share(traces[0]) if traces else (0.0, 0.0)
        parts.append(f"rank {r}: median step {host['step_p50_ms']:.2f} ms (p95 {host['step_p95_ms']:.2f}), "
                     f"all_reduce {share:.1%} of a {window:.1f} ms profiled step, peak memory "
                     f"{tally[index]['peak_gib']:.3f} GiB")
    print(f"{where} on {card}: {'; '.join(parts)}", flush=True)
    return rows


def check_mesh_eval(tally, where: str, batches: int, kernel: bool = True):
    """An eval in one rank: ``batches`` batches decoded, B1 once a decode
    step when ``kernel`` (the context-parallel attend is plain code), the
    masked body never."""
    if tally["batches"] != batches:
        fail(f"{where}: {tally['batches']} batches decoded, expected {batches}")
    want = tally["steps"] if kernel else 0
    if tally["launches"] != want or tally["masked"]:
        fail(f"{where}: fused_attend launched {tally['launches']} times (masked {tally['masked']}) over "
             f"{tally['steps']} decode steps, expected {want}")


def result_words(path: str) -> dict:
    with open(path) as f:
        return {r["image_id"]: r["caption"] for r in json.load(f)}


def same_results(a: dict, b: dict) -> int:
    return sum(1 for k in a if b.get(k) == a[k])


# How far a mesh's training may sit from one process's: the losses and
# the gradient norms (before the clip) of every step, and the share of the
# final parameters' elements within 1e-6.  Only the order of the
# all_reduce's sum differs, so the limits sit a few times above the
# readings of that alone (losses 1.65e-5 / 2.06e-5 relative, 93.0% of the
# elements within 1e-6, data / vocab parallel; PERF.md, PR 13) and far
# below what a fault that scales the gradient or counts the L2 term on
# every data rank moves.
LOSS_RTOL = 1e-4
GRAD_NORM_RTOL = 1e-3
CLOSE_ABS, CLOSE_SHARE = 1e-6, 0.85


def relative(got, want) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def train_parity(np, rows, ref_rows, got_path: str, want_path: str, where: str) -> dict:
    """A mesh's training against one process's: the largest relative
    difference of the losses and of the gradient norms over the steps,
    and the final checkpoints' parameters (names and shapes equal; the
    largest absolute difference and the share of elements within
    ``CLOSE_ABS``)."""
    from sat_tpu_torch.train.checkpoint import load_flat

    got, want = load_flat(got_path), load_flat(want_path)
    if sorted(got) != sorted(want) or any(np.shape(got[k]) != np.shape(want[k]) for k in want):
        fail(f"{where}: {os.path.basename(got_path)} holds other names or shapes than the single process's")
    worst, close, total = 0.0, 0, 0
    for k in want:
        if not k.startswith("params/"):
            continue
        d = np.abs(np.asarray(got[k], np.float64) - np.asarray(want[k], np.float64))
        worst = max(worst, float(d.max()) if d.size else 0.0)
        close += int((d <= CLOSE_ABS).sum())
        total += d.size
    return {
        "losses": [r["total_loss"] for r in rows],
        "loss_rel": relative([r["total_loss"] for r in rows], [r["total_loss"] for r in ref_rows]),
        "grad_rel": relative([r["grad_norm"] for r in rows], [r["grad_norm"] for r in ref_rows]),
        "worst": worst,
        "close": close / max(total, 1),
    }


def parity_text(p: dict) -> str:
    return (f"losses within {p['loss_rel']:.2e} relative (limit {LOSS_RTOL:g}), gradient norms within "
            f"{p['grad_rel']:.2e} (limit {GRAD_NORM_RTOL:g}); 6.npz: {p['close']:.4%} of the parameters' "
            f"elements within {CLOSE_ABS:g} (limit {CLOSE_SHARE:.0%}), max abs {p['worst']:.3e}")


def hold_parity(p: dict, where: str) -> None:
    """Fails, naming every limit crossed, after the caller printed ``p``."""
    crossed = [text for bad, text in (
        (p["loss_rel"] > LOSS_RTOL, f"losses {p['loss_rel']:.2e} relative > {LOSS_RTOL:g}"),
        (p["grad_rel"] > GRAD_NORM_RTOL, f"gradient norms {p['grad_rel']:.2e} relative > {GRAD_NORM_RTOL:g}"),
        (p["close"] < CLOSE_SHARE, f"{p['close']:.4%} of the parameters within {CLOSE_ABS:g} < {CLOSE_SHARE:.0%}"),
    ) if bad]
    if crossed:
        fail(f"{where}: not one process's training: {'; '.join(crossed)}")


def replicated_equal(tallies, where: str, blocks=(), index: str = "0") -> int:
    """Every rank's parameter leaves after the train of argument list
    ``index`` bitwise rank 0's, but the vocab-sharded ``blocks`` (each rank
    its own block).  Returns the leaves compared."""
    first = tallies[0][index]["params"]
    compared = 0
    for r, t in enumerate(tallies[1:], start=1):
        for name, (shape, digest) in t[index]["params"].items():
            if name in blocks:
                continue
            compared += 1
            if shape != first[name][0] or digest != first[name][1]:
                fail(f"{where}: rank {r}'s replicated {name} is not bitwise rank 0's")
    return compared


def mesh_phase(np, tmp: str, card: str, got: dict):
    """One launch of ``python -m torch.distributed.run --standalone
    --nproc_per_node 2``, both ranks on this card under gloo, runs every
    mesh in turn (the same two ranks form each mesh's groups): (2,1) data
    parallelism trains the flagship 6 steps with ``--fleet_telemetry`` and
    its 5th step profiled, then evaluates its 6.npz; (1,2) vocab
    parallelism trains and evaluates the (2,1) 6.npz; (1,2) with
    ``context_parallel=2`` trains and evaluates the (2,1) 6.npz in float32
    and bf16.  Then one process: the same training (the reference), the
    (2,1) 6.npz evaluated at the ranks' batch of 10, in float32 and at
    batch 20, and the (2,1) 6.npz resumed for 2 more steps (the elastic
    phase's run).  Checks the data-parallel run here; the vocab-parallel,
    context-parallel and elastic phases check theirs.  Returns the B1
    launches of the data-parallel evals: (its ranks', the reference's)."""
    base = mesh_base(np, tmp)
    dp, dp_path = mesh_run_config(base, tmp, "dp", mesh_shape=(2, 1))
    tp, tp_path = mesh_run_config(base, tmp, "tp", mesh_shape=(1, 2))
    cp, cp_path = mesh_run_config(base, tmp, "cp", mesh_shape=(1, 2), context_parallel=2)
    single, single_path = mesh_run_config(base, tmp, "single")
    dp_model = os.path.join(dp.save_dir, "6.npz")
    cp_f32 = cp.eval_result_file.replace(".json", "_f32.json")
    tallies, out, err, wall = mesh_launch(tmp, "ranks", 2, [
        ["--config", dp_path, "--fleet_telemetry", *profiled(tmp, "dp")],
        ["--config", dp_path, "--phase", "eval"],
        ["--config", tp_path, "--fleet_telemetry", *profiled(tmp, "tp")],
        ["--config", tp_path, "--phase", "eval", "--model_file", dp_model],
        ["--config", cp_path, "--fleet_telemetry", *profiled(tmp, "cp")],
        ["--config", cp_path, "--phase", "eval", "--model_file", dp_model, "--set", "compute_dtype=float32",
         "--set", f"eval_result_file={cp_f32}"],
        ["--config", cp_path, "--phase", "eval", "--model_file", dp_model],
    ], "mesh train")
    if SHARED_CARD not in err:
        fail(f"mesh train: rank 0 did not report two ranks sharing cuda:0 under gloo:\n{err[-3000:]}")
    one_b10, one_f32, one_b20 = (single.eval_result_file.replace(".json", f"_{tag}.json")
                                 for tag in ("b10", "f32", "b20"))
    elastic_tdir = os.path.join(tmp, "mesh", "elastic_tel")
    # the batch-20 bf16 eval last of the evals: its scores are the last printed
    ref, ref_out, ref_err, ref_wall = mesh_launch(tmp, "single", 1, [
        ["--config", single_path, "--fleet_telemetry", *profiled(tmp, "single")],
        ["--config", single_path, "--phase", "eval", "--model_file", dp_model, "--set", "batch_size=10", "--set",
         f"eval_result_file={one_b10}"],
        ["--config", single_path, "--phase", "eval", "--model_file", dp_model, "--set", "compute_dtype=float32",
         "--set", f"eval_result_file={one_f32}"],
        ["--config", single_path, "--phase", "eval", "--model_file", dp_model, "--set",
         f"eval_result_file={one_b20}"],
        ["--config", dp_path, "--load", "--set", "mesh_shape=1,1", "--set", f"max_steps={MESH_STEPS + 2}",
         "--set", "num_epochs=2", "--telemetry", "--heartbeat_interval", "0.5", "--set",
         f"telemetry_dir={elastic_tdir}", "--set", f"summary_dir={os.path.join(tmp, 'mesh', 'elastic')}"],
    ], "mesh reference")
    got.update(ranks=tallies, ranks_out=out, tp=tp, cp=cp, cp_f32=cp_f32, single=single, one_f32=one_f32,
               one_b20=one_b20, ref_out=ref_out, ref_err=ref_err, dp=dp, elastic_tdir=elastic_tdir)
    single_rows = mesh_train_report(np, single, ref, "mesh reference (one process)", card)
    dp_rows = mesh_train_report(np, dp, tallies, "mesh train (2,1)", card, index="0")
    parity = train_parity(np, dp_rows, single_rows, dp_model, os.path.join(single.save_dir, "6.npz"),
                          "mesh train (2,1)")
    got["single_rows"] = single_rows
    compared = replicated_equal(tallies, "mesh train (2,1)", index="0")
    for r, t in enumerate(tallies):
        check_mesh_eval(t["1"], f"mesh eval (2,1) rank {r}", batches=5)
    dp_words, one10, one20 = result_words(dp.eval_result_file), result_words(one_b10), result_words(one_b20)
    print(f"mesh train on {card}: one launch of two ranks on cuda:0 under gloo ran the (2,1), (1,2) vocab- and "
          f"(1,2) context-parallel meshes (3 x {MESH_STEPS} steps, 4 evals) in {wall:.2f}s (per list: "
          f"{[round(tallies[0][k]['wall_s'], 2) for k in sorted(tallies[0], key=int)]} s); the one-process "
          f"reference (train, 3 evals, the elastic resume) in {ref_wall:.2f}s ("
          f"{[round(ref[0][k]['wall_s'], 2) for k in sorted(ref[0], key=int)]} s)", flush=True)
    print(f"mesh train (2,1) on {card}: losses {[round(x, 5) for x in parity['losses']]} vs one process "
          f"{[round(r['total_loss'], 5) for r in single_rows]}: {parity_text(parity)}; {compared} leaves bitwise "
          f"equal across ranks; fleet.json 2 rows", flush=True)
    hold_parity(parity, "mesh train (2,1)")
    print(f"mesh eval (2,1) on {card}: B1 launches {[t['1']['launches'] for t in tallies]} over "
          f"{[t['1']['steps'] for t in tallies]} decode steps, 5 batches of 10 rows a rank; results.json "
          f"{same_results(dp_words, one10)}/{len(one10)} captions one process's eval of the same 6.npz at the "
          f"ranks' batch of 10, {same_results(dp_words, one20)}/{len(one20)} at batch 20", flush=True)
    if dp_words != one10:
        fail("mesh eval (2,1): results.json differs from one process's eval of the same 6.npz at batch 10")
    return sum(t["1"]["launches"] for t in tallies), sum(ref[0][k]["launches"] for k in ("1", "2", "3"))


def vocab_parallel_phase(np, tmp: str, card: str, got: dict):
    """Vocab tensor parallelism, (1,2), from the mesh launch: the losses
    and gradient norms against the reference's, the gathered 6.npz full
    width and close to the reference's (``hold_parity``), the replicated
    leaves bitwise equal, the embedding and the last decode layer a block
    a rank; its eval of the (2,1) 6.npz one process's words.  Returns its
    ranks' B1 launches."""
    tp, single, tallies = got["tp"], got["single"], got["ranks"]
    rows = mesh_train_report(np, tp, tallies, "vocab parallel (1,2)", card, index="2")
    half = tp.vocabulary_size // 2
    blocks = sorted(n for n, (shape, _) in tallies[0]["2"]["params"].items() if half in shape)
    if len(blocks) != 3:
        fail(f"vocab parallel: vocab-sharded blocks {blocks}, expected the embedding and the last decode layer")
    compared = replicated_equal(tallies, "vocab parallel", blocks, index="2")
    parity = train_parity(np, rows, got["single_rows"], os.path.join(tp.save_dir, "6.npz"),
                          os.path.join(single.save_dir, "6.npz"), "vocab parallel")
    for r, t in enumerate(tallies):
        check_mesh_eval(t["3"], f"vocab parallel eval rank {r}", batches=5)
    words, one_words = result_words(tp.eval_result_file), result_words(got["one_b20"])
    print(f"vocab parallel (1,2) on {card}: losses {[round(x, 5) for x in parity['losses']]} against one "
          f"process: {parity_text(parity)}, 6.npz full width (word_embedding, decode/fc_2 gathered); {compared} "
          f"replicated leaves bitwise equal across ranks, {len(blocks)} vocab-sharded blocks {blocks}; eval of the (2,1) "
          f"6.npz: B1 launches {[t['3']['launches'] for t in tallies]} over {[t['3']['steps'] for t in tallies]} "
          f"decode steps, {same_results(words, one_words)}/{len(one_words)} captions one process's eval of it",
          flush=True)
    hold_parity(parity, "vocab parallel")
    if words != one_words:
        fail("vocab parallel: results.json differs from one process's eval of the same 6.npz")
    return sum(t["3"]["launches"] for t in tallies)


def context_parallel_phase(np, tmp: str, card: str, got: dict):
    """Context parallelism, (1,2) with ``context_parallel=2`` (98 of the
    196 positions a rank), from the mesh launch: the loss falls over the 6
    steps, the ranks' parameters bitwise equal; the (2,1) 6.npz decoded in
    float32 (one process's float32 words) and in bf16 (held by caption
    parity: at least 90% of the captions the same and every score within
    0.05 of one process's bf16 eval; the CP attend rounds differently
    from B1).  The context-parallel attend is plain tensor code, so B1
    does not run."""
    cp, tallies = got["cp"], got["ranks"]
    losses = [r["total_loss"] for r in mesh_train_report(np, cp, tallies, "context parallel (1,2)", card,
                                                         index="4")]
    first, last = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
    if not last < first:
        fail(f"context parallel: the loss did not fall: {losses}")
    compared = replicated_equal(tallies, "context parallel", index="4")
    for r, t in enumerate(tallies):
        for k in ("5", "6"):
            check_mesh_eval(t[k], f"context parallel eval rank {r}", batches=5, kernel=False)
    words32, one32 = result_words(got["cp_f32"]), result_words(got["one_f32"])
    if words32 != one32:
        fail(f"context parallel: float32 eval {same_results(words32, one32)}/{len(one32)} captions one "
             "process's float32 eval, expected all")
    words, one = result_words(cp.eval_result_file), result_words(got["one_b20"])
    agree = same_results(words, one)
    scores = printed_scores(np, got["ranks_out"], "context parallel bf16 eval")
    ref_scores = printed_scores(np, got["ref_out"], "mesh reference eval")
    worst_score = max(abs(scores[k] - ref_scores[k]) for k in scores)
    print(f"context parallel (1,2) on {card}: losses {[round(x, 5) for x in losses]} (mean {first:.4f} -> "
          f"{last:.4f}); {compared} leaves bitwise equal across ranks; the (2,1) 6.npz decoded in float32: "
          f"{same_results(words32, one32)}/{len(one32)} captions one process's float32 eval; bf16: "
          f"{agree}/{len(one)} captions, scores within {worst_score:.4f}", flush=True)
    if agree < 0.9 * len(one) or worst_score > 0.05:
        fail(f"context parallel: bf16 eval past the caption-parity gate: {agree}/{len(one)} captions, "
             f"scores {worst_score:.4f} apart")
    return 0


def elastic_phase(np, tmp: str, card: str, got: dict):
    """The (2, 1) run's 6.npz resumed by one process for 2 more steps (in
    the reference launch): ``ckpt/elastic_restores`` 1 in its heartbeat,
    the stderr line, the 6.npz sidecar recording 2 processes and mesh
    [2, 1], 8.npz recording one."""
    from sat_tpu_torch.resilience import lineage

    dp = got["dp"]
    with open(os.path.join(got["elastic_tdir"], "heartbeat.json")) as f:
        beat = json.load(f)
    count = beat["counters"].get("ckpt/elastic_restores")
    before = lineage.read_sidecar_meta(os.path.join(dp.save_dir, "6.npz")).get("topology", {})
    after = lineage.read_sidecar_meta(os.path.join(dp.save_dir, "8.npz")).get("topology", {})
    line = "elastic resume — checkpoint 6.npz was written on 2 device(s) (mesh [2, 1]), restoring onto 1"
    print(f"elastic on {card}: ckpt/elastic_restores {count}; 6.npz topology {before}; 8.npz topology {after}; "
          f"LAST_GOOD {lineage.last_good_step(dp.save_dir)}", flush=True)
    if count != 1 or line not in got["ref_err"]:
        fail(f"elastic: ckpt/elastic_restores {count}, stderr line present {line in got['ref_err']}")
    if (before.get("process_count"), before.get("mesh_shape")) != (2, [2, 1]) or after.get("process_count") != 1:
        fail(f"elastic: sidecar topologies {before} / {after}")
    if lineage.last_good_step(dp.save_dir) != MESH_STEPS + 2:
        fail(f"elastic: LAST_GOOD {lineage.last_good_step(dp.save_dir)}, expected {MESH_STEPS + 2}")


QUALITY_IMAGES = 16   # of the basic corpus's 48: 32 pairs, 4 steps an epoch at batch 8
QUALITY_STEPS = 200   # the protocol's 1200 cut to fit the run
QUALITY_BLEU4 = (0.5, 0.05)   # trained at least, untrained init at most


def quality_phase(torch, np, tmp: str, card: str) -> dict:
    """The quality protocol through ``python -m sat_tpu_torch.tools.
    quality_run`` at full width (VGG16 at 224 px, ``--train_cnn``, batch
    8, vocabulary 200, bf16) on ``QUALITY_IMAGES`` images for
    ``QUALITY_STEPS`` steps, then the run's untrained init (its seed's
    state, saved as 0.npz) evaluated in-process with the same eval config.
    Gates BLEU-4 (``QUALITY_BLEU4``) and B1 once a decode step of each
    beam eval; then ``export_reference`` (the npy imports back bitwise)
    and ``trim_model`` (every non-optimizer array kept bitwise) on the
    trained checkpoint.  Returns what the replay phase needs and the B1
    launches."""
    from sat_tpu_torch import runtime
    from sat_tpu_torch.cli import build_config
    from sat_tpu_torch.ops import fused_attend as fa
    from sat_tpu_torch.tools import export_reference, trim_model
    from sat_tpu_torch.tools.quality_run import protocol_overrides, serving_state, set_args
    from sat_tpu_torch.train.checkpoint import load_flat, params_to_flat, save_checkpoint

    out = os.path.join(tmp, "quality")
    tally, stdout = run_cli(["sat_tpu_torch.tools.quality_run", "--steps", str(QUALITY_STEPS), "--out", out,
                             "--num-images", str(QUALITY_IMAGES), "--batch-size", "8"], "quality", timeout=900,
                            harness=TOOL_HARNESS)
    check_tally(tally, "quality", batches=QUALITY_IMAGES // 8)
    with open(os.path.join(out, "scores.json")) as f:
        payload = json.load(f)
    with open(os.path.join(out, "results.json")) as f:
        results = json.load(f)
    steps = payload["steps"]
    if steps != QUALITY_STEPS or len(results) != QUALITY_IMAGES:
        fail(f"quality: {steps} steps and {len(results)} captions, expected {QUALITY_STEPS} and {QUALITY_IMAGES}")
    rows = [json.loads(line) for line in open(os.path.join(out, "summary", "metrics.jsonl"))]
    losses = [(r["step"], round(r["total_loss"], 4)) for r in rows]
    print(f"quality on {card}: {steps} --train_cnn steps at batch 8 over {QUALITY_IMAGES} images in "
          f"{payload['train_seconds']}s of training ({tally['wall_s']:.2f}s process start to exit); device "
          f"{payload['device']!r}, power limit {payload['power_limit']}; scores {payload['scores']}; loss at "
          f"steps {losses[0]} .. {losses[-1]}; eval decode {tally['decode_s'][0]:.3f}s, B1 launches "
          f"{tally['launches']} over {tally['steps']} decode steps; sample {results[0]}", flush=True)

    sets = set_args(protocol_overrides(out, "basic", 8, 224, "vgg16"))
    config, _ = build_config(["--phase=train", "--train_cnn"] + sets)
    init = runtime.setup_train_state(config, device="cuda")
    init_path = save_checkpoint(init, config, save_dir=os.path.join(out, "init"))
    eval_config, _ = build_config(["--phase=eval", "--beam_size=3"] + sets)
    eval_config = eval_config.replace(eval_result_file=os.path.join(out, "results_init.json"))
    fa.fused_attend.launches = fa.fused_attend.masked_launches = 0
    untrained = runtime.evaluate(eval_config, state=serving_state(init), device="cuda")
    init_launches = fa.fused_attend.launches
    del init
    trained_b4, init_b4 = payload["scores"]["Bleu_4"], untrained["Bleu_4"]
    print(f"quality untrained init on {card}: scores {untrained}; B1 launches {init_launches}", flush=True)
    if not (trained_b4 >= QUALITY_BLEU4[0] and init_b4 <= QUALITY_BLEU4[1]):
        fail(f"quality: BLEU-4 {trained_b4:.4f} trained (gate >= {QUALITY_BLEU4[0]}), {init_b4:.4f} untrained "
             f"(gate <= {QUALITY_BLEU4[1]})")
    if init_launches <= 0 or fa.fused_attend.masked_launches:
        fail(f"quality: the untrained eval launched B1 {init_launches} times, B2 {fa.fused_attend.masked_launches}")

    ckpt = os.path.join(out, "models", f"{steps}.npz")
    flat = load_flat(ckpt)
    exported, trimmed = os.path.join(out, "exported.npy"), os.path.join(out, "trimmed.npz")
    if export_reference.main([ckpt, exported]) != 0 or trim_model.main([ckpt, trimmed]) != 0:
        fail("quality: export_reference or trim_model did not exit 0")
    back = params_to_flat(runtime.setup_state(config, model_file=exported, device="cuda").params)
    params = {k: v for k, v in flat.items() if k.startswith("params/")}
    if sorted(back) != sorted(params) or not all(np.array_equal(back[k], params[k]) for k in params):
        fail("quality: the exported npy does not import back to the checkpoint's parameters bitwise")
    slim = load_flat(trimmed)
    kept = {k: v for k, v in flat.items() if not k.startswith("optimizer/")}
    if sorted(slim) != sorted(kept) or not all(np.array_equal(slim[k], kept[k]) for k in kept):
        fail("quality: the trimmed npz is not the checkpoint without its optimizer slots")
    print(f"quality export and trim on {card}: {len(params)} parameters through the reference's npy and back "
          f"bitwise; trimmed {len(flat)} -> {len(slim)} entries "
          f"({os.path.getsize(ckpt) / 2**20:.1f} -> {os.path.getsize(trimmed) / 2**20:.1f} MiB)", flush=True)
    return {"out": out, "ckpt": ckpt, "init": init_path, "launches": tally["launches"] + init_launches}


REPLAY_BURST = 6   # concurrent requests a burst, two bursts a serve mode


def replay_phase(torch, np, quality: dict, card: str):
    """The quality phase's trained checkpoint served in batch and then in
    continuous mode with the quality plane on (every request an outlier,
    the recorder's rate limit off, one exemplar directory), two bursts of
    ``REPLAY_BURST`` concurrent corpus JPEGs each; then ``python -m
    sat_tpu_torch.tools.replay_exemplar --all`` in a fresh process must
    exit 0 with every row replayed bitwise in its captured geometry, and
    ``--diff`` against the untrained init (in-process) reports each
    row's divergence.  Returns the (B1, B2) launches of the serving and
    the replays."""
    import contextlib
    import io

    from sat_tpu_torch import telemetry
    from sat_tpu_torch.config import Config
    from sat_tpu_torch.ops import fused_attend as fa
    from sat_tpu_torch.telemetry.exemplar import read_exemplars
    from sat_tpu_torch.tools import replay_exemplar

    out = quality["out"]
    exdir = os.path.join(out, "exemplars")
    base = Config.load(os.path.join(out, "models", "config.json")).replace(
        phase="serve", serve_quality="on", serve_quality_margin_min=1e9, serve_quality_exemplar_dir=exdir,
        telemetry_dir=os.path.join(out, "serve_tel"), heartbeat_interval=0.0)
    bodies = []
    for path in sorted(glob.glob(os.path.join(out, "images", "*.jpg")))[:2 * REPLAY_BURST]:
        with open(path, "rb") as f:
            bodies.append(f.read())
    served = {}
    fa.fused_attend.launches = fa.fused_attend.masked_launches = 0
    telemetry.enable()
    try:
        for mode in ("batch", "continuous"):
            config = base.replace(serve_mode=mode)
            server = planes_server(config, planes_engine(config))
            server.exemplars.min_interval_s = 0.0
            try:
                for i in range(2):
                    _, replies = post_all(server.port, bodies[i * REPLAY_BURST:(i + 1) * REPLAY_BURST])
                    if any(r[0] != 200 for r in replies):
                        fail(f"replay: {mode} burst replies {[r[0] for r in replies]}")
            finally:
                server.shutdown()
            served[mode] = server.exemplars.stats()["recorded"]
            del server
    finally:
        telemetry.disable()
    serve_b1, serve_b2 = fa.fused_attend.launches, fa.fused_attend.masked_launches
    rows, _ = read_exemplars(exdir)
    shapes = [(r.get("geometry") or {}).get("mode") for r in rows]
    wide = [r for r in rows if (r.get("geometry") or {}).get("encode_width", 1) > 1]
    print(f"replay capture on {card}: {len(rows)} exemplars ({shapes.count('batch')} batch, "
          f"{shapes.count('continuous')} continuous; {len(wide)} captured wider than 1: "
          f"{sorted({(r['geometry']['mode'], r['geometry']['encode_width']) for r in wide})}); serving launched "
          f"B1 {serve_b1}, B2 {serve_b2}", flush=True)
    if shapes.count("batch") < 2 or shapes.count("continuous") < 2 or not wide:
        fail(f"replay: exemplars {shapes}, none wider than 1: {not wide}")

    tally, stdout = run_cli(["sat_tpu_torch.tools.replay_exemplar", "--dir", exdir, "--all"], "replay",
                            harness=TOOL_HARNESS)
    verdicts = [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]
    matched = [v for v in verdicts if v["verdict"] == "BITWISE MATCH"]
    if len(verdicts) != len(rows) or len(matched) != len(rows):
        fail(f"replay: {len(matched)}/{len(rows)} exemplars replayed bitwise:\n{stdout[-3000:]}")
    if tally["launches"] <= 0 or tally["masked"] <= 0:
        fail(f"replay: the replay launched B1 {tally['launches']}, B2 {tally['masked']} times")
    digests = sum(v["alphas_digest_captured"] == v["alphas_digest_replayed"] for v in verdicts)
    print(f"replay on {card}: --all exit 0, {len(matched)}/{len(rows)} captions bitwise in their captured "
          f"geometry ({tally['wall_s']:.2f}s process start to exit), alphas digests equal {digests}/{len(rows)}; "
          f"B1 launches {tally['launches']}, B2 {tally['masked']}", flush=True)

    # the same rows alone at bucket 1 (where the JAX script replays every
    # row): what a replay that ignored the capture's geometry would see
    from sat_tpu_torch.telemetry.exemplar import load_image

    fa.fused_attend.launches = fa.fused_attend.masked_launches = 0
    with contextlib.redirect_stderr(io.StringIO()):
        alone = replay_exemplar.Replayer(Config.from_dict(json.load(open(os.path.join(exdir, "meta.json")))["config"]),
                                         None, "cuda")
    lone = [alone.caption(load_image(exdir, r)) for r in wide]
    print(f"replay at bucket 1 on {card}: of the {len(wide)} exemplars captured wider than 1, "
          f"{sum(a['caption'] != r['caption'] for a, r in zip(lone, wide))} captions and "
          f"{sum(a['alphas_digest'] != r['alphas_digest'] for a, r in zip(lone, wide))} alphas digests differ "
          "from the capture's", flush=True)
    del alone
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = replay_exemplar.main(["--dir", exdir, "--all", "--diff", quality["init"], quality["ckpt"]])
    diffs = [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith("{")]
    if rc != 0 or len(diffs) != len(rows):
        fail(f"replay --diff: exit {rc}, {len(diffs)} rows of {len(rows)}")
    div = [d["divergence"] for d in diffs]
    print(f"replay --diff untrained init vs trained on {card}: divergence mean {sum(div) / len(div):.4f}, min "
          f"{min(div):.4f}, max {max(div):.4f} over {len(div)} exemplars; sample {diffs[0]}", flush=True)
    return (serve_b1 + tally["launches"] + fa.fused_attend.launches,
            serve_b2 + tally["masked"] + fa.fused_attend.masked_launches)


# -- the chaos campaign and the V=5000 run (the evidence tools) --------------

# the campaign's small model widened to the flagship's (compute_dtype stays
# float32, as the campaign's small model has it: scenarios compare
# checkpoints bitwise)
FLAGSHIP_SETS = ("image_size=224", "dim_embedding=512", "num_lstm_units=512", "dim_initialize_layer=512",
                 "dim_attend_layer=512", "dim_decode_layer=1024")
# the six scenarios, as three campaigns run side by side (the card and the
# host's cores are shared; every deadline in them is seconds, a flagship
# step a fraction of one); the supervised wedge and its control share a
# workdir (their 6.npz are compared)
CHAOS_GROUPS = (("control", "wedge_watchdog"), ("poison_quarantine_replay",),
                ("wedge_postmortem", "systemic_no_restart", "serve_wedge_continuous"))


def chaos_start(tmp: str):
    """Start ``python -m sat_tpu_torch.tools.chaos_campaign`` at flagship
    widths (``--extra-set``) with ``--keep --workdir``, one campaign a
    group of ``CHAOS_GROUPS``, side by side; returns what
    :func:`chaos_finish` reads."""
    root = os.path.join(tmp, "chaos")
    os.makedirs(root)
    sets = [x for w in FLAGSHIP_SETS for x in ("--extra-set", w)]
    started = []
    for i, group in enumerate(CHAOS_GROUPS):
        wd = os.path.join(root, f"campaign{i}")
        args = ["--only", ",".join(group), "--keep", "--workdir", wd,
                "--out", os.path.join(root, f"report{i}", "report.json"), *sets]
        started.append((wd, args, start_child(os.path.join(root, f"campaign{i}"),
                                              ["-m", "sat_tpu_torch.tools.chaos_campaign", *args])))
    return root, started


def chaos_finish(np, chaos, card: str):
    """Wait for :func:`chaos_start`'s six scenarios: each campaign exits 0
    with pass rate 1.0.  From the kept workdirs: the supervised wedge's
    exit 86 after the watchdog's stack dump, one restart from LAST_GOOD
    3, LAST_GOOD 6, its 6.npz bitwise the control's; the wedge's
    postmortem bundle (exit 86); the poison run's heartbeat and
    quarantine epochs; the continuous serve wedge launched B2 on cuda:0.
    Returns the B2 launches."""
    from sat_tpu_torch.resilience import lineage
    from sat_tpu_torch.train.checkpoint import load_flat

    root, started = chaos
    reports, workdirs = {}, {}
    for i, (wd, args, child) in enumerate(started):
        rc, _, err, wall = finish_child(child, f"chaos campaign {i}", timeout=900)
        print(f"chaos campaign {i} on {card}: python -m sat_tpu_torch.tools.chaos_campaign {' '.join(args)} "
              f"exited {rc} in {wall:.1f}s", flush=True)
        path, rows = os.path.join(root, f"report{i}", "report.json"), []
        if os.path.exists(path):
            with open(path) as f:
                rows = json.load(f)
        for row in rows[:-1]:
            extras = {k: v for k, v in row.items() if k not in ("metric", "value", "unit", "vs_baseline",
                                                                 "seconds", "schema_version", "git_sha",
                                                                 "run_id", "stamp_unix", "process_index",
                                                                 "process_count", "device")}
            print(f"chaos {row['metric'][len('chaos_'):]} on {card}: {'PASS' if row['value'] == 1.0 else 'FAIL'} "
                  f"in {row['seconds']}s {json.dumps(extras)}", flush=True)
        if rc != 0 or not rows or rows[-1]["value"] != 1.0 or rows[-1]["scenarios"] != len(CHAOS_GROUPS[i]):
            fail(f"chaos campaign {i}: exit {rc}, pass rate {rows[-1] if rows else None}:\n{err[-4000:]}")
        if rows[-1]["device"].get("kind") != torch_kind():
            fail(f"chaos campaign {i}: its rows are stamped {rows[-1]['device']}, not the card")
        for r in rows[:-1]:
            name = r["metric"][len("chaos_"):]
            reports[name], workdirs[name] = r, wd

    where = "chaos wedge_watchdog"
    wd = workdirs["wedge_watchdog"]
    with open(os.path.join(wd, "wedge.err")) as f:
        err = f.read()
    with open(os.path.join(wd, "wedge.out")) as f:
        out = f.read()
    for line in ("sat_tpu_torch watchdog: phase 'step' exceeded", "aborting with exit code 86",
                 "watchdog abort (wedged run; LAST_GOOD landed)", "run completed after 1 restart(s)"):
        if line not in err:
            fail(f"{where}: {line!r} is not in the supervisor's stderr:\n{err[-3000:]}")
    if err.count("restarting from LAST_GOOD") != 1 or "tensors loaded from checkpoint (step 3)." not in out:
        fail(f"{where}: not one restart from LAST_GOOD 3:\n{err[-2000:]}\n{out[-2000:]}")
    dump = os.path.join(wd, "wedge", "summary", "telemetry", "watchdog_stacks.txt")
    if not os.path.isfile(dump):
        fail(f"{where}: no stack dump at {dump}")
    save_dir = os.path.join(wd, "wedge", "models")
    if lineage.last_good_step(save_dir) != 6:
        fail(f"{where}: LAST_GOOD {lineage.last_good_step(save_dir)}, expected 6")
    got = load_flat(os.path.join(save_dir, "6.npz"))
    want = load_flat(os.path.join(wd, "control", "models", "6.npz"))
    if sorted(got) != sorted(want):
        fail(f"{where}: the two 6.npz hold different names")
    differing = [k for k in want if not np.array_equal(np.asarray(got[k]), np.asarray(want[k]))]
    bundles = glob.glob(os.path.join(workdirs["wedge_postmortem"], "wedge_pm", "summary", "telemetry",
                                     "postmortem_*"))
    manifests = []
    for b in bundles:
        with open(os.path.join(b, "manifest.json")) as f:
            manifests.append(json.load(f))
    if len(bundles) != 1 or manifests[0]["reason"] != "watchdog_wedge" or manifests[0]["exit_code"] != 86:
        fail(f"chaos wedge_postmortem: postmortem bundles {bundles} {manifests}")
    print(f"{where} on {card}: the flagship (widths {', '.join(FLAGSHIP_SETS)}, float32) trained 6 steps "
          f"under --supervise with SAT_FI_WEDGE_AT_STEP=5 (5 s step deadline): the watchdog's stack dump, exit 86, "
          f"one restart from LAST_GOOD 3, LAST_GOOD 6 ({reports['wedge_watchdog']['seconds']}s, the control "
          f"{reports['control']['seconds']}s); final 6.npz vs the control's: {len(differing)}/{len(want)} "
          f"arrays differ; the wedge_postmortem run's bundle {sorted(os.listdir(bundles[0]))} "
          f"(phase {manifests[0].get('phase')!r})", flush=True)
    if differing:
        fail(f"{where}: the supervised run's 6.npz is not bitwise its control's: {differing[:5]}")
    wd = workdirs["poison_quarantine_replay"]
    with open(os.path.join(wd, "poison", "summary", "telemetry", "heartbeat.json")) as f:
        beat = json.load(f)
    with open(os.path.join(wd, "poison_ledger.jsonl")) as f:
        records = [json.loads(line) for line in f if line.strip()]
    if beat.get("epoch") is None or not records or any(r.get("epoch") is None for r in records):
        fail(f"chaos poison_quarantine_replay: heartbeat epoch {beat.get('epoch')}, quarantine records {records}")
    print(f"chaos poison_quarantine_replay on {card}: heartbeat epoch {beat['epoch']}, the quarantine "
          f"records' epochs {[r['epoch'] for r in records]}", flush=True)
    serve = reports["serve_wedge_continuous"]
    if serve["serve_device"] != "cuda:0" or serve["masked_launches"] <= 0 or serve["launches"] != 0:
        fail(f"chaos serve_wedge_continuous: device {serve['serve_device']}, B1 {serve['launches']}, "
             f"B2 {serve['masked_launches']}: the masked kernel did not run on the card alone")
    return serve["masked_launches"]


def torch_kind() -> str:
    import torch

    return torch.cuda.get_device_name(0)


V5000_STEPS = 8   # of the tool's 48


def vocab5000_start(tmp: str):
    """Start ``python -m sat_tpu_torch.tools.vocab5000_run --steps 8
    --eval-anns 8 --image-size 224`` (1700 rich-corpus images) in a fresh
    process with CLI_HARNESS's counts; returns what
    :func:`vocab5000_finish` reads."""
    out = os.path.join(tmp, "vocab5000")
    return out, start_child(out, ["-c", TOOL_HARNESS, "sat_tpu_torch.tools.vocab5000_run", "--steps",
                                  str(V5000_STEPS), "--eval-anns", "8", "--image-size", "224", "--out", out])


def vocab5000_finish(np, v5000, card: str):
    """Wait for :func:`vocab5000_start`'s run: exit 0, the vocabulary
    exactly 5000 words, the tensors sharded over ``model`` (the embedding
    rows and the last decode layer's kernel and bias), the loss parity of
    one process and the (2,4) mesh (eight ranks sharing the card under
    gloo) under 5e-2 at every record, finite scores both ways, B1 once a
    decode step of the one-process eval and in every rank of the mesh's.
    Returns the B1 launches."""
    where = "vocab5000"
    out, child = v5000
    rc, stdout, stderr, wall = finish_child(child, where, timeout=900)
    if rc != 0:
        fail(f"{where}: python -m sat_tpu_torch.tools.vocab5000_run exited {rc}:\n{stdout[-3000:]}\n"
             f"{stderr[-3000:]}")
    tally = harness_tally(stdout, stderr, wall, where)
    with open(os.path.join(out, "result.json")) as f:
        r = json.load(f)
    print(f"{where} on {card}: {json.dumps({k: v for k, v in r.items() if not k.startswith('scores')})}",
          flush=True)
    print(f"{where} scores (beam 3, {V5000_STEPS} steps from random weights): one process "
          f"{ {k: round(v, 4) for k, v in r['scores_single'].items()} }, mesh "
          f"{ {k: round(v, 4) for k, v in r['scores_tp'].items()} }", flush=True)
    print(f"{where} median step on {card}: one process {r['step_ms_single']} ms, the (2,4) mesh's rank 0 "
          f"{r['step_ms_tp']} ms (batch 8, V=5000, 224 px; eight ranks time-slice the card)", flush=True)
    if r["vocab_words"] != 5000 or r["tp_sharded_tensors"] != 3 or r["mesh_shape"] != [2, 4]:
        fail(f"{where}: vocabulary {r['vocab_words']}, {r['tp_sharded_tensors']} tensors sharded over model, "
             f"mesh {r['mesh_shape']}")
    if not r["loss_parity_max_rel"] < 5e-2 or r["train_steps"] != V5000_STEPS or r["loss_records"] < 2:
        fail(f"{where}: loss parity {r['loss_parity_max_rel']} over {r['loss_records']} records")
    for key in ("scores_single", "scores_tp"):
        if len(r[key]) != 7 or not all(np.isfinite(v) for v in r[key].values()):
            fail(f"{where}: {key} {r[key]}")
    if r["device"] != torch_kind():
        fail(f"{where}: ran on {r['device']}")
    if not 0 < tally["steps"] == tally["launches"] == r["launches_single_eval"] or tally["masked"]:
        fail(f"{where}: the one-process eval launched B1 {tally['launches']} times over {tally['steps']} decode "
             f"steps (masked {tally['masked']})")
    ranks = r["launches_tp_eval_ranks"]
    if len(ranks) != 8 or not all(n > 0 for n in ranks):
        fail(f"{where}: the mesh eval's ranks launched B1 {ranks}")
    return tally["launches"] + sum(ranks)


# the demo's flagship: VGG16 at 224 px, the 512 widths, bf16 compute
MULTIHOST_SETS = FLAGSHIP_SETS + ("compute_dtype=bfloat16",)
# worker 0's stall a step under --fleet.  Two ranks time-slice the card and
# their collectives keep them in lockstep, so the fleet plane reads each
# rank's own step (its wall time less its waits on the other); with two
# ranks the 1.5x factor over their median needs the slowed rank at more
# than three times the other's p95, so the stall is several times the own
# step the phase measures (checked below; 127 / 172 ms p50 / p95 at 800).
MULTIHOST_SLOW_MS = 600


def run_multihost(root: str, args, timeout: int):
    """``python -m sat_tpu_torch.tools.multihost_demo`` in its own session
    (a timeout kills its ranks too); (rc, stdout, stderr, seconds)."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "sat_tpu_torch.tools.multihost_demo", "--root", root,
         "--port", str(free_base_port(3)), *args],
        cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        fail(f"multihost_demo {' '.join(args)}: no end within {timeout}s:\n{out[-3000:]}\n{err[-2000:]}")
    return proc.returncode, out, err, time.perf_counter() - t0


def multihost_tallies(root: str, procs: int):
    tallies = []
    for r in range(procs):
        with open(os.path.join(root, f"tally_p{r}.json")) as f:
            tallies.append(json.load(f))
    return tallies


def multihost_phase(tmp: str, card: str):
    """``python -m sat_tpu_torch.tools.multihost_demo --fleet --procs 2`` at
    flagship widths (``--extra-set``, bf16): two OS processes started by
    the tool share ``cuda:0`` under gloo, train 40 steps (worker 0 slowed
    by ``--slow-ms`` or six of its own steps, the longer), checkpoint, and run the mesh eval with the
    cross-rank gather and the attention panels.  rc 0 and the banner;
    fleet.json with 2 hosts and process 0 the straggler (its skew and each
    rank's own step printed; the stall at least the other rank's p95 own
    step); rank 0 on the shared card; B1 launched in each rank's eval.
    Returns the ranks' B1 launches."""
    from sat_tpu_torch.tools.multihost_demo import FLEET_SLOW_SCALE

    where = "multihost"
    root = os.path.join(tmp, "multihost")
    sets = [x for w in MULTIHOST_SETS for x in ("--extra-set", w)]
    args = ["--fleet", "--procs", "2", "--slow-ms", str(MULTIHOST_SLOW_MS), "--join-timeout", "300", *sets]
    rc, out, err, wall = run_multihost(root, args, timeout=400)
    banner = [line for line in out.splitlines() if line.startswith("MULTIHOST OK")]
    if rc != 0 or banner != [line for line in banner if "MULTIHOST OK (data-parallel): 2 processes" in line] \
            or len(banner) != 1:
        fail(f"{where}: rc {rc}, banner {banner}:\n{out[-4000:]}\n{err[-2000:]}")
    with open(os.path.join(root, "fleet", "fleet.json")) as f:
        doc = json.load(f)
    verdict, hosts = doc.get("straggler", {}), {h["process_index"]: h for h in doc.get("hosts", [])}
    if doc.get("hosts_reporting") != 2 or not verdict.get("verdict") or verdict.get("process_index") != 0:
        fail(f"{where}: fleet.json hosts {doc.get('hosts_reporting')}, straggler {verdict}")
    if not hosts[1]["step_p95_ms"] < MULTIHOST_SLOW_MS:
        fail(f"{where}: --slow-ms {MULTIHOST_SLOW_MS} is under rank 1's own step p95 {hosts[1]['step_p95_ms']} ms")
    with open(os.path.join(root, "worker_p0.log")) as f:
        log0 = f.read()
    if "backend gloo, rank 0 on cuda:0 (the host's one card" not in log0:
        fail(f"{where}: rank 0 did not report the shared card under gloo:\n{log0[-2000:]}")
    tallies = multihost_tallies(root, 2)
    launches = [t["launches"] for t in tallies]
    if not all(n > 0 for n in launches) or any(t["masked_launches"] for t in tallies):
        fail(f"{where}: the ranks' evals launched B1 {launches}, B2 {[t['masked_launches'] for t in tallies]}")
    print(f"{where} on {card}: python -m sat_tpu_torch.tools.multihost_demo {' '.join(args)} exited 0 in "
          f"{wall:.1f}s: {banner[0]}", flush=True)
    print(f"{where} fleet on {card}: straggler p0 at {verdict['skew']}x the median (factor "
          f"{verdict['factor']}); own step p50/p95 rank 0 {hosts[0]['step_p50_ms']}/{hosts[0]['step_p95_ms']} ms "
          f"(stalled {MULTIHOST_SLOW_MS} ms or {FLEET_SLOW_SCALE:g} of its own median steps, the longer), "
          f"rank 1 {hosts[1]['step_p50_ms']}/{hosts[1]['step_p95_ms']} "
          f"ms; dispatch mean {hosts[0]['dispatch_ms']}/{hosts[1]['dispatch_ms']} ms; train "
          f"{[round(t['train_s'], 2) for t in tallies]} s, eval {[round(t['eval_s'], 2) for t in tallies]} s; "
          f"B1 launches in the ranks' evals {launches}", flush=True)
    return sum(launches)


# the five layouts of the JAX package's multihost test, at full width, then
# the 2x2 context-parallel one with dropout off and in float32: its masks on
# the sharded grid fold the rank in (as the JAX package's do), so only with
# dropout off does it draw the one-process control's masks
MULTIHOST_LAYOUTS = (("dp", []), ("cp", ["--cp"]), ("tp", ["--tp"]),
                     ("dp_x_cp_4proc", ["--mesh", "2,2", "--cp", "--check-loss-parity"]),
                     ("dp_x_tp_4proc", ["--mesh", "2,2", "--tp", "--check-loss-parity"]),
                     ("dp_x_cp_4proc_dropout_off", ["--mesh", "2,2", "--cp", "--check-loss-parity",
                                                    "--extra-set", "fc_drop_rate=0.0",
                                                    "--extra-set", "lstm_drop_rate=0.0"]),
                     ("dp_x_cp_4proc_float32", ["--mesh", "2,2", "--cp", "--check-loss-parity",
                                                "--extra-set", "compute_dtype=float32"]))


def multihost_layouts(out_dir: str, card: str) -> int:
    """``python3 chip_smoke.py --layouts OUT``: the demo in each of the five
    layouts at flagship widths (bf16) on the card, each run's banner,
    loss parity, seconds and the ranks' B1 launches into
    ``OUT/result.json`` and ``OUT/summary.md``."""
    import torch

    os.makedirs(out_dir, exist_ok=True)
    sets = [x for w in MULTIHOST_SETS for x in ("--extra-set", w)]
    rows, ok = [], True
    with tempfile.TemporaryDirectory(prefix="chip_smoke_layouts_") as tmp:
        for name, extra in MULTIHOST_LAYOUTS:
            root = os.path.join(tmp, name)
            # the layout's own --extra-set after the flagship's, so it wins
            rc, out, err, wall = run_multihost(root, ["--join-timeout", "500", *sets, *extra], timeout=700)
            procs = 4 if "--mesh" in extra else 2
            lines = out.splitlines()
            logs = []
            for r in range(procs):
                with open(os.path.join(root, f"worker_p{r}.log")) as f:
                    logs.append(f.read())
            row = {"layout": name, "args": extra, "rc": rc, "seconds": round(wall, 1),
                   "banner": next((x for x in lines if x.startswith("MULTIHOST OK")), None),
                   "loss_parity": next((x for x in lines if x.startswith(("loss parity", "FAIL"))), None),
                   "tp_verified_ranks": sum("TP verified" in log for log in logs)}
            if rc == 0:
                row["b1_launches"] = [t["launches"] for t in multihost_tallies(root, procs)]
                with open(os.path.join(root, "scores_p0.json")) as f:
                    row["scores"] = json.load(f)
            else:
                ok = False
                row["tail"] = (out[-2000:] + err[-1500:])
            print(f"multihost layout {name} on {card}: {json.dumps(row)}", flush=True)
            rows.append(row)
    result = {"device": torch.cuda.get_device_name(0), "card": card, "extra_set": list(MULTIHOST_SETS),
              "layouts": rows}
    with open(os.path.join(out_dir, "result.json"), "w") as f:
        json.dump(result, f, indent=1)
    md = [f"# multihost_demo, five layouts at full width on {card}", "",
          "`python3 chip_smoke.py --layouts OUT`: `python -m sat_tpu_torch.tools.multihost_demo` with "
          f"`--extra-set {' '.join(MULTIHOST_SETS)}` (the ranks share cuda:0 under gloo).", "",
          "| layout | args | rc | seconds | banner | loss parity | ranks with TP verified | B1 launches (ranks' evals) |",
          "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        md.append(f"| {r['layout']} | `{' '.join(r['args'])}` | {r['rc']} | {r['seconds']} | {r['banner']} | "
                  f"{r['loss_parity'] or '-'} | {r['tp_verified_ranks']} | {r.get('b1_launches')} |")
    with open(os.path.join(out_dir, "summary.md"), "w") as f:
        f.write("\n".join(md) + "\n")
    return 0 if ok else 1


def profile_trace_default(out_dir: str, card: str) -> int:
    """``python3 chip_smoke.py --profile-trace OUT``: the profile tool's
    default mode on the card (``python -m sat_tpu_torch.tools.profile_trace
    OUT``: the quality corpus, 25 flagship train steps at batch 32, the
    window over steps 8-12), then the capture summarized: its events, the
    train step's backward events, the kernel events and the busiest
    kernels, and that B1 never ran in a train step."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "sat_tpu_torch.tools.profile_trace", out_dir],
                          cwd=here, capture_output=True, text=True, timeout=1000)
    wall = time.perf_counter() - t0
    print(f"profile_trace on {card}: exit {proc.returncode} in {wall:.1f}s: {proc.stdout.strip()}", flush=True)
    traces = sorted(glob.glob(os.path.join(out_dir, "profile_run_trace", "*", "trace.json")))
    if proc.returncode != 0 or len(traces) != 1 or not os.path.exists(os.path.join(out_dir, "profile_done.txt")):
        with open(os.path.join(out_dir, "profile_train.log")) as f:
            print(f.read()[-3000:], flush=True)
        return 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = trace_kernels(traces[0])
    backward = sum(1 for e in events if str(e.get("name", "")).startswith("autograd::engine::evaluate_function"))
    by_name = {}
    for e in kernels:
        by_name[e["name"][:80]] = by_name.get(e["name"][:80], 0.0) + e.get("dur", 0) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    ours = [e for e in kernels if "fused_attend_kernel<" in e["name"]]
    span_ms = (max(e["ts"] + e.get("dur", 0) for e in kernels) - min(e["ts"] for e in kernels)) / 1e3
    print(f"profile_trace capture on {card}: {len(events)} events, {backward} backward (train step) events, "
          f"{len(kernels)} kernel events busy {sum(by_name.values()):.1f} ms over {span_ms:.1f} ms of kernels, "
          f"fused_attend {len(ours)}; busiest kernels (ms) {[(n, round(ms, 2)) for n, ms in top]}", flush=True)
    return 0 if backward > 0 and kernels and not ours else 1


# -- the measurement vehicles (tools/bench_*.py, tools/check_regression.py) ---

BENCH_FLAGSHIP = tuple(x for w in FLAGSHIP_SETS for x in ("--extra-set", w))


def jax_script_pairs(script: str, **fields) -> list:
    """The (metric, unit) pairs ``scripts/<script>`` prints, in source
    order, read from its text (nothing of the JAX package is imported):
    the names the port's vehicle must print."""
    import re

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", script)) as f:
        src = f.read()
    found = re.findall(r'"metric": f?"([^"]+)",(?:(?!"metric").)*?"unit": f?"([^"]+)"', src, re.DOTALL)

    def fill(text):
        return re.sub(r"\{args\.(\w+)\}", lambda m: str(fields[m.group(1)]), text)

    return [(fill(m), fill(u)) for m, u in found]


def vehicle_rows(text: str) -> list:
    """A vehicle's JSON rows: one object a line, or one indented array."""
    text = text.strip()
    if text.startswith("["):
        try:
            return json.loads(text)
        except ValueError:  # check_regression's "[function] ..." lines
            pass
    rows = []
    for line in text.splitlines():
        if line.startswith("{"):
            rows.append(json.loads(line))
    return rows


def run_vehicle(torch, fa, name: str, argv, env=None):
    """``sat_tpu_torch.tools.<name>.main(argv)`` in this process, its
    stdout captured, B1 and B2 counts set to 0 just before and read just
    after, the telemetry registry disabled and the card's cache emptied
    after.  Returns (rc, rows, B1, B2, seconds, stdout)."""
    import gc
    import importlib

    from sat_tpu_torch import telemetry

    module = importlib.import_module(f"sat_tpu_torch.tools.{name}")
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    out = io.StringIO()
    fa.fused_attend.launches = fa.fused_attend.masked_launches = 0
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            try:
                rc = module.main(list(argv))
            except SystemExit as e:
                rc = e.code if isinstance(e.code, int) else 1
                print(f"SystemExit: {e.code}", file=sys.stderr)
    finally:
        seconds = time.perf_counter() - t0
        b1, b2 = fa.fused_attend.launches, fa.fused_attend.masked_launches
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        telemetry.disable()
        gc.collect()
        torch.cuda.empty_cache()
    text = out.getvalue()
    return rc, vehicle_rows(text), b1, b2, seconds, text


# vehicles whose exit 1 is a measured gate (the JAX scripts' bars), not a
# failure of the run: the row is printed either way.  Each of these exits
# 1 on its overhead bar alone; bench_quality is not among them (below)
BENCH_GATED = {"bench_diag", "bench_telemetry", "bench_obs", "bench_fleet", "bench_watchdog", "bench_integrity",
               "bench_ckpt"}


def bar_alone(name: str, rows, argv) -> bool:
    """Whether a vehicle's exit 1 is its overhead bar and nothing else.
    bench_quality also exits 1 on a failed request, a steady-state kernel
    build, a reference left unfrozen or no live quality block: its exit 1
    passes only where its row shows none of those."""
    if name in BENCH_GATED:
        return bool(rows)
    if name != "bench_quality" or len(rows) != 1:
        return False
    r = rows[0]
    requests = int(argv[argv.index("--requests") + 1]) if "--requests" in argv else 80
    return (r.get("requests_ok") == requests and r.get("steady_state_compiles") == 0
            and r.get("reference_frozen") is True and (r.get("quality_requests") or 0) > 0)


# the vehicles whose kernels run in their children, and how their rows
# carry the children's (B1, B2) launches
BENCH_IN_CHILDREN = {
    "bench_serve --fleet": lambda rows: tuple(sum(v[i] for v in rows[0]["replica_launches"].values())
                                              for i in (0, 1)),
    "bench_bulk": lambda rows: (rows[0]["fused_attend_launches"], rows[0]["fused_attend_masked_launches"]),
    "bench_eval_ab": lambda rows: (rows[0]["fused_attend_launches"], 0),
    "bench_early_exit": lambda rows: (sum(r["fused_attend_launches"] for r in rows), 0),
}


def check_vehicle(where: str, name: str, argv, rc: int, rows, pairs, kind: str, text: str) -> None:
    """rc 0 (or an overhead bar's 1, :func:`bar_alone`), the JAX script's
    metrics and units in its order, every value finite, ``device_kind``
    the card (or "host-only"), stamped with the port's schema."""
    import math

    from sat_tpu_torch.telemetry import SCHEMA_VERSION

    if rc != 0 and not (rc == 1 and bar_alone(name, rows, argv)):
        fail(f"{where}: exit {rc}:\n{text[-3000:]}")
    got = [(r.get("metric"), r.get("unit")) for r in rows]
    if got != list(pairs):
        fail(f"{where}: rows {got}, the JAX script's at these flags {list(pairs)}")
    for r in rows:
        v = r["value"]
        if not isinstance(v, (int, float)) or isinstance(v, bool) or not math.isfinite(v):
            fail(f"{where}: {r['metric']} = {v!r}, not a finite number")
        if r.get("device_kind") != kind or r.get("schema_version") != SCHEMA_VERSION:
            fail(f"{where}: {r['metric']} device_kind {r.get('device_kind')!r} (want {kind!r}), schema "
                 f"{r.get('schema_version')}")


def bench_plan(tmp: str, full: bool):
    """The vehicles in order: (label, tool, argv, env, the JAX script's
    (metric, unit) pairs at these flags, host-only, B1 expected, B2
    expected) — True for a kernel the vehicle must launch, False for one
    it must not, None where it may (a continuous-mode server warms its
    batch buckets too).  ``full``: each vehicle at its default sizes (the
    serving and bulk vehicles' models are flagship by default)."""
    def sizes(short, default=()):
        return list(default) if full else list(short)

    serve = jax_script_pairs("bench_serve.py", quant_ab="int8")
    units = dict(serve)

    def serve_rows(*metrics):
        return [(m, units[m]) for m in metrics]

    eval_unit = "images/sec @ beam=3"
    plan = [
        ("bench_eval", "bench_eval", sizes(["--batch", "8", "--iters", "3", "--encoder-quant", "int8"],
                                           ["--encoder-quant", "int8"]), None,
         [("eval_images_per_sec", eval_unit), ("eval_images_per_sec_int8", eval_unit)], False, True, False),
        ("bench_attend", "bench_attend", sizes(["--iters", "50"]), None, [], False, True, True),
        ("bench_serve", "bench_serve", [*BENCH_FLAGSHIP, *sizes(
            ["--concurrency", "4", "--requests", "4", "--open-requests", "16", "--rate", "20", "--cont-rate", "10",
             "--quant-ab", "int8"], ["--quant-ab", "int8"])], None,
         serve_rows("serve_closed_loop_throughput", "serve_open_loop_p99_latency_ms", "serve_encode_ms",
                    "serve_continuous_goodput", "serve_admission_latency_ms", "serve_single_stream_latency_ms",
                    "serve_encode_ms_int8", "serve_closed_loop_throughput_int8"), False, True, True),
        ("bench_serve --tenants", "bench_serve", [*BENCH_FLAGSHIP, "--tenants", *sizes(
            ["--tenant-requests", "8", "--tenant-rate", "8", "--tenant-flood-rate", "30", "--tenant-concurrency",
             "6", "--tenant-share-seconds", "2"])], None,
         serve_rows("tenant_isolation_p99_ratio", "tenant_fair_share_error"), False, None, True),
        ("bench_serve --metering", "bench_serve", [*BENCH_FLAGSHIP, "--metering", *sizes(
            ["--metering-requests", "8", "--metering-rate", "8"])], None,
         serve_rows("metering_overhead_pct", "encode_cache_would_hit_ratio"), False, None, True),
        ("bench_serve --encode-cache", "bench_serve", [*BENCH_FLAGSHIP, "--encode-cache", *sizes(
            ["--cache-requests", "40", "--cache-rate", "20"])], None,
         serve_rows("encode_cache_hit_ratio", "cache_serve_goodput_rps"), False, None, True),
        ("bench_serve --lifecycle", "bench_serve", [*BENCH_FLAGSHIP, "--lifecycle", *sizes(
            ["--lifecycle-requests", "8", "--lifecycle-rate", "8"])], None,
         serve_rows("swap_blackout_ms", "canary_overhead_pct"), False, None, True),
        ("bench_serve --fleet", "bench_serve", [*BENCH_FLAGSHIP, "--fleet", *sizes(
            ["--fleet-sizes", "1,2", "--fleet-requests", "6", "--fleet-rate", "10",
             "--fleet-service-floor-ms", "300"])], None,
         serve_rows("fleet_goodput_rps", "fleet_open_loop_p99_latency_ms", "fleet_disagg_goodput_rps",
                    "fleet_router_overhead_ms"), False, True, False),
        ("bench_bulk", "bench_bulk", [*BENCH_FLAGSHIP, "--workdir", os.path.join(tmp, "bench_bulk")], None,
         jax_script_pairs("bench_bulk.py"), False, False, True),
        ("bench_eval_ab", "bench_eval_ab", sizes(
            ["--repeats", "1", "--batch", "8", "--iters", "3", "--windows", "2", "--steps", "3"]), None,
         jax_script_pairs("bench_eval_ab.py", beam=3), False, True, False),
        ("bench_early_exit", "bench_early_exit", [os.path.join(tmp, "bench_early_exit")],
         {} if full else {"EE_STEPS": "30", "EE_BATCH": "8"},
         [("eval_images_per_sec", eval_unit)] * 2, False, True, False),
        ("bench_diag", "bench_diag", [*BENCH_FLAGSHIP, *sizes(["--batch", "8", "--iters", "5", "--rounds", "2"])],
         None, jax_script_pairs("bench_diag.py"), False, False, False),
        ("bench_quality", "bench_quality", [*BENCH_FLAGSHIP, *sizes(
            ["--requests", "40", "--microbench", "1000", "--quality-window", "16"])], None,
         jax_script_pairs("bench_quality.py"), False, True, False),
    ]
    host = {
        "bench_input": (["--batch", "16", "--images", "32", "--sync-batches", "3", "--epochs", "1"],
                        [("input_feed_speedup", "x")] * 2),
        "bench_telemetry": (["--iters", "20000"], jax_script_pairs("bench_telemetry.py")),
        "bench_obs": (["--iters", "1000"], jax_script_pairs("bench_obs.py")),
        "bench_fleet": (["--iters", "100"], jax_script_pairs("bench_fleet.py")),
        "bench_watchdog": (["--iters", "50000"], jax_script_pairs("bench_watchdog.py")),
        "bench_integrity": (["--iters", "512"], jax_script_pairs("bench_integrity.py")),
        "bench_ckpt": (["--mb", "16", "--iters", "5000"], jax_script_pairs("bench_ckpt.py")),
    }
    for name, (short, pairs) in host.items():
        plan.append((name, name, sizes(short) + ["--workdir", os.path.join(tmp, name)], None, pairs, True,
                     False, False))
    return plan


def check_bench_item(item, result, card: str, note: str = ""):
    """One vehicle's result held to its plan ``item``: its rows (or, for
    bench_attend, its sweep line) and the kernels it should have
    launched; prints each row with the card and ``note``.  Returns (B1,
    B2, its metric rows, its summary entries)."""
    import math

    label, name, argv, _, pairs, host_only, want_b1, want_b2 = item
    rc, rows, b1, b2, seconds, text = result
    where = f"bench_tools {label}"
    if name == "bench_attend":
        if rc != 0 or not rows or "sweep" not in rows[-1] or "verdict:" not in text:
            fail(f"{where}: exit {rc}:\n{text[-3000:]}")
        line = rows[-1]
        if line.get("device_kind") != card or not math.isfinite(line["min_speedup"]) or \
                [r["live"] for r in line["masked"]] != [48, 24, 3]:
            fail(f"{where}: {json.dumps(line)[:2000]}")
        for r in line["sweep"] + line["masked"]:
            print(f"{where} on {card}: B={r['batch']}{' live ' + str(r['live']) if 'live' in r else ''} "
                  f"kernel {r['kernel_us']} us, plain {r['plain_us']} us ({r['speedup']}x), bound "
                  f"{r['bound_us']} us by {r['bound_by']} ({r['bound_share']:.1%} of it)", flush=True)
        verdict = [ln for ln in text.splitlines() if ln.startswith("verdict:")][0]
        print(f"{where} on {card}: min speedup {line['min_speedup']}x; {verdict}", flush=True)
    else:
        check_vehicle(where, name, argv, rc, rows, pairs, "host-only" if host_only else card, text)
    if label in BENCH_IN_CHILDREN:
        # launched in the vehicle's children: their counts ride its rows
        b1, b2 = BENCH_IN_CHILDREN[label](rows)
    if (want_b1 is not None and bool(b1) != want_b1) or (want_b2 is not None and bool(b2) != want_b2):
        fail(f"{where}: B1 launched {b1} times, B2 {b2} (expected B1 {'>0' if want_b1 else '0'}, "
             f"B2 {'>0' if want_b2 else '0'})")
    metric_rows = [r for r in rows if "metric" in r]
    summary = []
    for r in metric_rows:
        summary.append({"vehicle": label, "metric": r["metric"], "value": r["value"], "unit": r["unit"],
                        "device_kind": r["device_kind"], "seconds": round(seconds, 1)})
        print(f"{where} on {card}: {r['metric']} = {r['value']} {r['unit']} (exit {rc}, {seconds:.1f}s{note}; "
              f"B1 {b1}, B2 {b2})", flush=True)
    if not rows or name == "bench_attend":
        summary.append({"vehicle": label, "line": rows[-1] if rows else None, "seconds": round(seconds, 1)})
    return b1, b2, metric_rows, summary


def bench_children_start(tmp: str, full: bool = False, only: str = ""):
    """Start the vehicles whose JAX scripts start children of their own
    (the fleet, bulk, the eval A/B and the early-exit run; ``only``: that
    one), each as ``python -m sat_tpu_torch.tools.<name>``, side by side,
    at the JAX scripts' small flags (``full``: the default sizes);
    returns what :func:`bench_children_finish` reads."""
    started = []
    for item in bench_plan(tmp, full):
        label, name, argv, env = item[:4]
        if label in BENCH_IN_CHILDREN and only in ("", label):
            started.append((item, start_child(os.path.join(tmp, "bench_" + label.replace(" ", "_").replace("-", "")),
                                              ["-m", f"sat_tpu_torch.tools.{name}", *argv], env)))
    return started


def bench_children_finish(started, card: str, note: str = ", beside other work: a smoke time"):
    """Wait for :func:`bench_children_start`'s vehicles, each held as in
    :func:`bench_tools_phase` with its launches read from its rows (its
    kernels ran in its children).  Returns (B1, B2, the rows, the
    summary entries)."""
    b1_total = b2_total = 0
    rows, summary = [], []
    for item, child in started:
        rc, out, err, seconds = finish_child(child, f"bench_tools {item[0]}")
        result = (rc, vehicle_rows(out), 0, 0, seconds, out + "\n--- stderr ---\n" + err[-3000:])
        b1, b2, got, entries = check_bench_item(item, result, card, note)
        b1_total, b2_total, rows, summary = b1_total + b1, b2_total + b2, rows + got, summary + entries
    return b1_total, b2_total, rows, summary


def bench_tools_phase(torch, fa, tmp: str, card: str, children, full: bool = False, out_dir: str = ""):
    """Every other ported measurement vehicle, through its ``main`` in
    this process, one at a time and beside nothing, at the JAX scripts'
    small flags and flagship widths where it loads a model (``full``: the
    default sizes).  Each row: the JAX script's metric names and units at
    these flags, a finite value, ``device_kind`` the card (or
    "host-only"); B1 and B2 counted around each, and each vehicle that
    should launch a kernel launched it.  Then ``check_regression`` three
    times over these rows and ``children``' (:func:`bench_children_finish`'s
    return): the rows against themselves (0), with one throughput halved
    (2, naming it), and in compile-report mode over the eval sweep's
    ``compile_report-decode.json`` (0).  Returns (B1, B2) launched by
    every vehicle."""
    b1_total, b2_total, all_rows, summary = children
    for item in bench_plan(tmp, full):
        label, name, argv, env = item[:4]
        if label in BENCH_IN_CHILDREN:
            continue
        b1, b2, got, entries = check_bench_item(item, run_vehicle(torch, fa, name, argv, env), card)
        b1_total, b2_total, all_rows, summary = b1_total + b1, b2_total + b2, all_rows + got, summary + entries

    # the regression gate over the phase's own rows, then one halved: one
    # row a metric (the gate holds a row to the best prior of its name, and
    # eval_images_per_sec comes from three vehicles, bench_input's twice)
    gate_dir = os.path.join(tmp, "bench_gate")
    os.makedirs(gate_dir, exist_ok=True)
    rows_path = os.path.join(gate_dir, "rows.jsonl")
    firsts = {}
    for r in all_rows:
        firsts.setdefault(r["metric"], r)
    gate_rows = list(firsts.values())
    with open(rows_path, "w") as f:
        f.write("\n".join(json.dumps(r) for r in gate_rows) + "\n")
    rc, _, _, _, _, text = run_vehicle(torch, fa, "check_regression", [rows_path, rows_path])
    if rc != 0 or "no regressions" not in text:
        fail(f"bench_tools check_regression over its own rows: exit {rc}:\n{text[-3000:]}")
    halved = [dict(r) for r in gate_rows]
    target = next(r for r in halved if r["metric"] == "serve_closed_loop_throughput")
    target["value"] = target["value"] / 2
    cut_path = os.path.join(gate_dir, "halved.jsonl")
    with open(cut_path, "w") as f:
        f.write("\n".join(json.dumps(r) for r in halved) + "\n")
    rc2, _, _, _, _, text2 = run_vehicle(torch, fa, "check_regression", ["--baseline", rows_path,
                                                                        "--current", cut_path])
    named = [ln for ln in text2.splitlines() if ln.endswith("REGRESSION")]
    if rc2 != 2 or len(named) != 1 or not named[0].startswith("serve_closed_loop_throughput"):
        fail(f"bench_tools check_regression with serve_closed_loop_throughput halved: exit {rc2}, named "
             f"{named}:\n{text2[-3000:]}")
    report = os.path.join(tmp, "eval", "tel", "compile_report-decode.json")
    rc3, _, _, _, _, text3 = run_vehicle(torch, fa, "check_regression", ["--compile-baseline", report,
                                                                        "--compile-current", report])
    gated = [ln for ln in text3.splitlines() if ln.startswith("[decode/")]
    if rc3 != 0 or not any("flops" in ln for ln in gated):
        fail(f"bench_tools check_regression compile-report mode: exit {rc3}:\n{text3[-3000:]}")
    print(f"bench_tools check_regression on {card}: {len(gate_rows)} rows against themselves exit {rc}; "
          f"serve_closed_loop_throughput halved exit {rc2} naming it; compile-report mode over the eval "
          f"sweep's compile_report-decode.json exit {rc3} ({len(gated)} lines)", flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "bench_tools.json"), "w") as f:
            json.dump({"card": card, "full": full, "vehicles": summary, "rows": all_rows}, f, indent=1)
    return b1_total, b2_total


def memory_lead(torch, card: str) -> None:
    """What holds the card's memory at this point of the run: the
    allocator's statistics (``torch.cuda.memory_stats``) and the live
    CUDA tensors the garbage collector can see, largest shapes first."""
    import gc

    stats = torch.cuda.memory_stats()
    keys = ("allocated_bytes.all.current", "allocated_bytes.large_pool.current",
            "allocated_bytes.small_pool.current", "active_bytes.all.current", "reserved_bytes.all.current",
            "allocation.all.current", "segment.all.current", "inactive_split_bytes.all.current")
    print(f"memory_stats before train steady on {card}: " + ", ".join(f"{k} {stats.get(k, 0)}" for k in keys),
          flush=True)
    shapes, total, seen = {}, 0, set()
    for obj in gc.get_objects():
        try:
            if not (isinstance(obj, torch.Tensor) and obj.is_cuda):
                continue
            storage = obj.untyped_storage()
            key = (storage.data_ptr(), storage.nbytes())
        except Exception:
            continue
        if key in seen:
            continue
        seen.add(key)
        total += key[1]
        label = f"{tuple(obj.shape)} {str(obj.dtype).replace('torch.', '')}"
        n, b = shapes.get(label, (0, 0))
        shapes[label] = (n + 1, b + key[1])
    top = sorted(shapes.items(), key=lambda kv: -kv[1][1])[:8]
    print(f"live CUDA tensors the garbage collector sees before train steady: {len(seen)} storages, "
          f"{total / 2**30:.3f} GiB; largest: " + "; ".join(f"{label} x{n} {b / 2**20:.1f} MiB"
                                                              for label, (n, b) in top), flush=True)


def served(np, config) -> None:
    """The vocabulary and the step-1000 checkpoint that ``slice_phase``
    writes for ``config``, for a phase run without it (``--only``)."""
    if not os.path.exists(os.path.join(config.save_dir, "1000.npz")):
        os.makedirs(os.path.dirname(config.vocabulary_file), exist_ok=True)
        write_vocabulary(np, config.vocabulary_file, config.vocabulary_size)
        write_checkpoint(np, config, config.save_dir, step=1000, seed=SEED)


def phases(torch, np, fa, card: str):
    """The full run's phases in order: (name, the phases it needs before
    it, its function of the run's scratch directory, or for a phase made
    of child processes the pair (start, finish): ``start`` of the
    directory starts them and ``finish`` of what it returned waits and
    checks, see ``BESIDE``).  What a phase returns is kept under its
    name; later phases read the launches and the serve engine from
    there."""
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
        memory_lead(torch, card)
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

    def train_reference(tmp):
        train_reference_phase(torch, np, fa)
        train_metrics_check(np, tmp, card)

    def quality(tmp):
        got["quality"] = quality_phase(torch, np, tmp, card)
        return got["quality"]["launches"]

    def bench_children(started):
        got["bench children"] = bench_children_finish(started, card)
        return got["bench children"][:2]

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
        ("train reference", (), train_reference),
        ("train", ("eval steady",),
         lambda tmp: train_phase(np, train_config(os.path.join(tmp, "steady"), tmp), card)),
        ("train steady", ("train",), train_steady),
        ("resnet50 reference", (), lambda tmp: resnet50_reference_phase(torch, np, fa, tmp)),
        ("resnet50 serve and bulk", ("bulk",), r50_serve_and_bulk),
        ("resnet50 serve planes", (), r50_planes),
        ("resnet50 eval and train", ("eval", "train"), r50_eval_and_train),
        ("import", ("resnet50 eval and train",), lambda tmp: import_phase(np, got["r50_train"], card)),
        ("encoder_quant", (), encoder_quant),
        ("chaos", (), (chaos_start, lambda started: chaos_finish(np, started, card))),
        ("mesh train", (), lambda tmp: mesh_phase(np, tmp, card, got)),
        ("vocab parallel", ("mesh train",), lambda tmp: vocab_parallel_phase(np, tmp, card, got)),
        ("context parallel", ("mesh train",), lambda tmp: context_parallel_phase(np, tmp, card, got)),
        ("elastic", ("mesh train",), lambda tmp: elastic_phase(np, tmp, card, got)),
        ("multihost", (), lambda tmp: multihost_phase(tmp, card)),
        ("vocab5000", (), (vocab5000_start, lambda started: vocab5000_finish(np, started, card))),
        ("bench children", (), (bench_children_start, bench_children)),
        ("quality", (), quality),
        ("replay", ("quality",), lambda tmp: replay_phase(torch, np, got["quality"], card)),
        ("bench tools", ("eval", "bench children"),
         lambda tmp: bench_tools_phase(torch, fa, tmp, card, got["bench children"])),
    ]


# phases made only of child processes, run beside the phases that follow
# them, up to and including the one named here, when both run: their
# processes wait mostly on process starts, gloo and their own deadlines.
# The phases beside them check results, not times, and their phase lines
# say what ran beside them (their printed times read a shared card and
# shared cores); the timing-sensitive multihost phase and the in-process
# vehicles run beside nothing
BESIDE = {"chaos": "elastic", "vocab5000": "replay", "bench children": "replay"}


def run_plan(plan, chosen, tmp: str, only: bool) -> dict:
    """Run the phases of ``plan`` (:func:`phases`) whose names are in
    ``chosen``, in order, a ``BESIDE`` phase beside those that follow it
    when the phase it joins is chosen too; returns what each phase
    returned, by name.  ``only``: print each phase's launches."""
    got, beside = {}, {}
    for name, _, run in plan:
        if name.replace(" ", "_") not in chosen:
            continue
        t0 = time.perf_counter()
        if isinstance(run, tuple):
            start, finish = run
            if BESIDE[name].replace(" ", "_") in chosen:
                beside[name] = (finish, start(tmp), t0)
                print(f"{name} started: its children run beside the phases up to {BESIDE[name]}", flush=True)
                continue
            got[name] = finish(start(tmp))
            phase(name, t0)
            continue
        running = sorted(beside)
        got[name] = run(tmp)
        joined = sorted(other for other in beside if BESIDE[other] == name)
        for other in joined:
            finish, started, t_other = beside.pop(other)
            got[other] = finish(started)
            print(f"{other} (beside the phases since its start) ran {time.perf_counter() - t_other:.1f}s",
                  flush=True)
        # the wait for the phases it joins counts as this phase's time
        phase(f"{name} (beside {', '.join(running)}{'; with the wait for it' if joined else ''})"
              if running else name, t0)
        value = got[name]
        if only and (isinstance(value, int) or isinstance(value, tuple) and all(isinstance(v, int) for v in value)):
            print(f"{name} launches {value}", flush=True)
    return got


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bench", action="store_true", help="build and kernel bench only")
    ap.add_argument("--only", default="", help="comma-separated phases to run (with what they need)")
    ap.add_argument("--layouts", default="", metavar="OUT",
                    help="run multihost_demo in its five layouts at full width, summary into OUT")
    ap.add_argument("--profile-trace", default="", metavar="OUT",
                    help="run profile_trace's default mode into OUT and summarize its capture")
    ap.add_argument("--bench-tools", default="", metavar="OUT",
                    help="run the eval phase, then every measurement vehicle at its default sizes; "
                    "rows into OUT/bench_tools.json")
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
    if args.layouts:
        return multihost_layouts(os.path.abspath(args.layouts), card)
    if args.profile_trace:
        return profile_trace_default(os.path.abspath(args.profile_trace), card)
    if args.bench_tools:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            t0 = time.perf_counter()
            eval_phase(np, eval_config(tmp), card)
            phase("eval", t0)
            t0 = time.perf_counter()
            children = (0, 0, [], [])
            for label in BENCH_IN_CHILDREN:  # one at a time
                part = bench_children_finish(bench_children_start(tmp, full=True, only=label), card, note="")
                children = tuple(a + b for a, b in zip(children, part))
            launches = bench_tools_phase(torch, fa, tmp, card, children, full=True,
                                         out_dir=os.path.abspath(args.bench_tools))
            phase("bench tools (default sizes)", t0)
        print(f"bench tools launches (B1, B2) {launches}", flush=True)
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
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        got = run_plan(plan, chosen, tmp, bool(args.only))
    if args.only:
        return 0
    rows, (masked_rows, masked_err) = got["kernel"], got["masked"]
    launches, masked_launches, (ops_launches, ops_masked) = got["slice"], got["continuous"], got["serve ops"]
    eval_launches, test_launches, bulk_launches = got["eval"], got["test"], got["bulk"]
    planes_b1, planes_b2 = got["serve planes"]
    route_b1 = got["route batch"][0] + got["route continuous"][0]
    route_b2 = got["route batch"][1] + got["route continuous"][1]
    eval_loss_launches = got["train steady"]
    r50_launches, r50_masked, r50_bulk = got["resnet50 serve and bulk"]
    r50_planes, r50_eval, import_launches = (got["resnet50 serve planes"], got["resnet50 eval and train"],
                                             got["import"])
    mesh_ranks_b1 = got["mesh train"][0] + got["vocab parallel"]
    mesh_b1 = mesh_ranks_b1 + got["mesh train"][1]
    quality_b1, (replay_b1, replay_b2) = got["quality"], got["replay"]
    chaos_b2, v5000_b1, multihost_b1 = got["chaos"], got["vocab5000"], got["multihost"]
    bench_b1, bench_b2 = got["bench tools"]

    for B, N, what in ((60, 196, "eval: batch 20 x beam 3"), (20, 196, "eval-loss step: batch 20"),
                       (96, 49, "ResNet50 bucket 32 x beam 3"), (60, 49, "ResNet50 eval: batch 20 x beam 3")):
        row = next(r for r in rows if (r["B"], r["N"], r["dtype"]) == (B, N, "bfloat16"))
        print(f"kernel fused_attend bf16 B={B} N={N} D={row['D']} ({what}) on {card}: {row['ms'] * 1e3:.1f} us, "
              f"bound {row['bound_ms'] * 1e3:.1f} us ({row['bound_by']}, "
              f"{row['bound_ms'] / row['ms']:.1%} of it), plain {row['plain_ms'] * 1e3:.1f} us", flush=True)
    vgg_b1 = (launches + ops_launches + eval_launches + test_launches + eval_loss_launches
              + planes_b1 + route_b1 + mesh_b1 + quality_b1 + replay_b1 + v5000_b1 + multihost_b1 + bench_b1)
    r50_b1 = r50_launches + r50_eval + import_launches
    print(f"fused_attend launches on the main paths: VGG16 batch serve {launches}, serve ops "
          f"{ops_launches} (masked {ops_masked}), eval and sweep "
          f"{eval_launches}, test {test_launches}, eval-loss "
          f"step {eval_loss_launches}, serve planes {planes_b1}, route replicas {route_b1}, mesh evals in every "
          f"rank of the data- and vocab-parallel launches {mesh_ranks_b1}, their one-process reference "
          f"{mesh_b1 - mesh_ranks_b1}, quality evals {quality_b1}, replay serving and tool {replay_b1}, "
          f"vocab5000 evals (one process and eight ranks) {v5000_b1}, multihost_demo evals (two ranks) "
          f"{multihost_b1}, the measurement vehicles {bench_b1}; "
          f"ResNet50 batch "
          f"serve {r50_launches}, eval "
          f"{r50_eval}, test of the imported npy {import_launches}; train steps 0; masked: VGG16 continuous "
          f"serve {masked_launches}, bulk {bulk_launches}, serve planes {planes_b2}, route replicas "
          f"{route_b2}, replay serving and tool {replay_b2}, the chaos serve wedge {chaos_b2}, the measurement "
          f"vehicles {bench_b2}; ResNet50 continuous "
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
        "launches_mesh_ranks": mesh_ranks_b1,
        "launches_quality_and_replay": quality_b1 + replay_b1,
        "launches_vocab5000": v5000_b1,
        "launches_multihost": multihost_b1,
        "launches_bench_tools": bench_b1,
        "resnet50": {"shape": "B=96 N=49 da=512 D=2048 bfloat16", "ms": r50_row["ms"],
                     "plain_ms": r50_row["plain_ms"], "bound_ms": r50_row["bound_ms"],
                     "bound_by": r50_row["bound_by"]},
    }, {
        "name": "fused_attend_masked",
        "route": "cuda",
        "source": "sat_tpu_torch/csrc/fused_attend.cu",
        "replaces": "sat_tpu/ops/pallas_attention.py:95",
        "launches": (masked_launches + ops_masked + bulk_launches + planes_b2 + route_b2 + r50_masked + r50_bulk
                     + r50_planes + replay_b2 + chaos_b2 + bench_b2),
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
        "launches_replay": replay_b2,
        "launches_chaos": chaos_b2,
        "launches_bench_tools": bench_b2,
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
