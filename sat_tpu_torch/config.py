"""Configuration for sat_tpu_torch — the port's own copy of ``sat_tpu.config``.

The same fields, defaults, validation and JSON loading as the JAX
package's ``Config``, so one config file (or ``--set`` stack) drives both
packages.  The port keeps this copy instead of importing it: nothing in
``sat_tpu_torch`` imports ``sat_tpu``.  Knobs whose subsystem is not
ported yet are still accepted here; the entry points that cannot honour
them raise (see ``runtime.check_ported``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class Config:
    """Immutable and hashable (as in the JAX package, where it rides
    through jax.jit as a static argument); use .replace(...) to derive
    variants."""
    # ---- architecture (reference config.py:8-17) ----
    cnn: str = "vgg16"                 # 'vgg16' or 'resnet50'
    max_caption_length: int = 20
    dim_embedding: int = 512
    num_lstm_units: int = 512
    num_initialize_layers: int = 2     # 1 or 2
    dim_initialize_layer: int = 512
    num_attend_layers: int = 2         # 1 or 2
    dim_attend_layer: int = 512
    num_decode_layers: int = 2         # 1 or 2
    dim_decode_layer: int = 1024

    # ---- init / regularization (reference config.py:20-27) ----
    fc_kernel_initializer_scale: float = 0.08
    fc_kernel_regularizer_scale: float = 1e-4
    fc_activity_regularizer_scale: float = 0.0
    conv_kernel_regularizer_scale: float = 1e-4
    conv_activity_regularizer_scale: float = 0.0
    fc_drop_rate: float = 0.5
    lstm_drop_rate: float = 0.3
    attention_loss_factor: float = 0.01

    # ---- optimization (reference config.py:30-43) ----
    num_epochs: int = 30
    batch_size: int = 20
    optimizer: str = "Adam"            # 'Adam', 'RMSProp', 'Momentum', 'SGD'
    initial_learning_rate: float = 1e-4
    learning_rate_decay_factor: float = 1.0
    num_steps_per_decay: int = 100000
    clip_gradients: float = 5.0
    momentum: float = 0.0
    use_nesterov: bool = True
    decay: float = 0.9
    centered: bool = True
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-6

    # ---- phase / runtime ----
    phase: str = "train"               # 'train', 'eval' or 'test'
    train_cnn: bool = False
    beam_size: int = 3

    # ---- saver (reference config.py:53-55) ----
    save_period: int = 50
    save_dir: str = "./data/models/"
    summary_dir: str = "./summary/"
    # overlap checkpoint disk writes with training (single-process; the
    # multi-host path always saves synchronously) — the reference stalls
    # its loop for the whole save (base_model.py:61-62)
    async_checkpoint: bool = True

    # ---- resilience (docs/RESILIENCE.md; no reference equivalent) ----
    # Anomaly-sentinel policy at each log_every metrics fetch (the loop's
    # one host sync — the sentinel adds no device syncs of its own):
    # 'off' disarms; 'warn' reports and stops blessing LAST_GOOD while
    # unhealthy; 'skip' additionally suppresses checkpoint writes while
    # unhealthy; 'rollback' restores LAST_GOOD and fast-forwards the
    # loader past the poison step (bounded, then degrades to warn).
    anomaly_policy: str = "warn"
    # loss > spike_factor × EMA(loss) counts as an anomaly (0 disables
    # spike detection; NaN/Inf detection is always on when armed)
    anomaly_spike_factor: float = 0.0
    # checkpoint retention: keep the newest N plus the LAST_GOOD target
    # (0 = keep everything, the reference's behavior)
    keep_checkpoints: int = 0
    # transient-IO retry budget + first-retry backoff for durable reads/
    # writes (checkpoints, shard cache, manifests, caption files)
    io_retries: int = 3
    io_retry_base_s: float = 0.05
    # Progress watchdog (resilience/watchdog.py): observer-thread poll
    # cadence in seconds; 0 disables the watchdog entirely.  Each tracked
    # phase gets a deadline below (seconds; 0 disables that phase) that
    # is enforced only once the phase has completed at least once, so a
    # cold first-step compile never false-trips a steady-state deadline.
    # On a blown deadline the escalation ladder runs: watchdog/* gauges
    # -> all-thread stack dump + trace flush -> abort with exit code 86
    # after the async checkpoint writer lands LAST_GOOD.
    watchdog_interval: float = 0.0
    watchdog_step_s: float = 1800.0        # whole loop body (the net)
    watchdog_data_wait_s: float = 600.0    # host input pipeline
    watchdog_dispatch_s: float = 900.0     # device step dispatch
    watchdog_checkpoint_s: float = 900.0   # checkpoint enqueue/flush
    watchdog_grace_s: float = 2.0          # stack dump -> abort delay
    # Crash-only supervisor (--supervise): restart budget and first-
    # restart backoff (jittered exponential, resilience.retry's policy)
    supervise_max_restarts: int = 3
    supervise_backoff_s: float = 1.0
    # Data-plane integrity (data/integrity.py): verify gathered shard
    # rows against their per-row crc32c sidecars.  'off' trusts storage;
    # 'sample' scrubs one rotating row every few gathers (≪1% of a
    # step — scripts/bench_integrity.py gates it); 'open' fully verifies
    # each shard on first touch; 'full' verifies every row every batch.
    verify_shards: str = "off"
    # Quarantine ledger path ("" = <summary_dir>/quarantine.jsonl) and
    # the systemic-corruption ceiling: when more than this fraction of
    # rows seen has been quarantined (and at least 8 records are
    # involved), abort with exit code 87 instead of training on mostly
    # substituted data (resilience/quarantine.py).
    quarantine_ledger: str = ""
    quarantine_max_fraction: float = 0.5

    # ---- telemetry (docs/OBSERVABILITY.md; no reference equivalent) ----
    # Host-side span tracing + run-health heartbeat.  Off by default:
    # when off the telemetry layer is a null object and run behavior is
    # bit-for-bit what it was before instrumentation.
    telemetry: bool = False
    # artifact directory for heartbeat.json / telemetry.jsonl /
    # breakdown.json ("" = alongside summary_dir's metrics.jsonl)
    telemetry_dir: str = ""
    # seconds between heartbeat.json rewrites (0 disables the heartbeat
    # thread; spans/counters still record)
    heartbeat_interval: float = 10.0
    # Chrome trace-event JSON output path ("" = <telemetry_dir>/trace.json
    # when telemetry is on)
    trace_export: str = ""
    # span ring-buffer capacity (percentile window; totals are exact
    # regardless — see sat_tpu/telemetry/spans.py)
    telemetry_buffer: int = 65536
    # In-graph model-health taps (telemetry/device.py): scalar reductions
    # (grad/update/param norms, masked attention entropy, the paper's
    # alpha-coverage deviation, logit max) computed inside train_step and
    # fetched at the existing log_every sync — no additional device syncs.
    # "off" (default) leaves the compiled step bit-for-bit unchanged;
    # "basic" adds global scalars; "full" adds per-layer-group norms that
    # let the anomaly sentinel name which tensor went non-finite.
    diag_level: str = "off"
    # read-only Prometheus scrape endpoint for TRAINING runs (serving
    # exposes /metrics on its own port): GET /metrics + /healthz riding
    # the heartbeat payload (telemetry/promtext.py).  0 = off.
    metrics_port: int = 0
    # size cap per rotating telemetry JSONL (telemetry.jsonl /
    # access.jsonl / slo.jsonl — single .1 rollover, so at most 2x this
    # on disk per file).  0 = unbounded (the pre-rotation behavior).
    telemetry_log_cap_mb: float = 64.0
    # on-demand live profiler window length (POST /profile default and
    # the SIGUSR2 train trigger; telemetry/profwin.py clamps to its
    # hard cap)
    profile_window_ms: float = 2000.0
    # ---- SLO objectives (telemetry/slo.py; 0 target = disabled) ----
    # burning = both windows violate: the fast window pages quickly, the
    # slow window suppresses blips
    slo_window_fast_s: float = 60.0
    slo_window_slow_s: float = 300.0
    slo_serve_p99_ms: float = 0.0      # serve: p99 of serve/request
    slo_error_ratio: float = 0.0       # serve: 5xx / all requests
    slo_captions_per_s: float = 0.0    # train: step rate x batch_size floor
    slo_ckpt_age_s: float = 0.0        # train: newest-checkpoint age ceiling
    # serve: minimum capacity headroom % (telemetry/capacity.py) — burns
    # when the online capacity model's headroom gauge falls below this
    # floor, paging on approach to the replica's effective-captions/s
    # ceiling instead of after latency melts
    slo_capacity_headroom_pct: float = 0.0
    # ---- fleet plane + black box (telemetry/fleet.py, blackbox.py; ----
    # ---- docs/OBSERVABILITY.md "Fleet & Postmortem") ----
    # cross-host aggregation at the log boundary: per-process
    # heartbeat_p<i>.json sidecars merged by process 0 into fleet.json
    # with skew ratios and a straggler verdict (requires telemetry)
    fleet_telemetry: bool = False
    # shared directory the fleet's sidecars and fleet.json live in ("" =
    # this process's telemetry_dir; multi-host launchers point every
    # process at one directory on common storage)
    fleet_dir: str = ""
    # a host is named the straggler when its step-time p95 exceeds the
    # fleet median by this factor (must be >= 1)
    straggler_factor: float = 2.0
    # black-box flight recorder: bounded on-disk ring journaling recent
    # counters/gauges/events; abnormal exits (watchdog 86, corruption 87,
    # sentinel trips, uncaught exceptions) dump a postmortem_<run_id>/
    # bundle summarized by scripts/analyze_postmortem.py
    blackbox: bool = False

    # ---- online serving (docs/SERVING.md; no reference equivalent) ----
    # Request-driven captioning service (sat_tpu/serve): a stdlib HTTP
    # frontend feeding a dynamic micro-batcher that pads every dispatched
    # batch up to a fixed ladder of shape buckets, all AOT-compiled at
    # startup so steady state never recompiles.
    serve_host: str = "127.0.0.1"
    serve_port: int = 8700             # HTTP listen port (0 = ephemeral)
    # batch-shape ladder warmed at startup; a batch of n requests runs at
    # the smallest bucket >= n, so the device only ever sees these shapes
    serve_buckets: Tuple[int, ...] = (1, 4, 16, 32)
    # admission control: most requests per dispatched batch / how long the
    # batcher holds an underfull batch open waiting for more arrivals
    serve_max_batch: int = 32
    serve_max_wait_ms: float = 5.0
    # bounded request queue; submits beyond this shed with HTTP 429
    serve_queue_depth: int = 128
    # default per-request deadline (0 = none).  A request still queued
    # past its deadline fails fast with HTTP 504 instead of spending
    # device time on an answer nobody is waiting for; the X-Deadline-Ms
    # request header overrides per request.
    serve_deadline_ms: float = 0.0
    # in-flight batch watchdog (0 = unbounded, the pre-watchdog
    # behavior): a result drain stuck longer than this fails the batch's
    # requests with 500, counts serve/wedged_batches, flips /healthz to
    # 503 "degraded", and triggers an engine re-warm — a wedged device
    # dispatch degrades the service instead of hanging it forever
    serve_wedge_timeout_ms: float = 0.0
    # dispatch discipline: "batch" gathers whole padded batches through
    # the monolithic beam_search (the correctness oracle); "continuous"
    # admits requests into a fixed-capacity paged slot pool between
    # decode steps and retires finished beams early (docs/SERVING.md)
    serve_mode: str = "batch"
    # continuous-mode pool geometry: serve_slot_pages pages of
    # serve_page_width slots each (page_width caps the admission lane —
    # encode lanes at each power-of-two width up to it are AOT-warmed
    # once, and a burst of admissions encodes at the smallest lane that
    # fits before one init_slots gather seeds the free slots)
    serve_slot_pages: int = 4
    serve_page_width: int = 4
    # fused decode window (continuous mode): the ladder of K values the
    # adaptive policy may pick — a window runs up to K stepped decodes
    # under ONE dispatch (lax.while_loop, on-device early-exit when the
    # pool drains); the depth is a runtime operand, so one AOT-warmed
    # executable serves the whole ladder.  The batcher picks a depth per
    # tick from queue pressure: deepest K when the admission queue is
    # empty, K=1 under burst so admission latency is preserved.  Must
    # include 1 (the burst depth) and be strictly increasing.
    serve_decode_depth: Tuple[int, ...] = (1, 2, 4, 8)
    # multi-tenant plane (sat_tpu/serve/tenants.py; docs/SERVING.md
    # "Multi-tenant serving"): a JSON registry file path or an inline
    # "name[:weight[:rps[:burst]]],..." list (first entry = the default
    # tenant for bare requests).  Tenants get weighted deficit-round-
    # robin scheduling, token-bucket admission quotas, per-tenant SLO
    # burn lanes, and optional per-tenant resident models.  "" = the
    # single-tenant plane (bit-identical to pre-tenant serving).
    tenants: str = ""
    # per-request cost attribution + tenant metering + the online
    # capacity model (telemetry/metering.py, telemetry/capacity.py):
    # attributes encode/decode device time, slot occupancy and host
    # phases per request, rolls them up per tenant into metering.jsonl /
    # /stats / /metrics, and publishes capacity headroom gauges.  Only
    # active when telemetry is on (all attribution rides telemetry-gated
    # already-synced boundaries); off skips ledger and gauges entirely.
    serve_metering: bool = True
    # ---- content-addressed encode cache (sat_tpu/serve/encode_cache.py;
    # ---- docs/SERVING.md "Encode cache & tiered fleets") ----
    # "on" keeps a device-resident LRU of encoder feature grids keyed by
    # (image crc32c, param fingerprint, quant mode): a hit skips the
    # encode lane entirely and seeds the slot from the cached grid, a
    # miss encodes once and inserts (single-flight — N concurrent
    # requests for one image trigger exactly one encode).  The ring is
    # fixed-geometry HBM with AOT-warmed insert/gather executables, so
    # steady state never recompiles; "off" (default) never constructs
    # the cache and is bit-identical to pre-cache serving.
    encode_cache: str = "off"
    encode_cache_mb: int = 64          # HBM budget for the feature-grid ring
    # ---- encode/decode tier disaggregation (serve/router.py) ----
    # which serve functions this replica advertises to the fleet router:
    # "both" (default) serves images end to end; "encode" is the
    # stateless batch-friendly tier (POST /encode returns a feature-grid
    # handoff blob); "decode" is the latency-bound tier fed grids via
    # POST /caption with the sat-grid content type.  The tier is routing
    # metadata, not a capability restriction — every replica still
    # answers direct image captions, so a tiered fleet degrades to
    # untiered serving instead of 404ing when the router is bypassed.
    serve_tier: str = "both"
    # ---- caption-quality observability (telemetry/quality.py, ----
    # ---- telemetry/exemplar.py; docs/OBSERVABILITY.md "Quality") ----
    # "on" threads the harvested beam alphas through the existing detok
    # boundary (same drains, zero extra syncs), extracts per-request
    # quality signals host-side, streams them into fixed-bin drift
    # sketches (PSI vs a frozen reference) and tail-samples outlier
    # requests into the exemplar flight recorder.  "off" (default) keeps
    # the serve path bit-identical to the pre-quality plane, including
    # the warmed executables (return_alphas stays False).
    serve_quality: str = "off"
    # rotating window length per signal sketch; the frozen reference is
    # captured from the first window of traffic when no reference file
    # is given
    serve_quality_window: int = 256
    # quality_reference.json to load as the frozen drift reference ("" =
    # freeze from the first serve_quality_window requests at runtime);
    # export the live reference with GET /quality_reference
    serve_quality_reference: str = ""
    # exemplar flight-recorder directory ("" = <telemetry_dir>/exemplars)
    serve_quality_exemplar_dir: str = ""
    # recorder disk budget (segments + image payloads, MB); oldest
    # segments rotate out first
    serve_quality_exemplar_mb: float = 64.0
    # outlier triggers: a request whose beam margin (top1 - top2
    # log-prob) falls below margin_min, or whose unk/OOV token rate
    # exceeds unk_max, is captured (margin_min 0 / unk_max 1 = trigger
    # off; shed/timeout capture is always armed while the plane is on)
    serve_quality_margin_min: float = 0.0
    serve_quality_unk_max: float = 1.0
    # quality SLO lanes (gauge_ceiling; diagnostic like tenant lanes —
    # they burn without flipping /healthz): PSI drift-score ceiling over
    # quality/psi_max and windowed unk-rate ceiling over
    # quality/unk_rate.  0 = lane off.
    slo_quality_psi: float = 0.0
    slo_quality_unk: float = 0.0

    # ---- model lifecycle (sat_tpu/lifecycle; docs/SERVING.md) ----
    # zero-downtime model refresh: a reloader thread polls the lineage
    # LAST_GOOD pointer every model_reload seconds (jittered) and stages
    # any new checkpoint through load -> canary -> promote/rollback
    # without restarting the server.  0 = lifecycle plane off (the
    # load-once behavior).
    model_reload: float = 0.0
    # fraction of admitted requests routed to the candidate params during
    # the canary window (deterministic per X-Request-Id hash, so retries
    # of one request always land on the same slot)
    canary_fraction: float = 0.1
    # qualification window: how long a candidate serves canary traffic
    # before the controller decides promote (auto) or awaits the operator
    canary_window_s: float = 30.0
    # "auto" promotes when the window elapses without the canary SLO
    # burning; "manual" holds in CANARY until POST /promote (or /rollback)
    promote_policy: str = "auto"
    # fraction of incumbent requests shadow-duplicated onto the candidate
    # to feed the caption-divergence gauge (device cost, off the request
    # path — the client gets the incumbent answer either way)
    canary_shadow_rate: float = 0.1
    # divergence ceiling for lifecycle/caption_divergence (token Jaccard
    # distance EWMA vs the incumbent, 0..1); 0 disables the objective
    canary_divergence_max: float = 0.0

    # ---- fleet router (sat_tpu/serve/router.py; docs/SERVING.md) ----
    # `--phase route` runs a jax-free health-weighted router over N serve
    # replicas: spawned locally over a port range when route_replicas is
    # empty, or pre-started endpoints given as "host:port,host:port".
    route_port: int = 8800             # router HTTP listen port (0 = ephemeral)
    route_replicas: str = ""           # endpoint spec; "" = spawn locally
    route_num_replicas: int = 2        # local-spawn fleet size
    route_replica_base_port: int = 8710  # local replicas bind base..base+N-1
    # fleet-view poller cadence: /healthz every tick, the heavier /stats
    # merge every route_stats_every ticks
    route_poll_interval_s: float = 0.5
    route_stats_every: int = 4
    # the previous pick is kept while its effective load stays within
    # (1 + hysteresis) of the best — near-ties must not flap picks
    route_hysteresis: float = 0.25
    # degraded / straggler replicas multiply their routing weight by this
    # (down-weighted, never blackholed; both signals compound)
    route_down_weight: float = 0.25
    # proactive edge shed: when > 0 and every routable replica's queue is
    # already this deep, the router sheds with one coherent 429 instead
    # of forwarding work that would shed N different ways downstream
    route_shed_depth: int = 0
    route_upstream_timeout_s: float = 120.0  # per-attempt proxy timeout

    # ---- bulk offline captioning (sat_tpu/bulk; docs/BULK.md) ----
    # `--phase bulk` streams an arbitrary image corpus through the serve
    # engine's AOT-warmed continuous stepped decode and writes sharded
    # caption JSONL outputs with a crash-only resume manifest.
    bulk_input: str = ""               # corpus: directory tree or file list
    bulk_output: str = ""              # output dir (captions_*.jsonl + manifest)
    bulk_shard_rows: int = 256         # images per output shard (resume grain)

    # ---- dataset-size caps (reference config.py:60-63) ----
    max_train_ann_num: Optional[int] = 1000
    max_eval_ann_num: Optional[int] = 20

    # ---- vocabulary (reference config.py:66-67) ----
    vocabulary_file: str = "./data/vocabulary.csv"
    vocabulary_size: int = 5000

    # ---- training data paths (reference config.py:70-73) ----
    train_image_dir: str = "./data/train/images/"
    train_caption_file: str = "./data/train/captions_train2014.json"
    temp_annotation_file: str = "./data/train/anns.csv"
    temp_data_file: str = "./data/train/data.npy"

    # ---- evaluation paths (reference config.py:76-80) ----
    eval_image_dir: str = "./data/val/images/"
    eval_caption_file: str = "./data/val/captions_val2014.json"
    eval_result_dir: str = "./data/val/results/"
    eval_result_file: str = "./data/val/results.json"
    save_eval_result_as_image: bool = False
    # per-word attention-map panels next to each captioned image (the
    # paper's signature figure; the reference never exposes decode-time
    # attention).  Honored by eval/test on single-device runs.
    save_attention_maps: bool = False

    # ---- testing paths (reference config.py:83-85) ----
    test_image_dir: str = "./data/test/images/"
    test_result_dir: str = "./data/test/results/"
    test_result_file: str = "./data/test/results.csv"

    # ---- TPU-native knobs (no reference equivalent) ----
    image_size: int = 224              # square input edge; 224 = reference
    compute_dtype: str = "bfloat16"    # matmul/conv compute dtype
    param_dtype: str = "float32"       # master params stay fp32
    # Dropout-mask PRNG of the JAX package's training path (not ported
    # yet; kept so one config file drives both packages).
    rng_impl: str = "rbg"
    # Master seed for the whole run: param init, dropout key stream, and
    # the per-epoch shuffle order (DataSet._set_epoch is a pure function
    # of (seed, epoch), which is also what makes mid-epoch resume replay
    # bitwise).  Like every other knob, a resumed run must be launched
    # with the same value (rerun the same command line plus --load); the
    # checkpoint's config.json sidecar records what it was.  The
    # reference exposes no seed control at all.
    seed: int = 0
    # Rematerialize the decoder scan step in the backward pass (keep
    # matmul outputs, regenerate dropout masks/elementwise from the
    # per-step keys instead of stacking T steps of residuals).
    # Numerically identical; off by default pending a measured win.
    remat_decoder: bool = False
    # Full-encoder rematerialization under --train_cnn: backward
    # recomputes the CNN forward from the images instead of storing every
    # conv activation (jax.checkpoint).  Trades ~one extra encoder
    # forward for the activation footprint that otherwise caps joint-
    # training batch size.  Numerically identical; off by default.
    remat_cnn: bool = False
    # Cross-entropy/log-softmax dtype over the [B,T,vocab] logits.
    # "float32" (default) materializes the fp32 log-softmax exactly as the
    # reference's sparse_softmax_cross_entropy does; "bfloat16" keeps the
    # [B,T,V] intermediates in bf16 (halving their HBM traffic — at
    # B=128 the fp32 logp alone is ~51 MB/step) and accumulates the
    # softmax normalizer in fp32.  Off by default pending a measured win
    # (same policy as the remat knobs).
    ce_dtype: str = "float32"
    # Preprocessed shard cache (data.shards): serve batches as mmap
    # fancy-index gathers of post-resize uint8 tensors instead of running
    # the JPEG codec every step — bitwise-identical to live decode, and
    # the measured fix for the host-bound input pipeline (PERF.md "Host
    # input pipeline").  "auto" (default): use a valid existing cache,
    # else fall back to live decode; "on": build/extend the cache first
    # (one-time decode cost), then serve from it; "off": always live
    # decode.  Files missing from a cache fall back per image either way.
    shard_cache: str = "auto"
    shard_cache_dir: str = "./data/shards/"
    shard_rows: int = 1024             # rows per shard file (~154 MB @224px)
    mesh_shape: Tuple[int, ...] = (1, 1)   # (data, model) device mesh
    mesh_axes: Tuple[str, ...] = ("data", "model")
    context_parallel: int = 1          # shard the context grid over 'model'
    prefetch_depth: int = 2            # host→HBM async pipeline depth
    # Fused soft-attention kernel on the decode path.  In this port it
    # selects ops.fused_attend (the hand-written CUDA kernel on a CUDA
    # tensor, its plain version on a CPU tensor); False runs the unfused
    # torch ops of decoder.attend_with_precomputed.
    use_pallas_attention: bool = True
    # Post-training quantization of the FROZEN encoder on the serve path
    # (sat_tpu/nn/quant.py; docs/SERVING.md "Precision & parity").  "off"
    # (default) is bitwise the unquantized path.  "bf16" stores the conv
    # kernels in bfloat16 (halving their HBM residency; compute already
    # runs bf16 on the MXU).  "int8" converts conv kernels to per-output-
    # channel symmetric int8 with fp32 scales at load time, calibrates
    # per-layer activation ranges host-side over encoder_quant_calib_batches
    # batches (one-time, before AOT warmup), and runs the convs as
    # int8xint8->int32 MXU ops with fused dequant; the [B,N,D] context
    # output stays fp32.  Serving-only: the train path always runs the
    # fp32/bf16 flax encoder, and the caption-parity harness
    # (tests/test_quant.py) bounds the divergence vs fp32.
    encoder_quant: str = "off"
    encoder_quant_calib_batches: int = 4
    encoder_quant_calib_batch_size: int = 8
    # Feed uint8 RGB and run the final astype(float32)−ILSVRC-mean on
    # device (models.captioner.encode): bitwise-equal preprocessing
    # (the resize already happens on uint8 either way), 4× smaller
    # host→device transfers, one less float32 pass on the host decode
    # path.  Off = the reference's all-host preprocessing.
    device_preprocess: bool = True
    num_data_workers: int = 8          # image-decode thread pool
    log_every: int = 10                # metric-writer cadence (steps)
    var_summary_period: int = 0        # per-variable stats cadence (0=off)
    max_steps: int = 0                 # hard step cap across epochs (0=off)
    profile_dir: str = ""              # jax.profiler trace dir ("" = off)
    profile_start_step: int = 5        # first step inside the trace
    profile_num_steps: int = 3         # steps captured per trace
    global_step: int = 0               # persisted into checkpoints

    def __post_init__(self) -> None:
        """Fail fast on knob typos — a wrong ``cnn`` string would otherwise
        silently select a different model (the reference's if/else does the
        same, /root/reference/model.py:16-21)."""
        checks = (
            ("cnn", ("vgg16", "resnet50")),
            ("phase", ("train", "eval", "test", "serve", "route", "bulk")),
            ("optimizer", ("Adam", "RMSProp", "Momentum", "SGD")),
            ("num_initialize_layers", (1, 2)),
            ("num_attend_layers", (1, 2)),
            ("num_decode_layers", (1, 2)),
            ("rng_impl", ("threefry2x32", "rbg", "unsafe_rbg")),
            ("ce_dtype", ("float32", "bfloat16")),
            ("shard_cache", ("auto", "on", "off")),
            ("verify_shards", ("off", "sample", "open", "full")),
            ("anomaly_policy", ("off", "warn", "skip", "rollback")),
            ("diag_level", ("off", "basic", "full")),
            ("encoder_quant", ("off", "bf16", "int8")),
            ("encode_cache", ("off", "on")),
            ("serve_tier", ("both", "encode", "decode")),
        )
        for name, allowed in checks:
            if getattr(self, name) not in allowed:
                raise ValueError(
                    f"Config.{name}={getattr(self, name)!r}: must be one of {allowed}"
                )
        if self.io_retries < 0:
            raise ValueError(f"Config.io_retries={self.io_retries}: must be >= 0")
        if self.keep_checkpoints < 0:
            raise ValueError(
                f"Config.keep_checkpoints={self.keep_checkpoints}: must be >= 0"
            )
        if self.heartbeat_interval < 0:
            raise ValueError(
                f"Config.heartbeat_interval={self.heartbeat_interval}: must be >= 0"
            )
        if self.bulk_shard_rows < 1:
            raise ValueError(
                f"Config.bulk_shard_rows={self.bulk_shard_rows}: must be >= 1"
            )
        if not 0 < self.quarantine_max_fraction <= 1:
            raise ValueError(
                f"Config.quarantine_max_fraction="
                f"{self.quarantine_max_fraction}: must be in (0, 1]"
            )
        if self.telemetry_buffer <= 0:
            raise ValueError(
                f"Config.telemetry_buffer={self.telemetry_buffer}: must be > 0"
            )
        if self.metrics_port < 0 or self.telemetry_log_cap_mb < 0:
            raise ValueError(
                "Config.metrics_port and telemetry_log_cap_mb must be >= 0"
            )
        if self.profile_window_ms <= 0:
            raise ValueError(
                f"Config.profile_window_ms={self.profile_window_ms}: "
                "must be > 0"
            )
        if (
            self.slo_window_fast_s <= 0
            or self.slo_window_slow_s < self.slo_window_fast_s
        ):
            raise ValueError(
                "Config.slo_window_fast_s must be > 0 and <= "
                "slo_window_slow_s (fast pages, slow confirms)"
            )
        if min(
            self.slo_serve_p99_ms,
            self.slo_error_ratio,
            self.slo_captions_per_s,
            self.slo_ckpt_age_s,
        ) < 0:
            raise ValueError("Config.slo_* targets must be >= 0 (0 = off)")
        if self.slo_error_ratio > 1:
            raise ValueError(
                f"Config.slo_error_ratio={self.slo_error_ratio}: a ratio "
                "target cannot exceed 1"
            )
        buckets = tuple(self.serve_buckets)
        if buckets != self.serve_buckets:
            # normalize list -> tuple: this Config is a jit static arg and
            # must stay hashable however the field arrived
            object.__setattr__(self, "serve_buckets", buckets)
        if (
            not buckets
            or any(int(b) <= 0 for b in buckets)
            or tuple(sorted(set(buckets))) != buckets
        ):
            raise ValueError(
                f"Config.serve_buckets={self.serve_buckets}: must be a "
                "strictly increasing tuple of positive batch sizes"
            )
        if not 0 < self.serve_max_batch <= max(buckets):
            raise ValueError(
                f"Config.serve_max_batch={self.serve_max_batch}: must be in "
                f"[1, max(serve_buckets)={max(buckets)}] — a batch larger "
                "than the largest warmed bucket could never dispatch"
            )
        if (
            self.serve_max_wait_ms < 0
            or self.serve_deadline_ms < 0
            or self.serve_wedge_timeout_ms < 0
        ):
            raise ValueError(
                "Config.serve_max_wait_ms/serve_deadline_ms/"
                "serve_wedge_timeout_ms must be >= 0"
            )
        if self.serve_queue_depth <= 0 or self.serve_port < 0:
            raise ValueError(
                "Config.serve_queue_depth must be > 0 and serve_port >= 0"
            )
        if self.serve_mode not in ("batch", "continuous"):
            raise ValueError(
                f"Config.serve_mode={self.serve_mode!r}: must be 'batch' "
                "or 'continuous'"
            )
        if self.serve_slot_pages <= 0 or self.serve_page_width <= 0:
            raise ValueError(
                "Config.serve_slot_pages and serve_page_width must be >= 1"
            )
        if self.encode_cache_mb <= 0:
            raise ValueError(
                f"Config.encode_cache_mb={self.encode_cache_mb}: must be "
                "> 0 (the ring needs at least one feature-grid row)"
            )
        if self.serve_quality not in ("off", "on"):
            raise ValueError(
                f"Config.serve_quality={self.serve_quality!r}: must be "
                "'off' or 'on'"
            )
        if self.serve_quality_window < 8:
            raise ValueError(
                f"Config.serve_quality_window={self.serve_quality_window}: "
                "must be >= 8 (a drift sketch needs a real window)"
            )
        if self.serve_quality_exemplar_mb <= 0:
            raise ValueError(
                "Config.serve_quality_exemplar_mb must be > 0"
            )
        if self.serve_quality_margin_min < 0:
            raise ValueError(
                "Config.serve_quality_margin_min must be >= 0 (0 = off)"
            )
        if not 0 <= self.serve_quality_unk_max <= 1:
            raise ValueError(
                "Config.serve_quality_unk_max must be in [0, 1] (1 = off)"
            )
        if self.slo_quality_psi < 0:
            raise ValueError(
                "Config.slo_quality_psi must be >= 0 (0 = lane off)"
            )
        if not 0 <= self.slo_quality_unk <= 1:
            raise ValueError(
                "Config.slo_quality_unk must be in [0, 1] (0 = lane off)"
            )
        depths = tuple(self.serve_decode_depth)
        if depths != self.serve_decode_depth:
            # same hashability normalization as serve_buckets
            object.__setattr__(self, "serve_decode_depth", depths)
        if (
            not depths
            or depths[0] != 1
            or any(int(k) <= 0 for k in depths)
            or tuple(sorted(set(depths))) != depths
        ):
            raise ValueError(
                f"Config.serve_decode_depth={self.serve_decode_depth}: must "
                "be a strictly increasing tuple of positive step counts "
                "starting at 1 (the burst lane)"
            )
        if self.model_reload < 0:
            raise ValueError(
                f"Config.model_reload={self.model_reload}: must be >= 0 "
                "(0 = lifecycle off)"
            )
        if not 0 <= self.canary_fraction <= 1:
            raise ValueError(
                f"Config.canary_fraction={self.canary_fraction}: must be "
                "in [0, 1]"
            )
        if self.canary_window_s <= 0:
            raise ValueError(
                f"Config.canary_window_s={self.canary_window_s}: must be > 0"
            )
        if self.promote_policy not in ("auto", "manual"):
            raise ValueError(
                f"Config.promote_policy={self.promote_policy!r}: must be "
                "'auto' or 'manual'"
            )
        if not 0 <= self.canary_shadow_rate <= 1:
            raise ValueError(
                f"Config.canary_shadow_rate={self.canary_shadow_rate}: "
                "must be in [0, 1]"
            )
        if not 0 <= self.canary_divergence_max <= 1:
            raise ValueError(
                f"Config.canary_divergence_max={self.canary_divergence_max}: "
                "must be in [0, 1] (a Jaccard distance; 0 = off)"
            )
        if self.route_port < 0 or self.route_replica_base_port < 0:
            raise ValueError(
                "Config.route_port and route_replica_base_port must be >= 0"
            )
        if self.route_num_replicas <= 0:
            raise ValueError(
                f"Config.route_num_replicas={self.route_num_replicas}: "
                "must be >= 1"
            )
        if self.route_poll_interval_s <= 0 or self.route_stats_every <= 0:
            raise ValueError(
                "Config.route_poll_interval_s must be > 0 and "
                "route_stats_every >= 1"
            )
        if self.route_hysteresis < 0:
            raise ValueError(
                f"Config.route_hysteresis={self.route_hysteresis}: "
                "must be >= 0"
            )
        if not 0 < self.route_down_weight <= 1:
            raise ValueError(
                f"Config.route_down_weight={self.route_down_weight}: must "
                "be in (0, 1] — zero would blackhole degraded replicas"
            )
        if self.route_shed_depth < 0 or self.route_upstream_timeout_s <= 0:
            raise ValueError(
                "Config.route_shed_depth must be >= 0 and "
                "route_upstream_timeout_s > 0"
            )
        if (
            self.encoder_quant_calib_batches <= 0
            or self.encoder_quant_calib_batch_size <= 0
        ):
            raise ValueError(
                "Config.encoder_quant_calib_batches and "
                "encoder_quant_calib_batch_size must be >= 1"
            )
        for name in (
            "watchdog_interval",
            "watchdog_step_s",
            "watchdog_data_wait_s",
            "watchdog_dispatch_s",
            "watchdog_checkpoint_s",
            "watchdog_grace_s",
            "supervise_backoff_s",
        ):
            if getattr(self, name) < 0:
                raise ValueError(
                    f"Config.{name}={getattr(self, name)}: must be >= 0"
                )
        if self.supervise_max_restarts < 0:
            raise ValueError(
                f"Config.supervise_max_restarts={self.supervise_max_restarts}: "
                "must be >= 0"
            )
        if self.straggler_factor < 1:
            raise ValueError(
                f"Config.straggler_factor={self.straggler_factor}: must be "
                ">= 1 (a host at the fleet median is not a straggler)"
            )

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)

    # -- persistence: configs ride along with checkpoints, like the
    #    reference's config.pickle (base_model.py:250-253) but as JSON. --
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def save(self, path: str) -> None:
        """Atomic JSON write (tmp file + rename)."""
        d = os.path.dirname(path) or "."
        os.makedirs(d, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=2, default=list)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as f:
            raw = json.load(f)
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "Config":
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in raw.items() if k in names}
        # JSON has no tuples; these fields must come back hashable (the
        # Config rides jit static_argnames — a list field breaks lower())
        for key in (
            "mesh_shape", "mesh_axes", "serve_buckets", "serve_decode_depth"
        ):
            if key in kw and isinstance(kw[key], list):
                kw[key] = tuple(kw[key])
        return cls(**kw)

    @property
    def is_train(self) -> bool:
        return self.phase == "train"

    # Path fields re-rooted by the SAT_DATA_ROOT / SAT_LOG_ROOT env vars
    # (apply_env_paths below).
    DATA_PATH_FIELDS = (
        "vocabulary_file", "train_image_dir", "train_caption_file",
        "temp_annotation_file", "temp_data_file", "eval_image_dir",
        "eval_caption_file", "test_image_dir", "shard_cache_dir",
    )
    LOG_PATH_FIELDS = (
        "save_dir", "summary_dir", "profile_dir", "eval_result_dir",
        "eval_result_file", "test_result_dir", "test_result_file",
        "telemetry_dir", "trace_export", "fleet_dir",
    )

    def apply_env_paths(self) -> "Config":
        """Environment-driven data/log path indirection — the capability of
        the reference's clusterone get_data_path/get_logs_path wrappers
        (/root/reference/clusterone_config.py:64-85): the same config runs
        locally or on a cluster whose storage is mounted elsewhere.

        ``SAT_DATA_ROOT`` re-roots input paths (datasets, caption JSONs,
        vocab, preprocessing caches); ``SAT_LOG_ROOT`` re-roots output
        paths (checkpoints, summaries, profiles, results).  Only fields
        still holding their *default* value are re-rooted — an explicit
        ``--set`` or programmatic override always wins.  Relative defaults
        like ``./data/train/images/`` become ``<root>/data/train/images/``.
        """
        updates: Dict[str, Any] = {}
        defaults = Config()
        for env, fields in (
            ("SAT_DATA_ROOT", self.DATA_PATH_FIELDS),
            ("SAT_LOG_ROOT", self.LOG_PATH_FIELDS),
        ):
            root = os.environ.get(env)
            if not root:
                continue
            for name in fields:
                value = getattr(self, name)
                if value and value == getattr(defaults, name):
                    updates[name] = os.path.join(root, value.removeprefix("./"))
        return self.replace(**updates) if updates else self

    @property
    def num_ctx(self) -> int:
        """Spatial context-grid size (reference model.py:58,107): 196 for
        VGG16 / 49 for ResNet50 at the reference's 224×224 input; scales
        with image_size (VGG16 downsamples 16×, ResNet50 32×)."""
        stride = 16 if self.cnn == "vgg16" else 32
        # SAME-padded convs/pools round spatial dims UP at each stage, so
        # the composed downsampling is ceil division.
        return (-(-self.image_size // stride)) ** 2

    @property
    def dim_ctx(self) -> int:
        """Context feature dim (reference model.py:59,108)."""
        return 512 if self.cnn == "vgg16" else 2048
