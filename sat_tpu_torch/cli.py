"""Command-line entry point: ``python -m sat_tpu_torch.cli --phase train|serve|route|eval|test|bulk``.

The port of ``sat_tpu.cli``; every phase runs the port.  It takes the
JAX CLI's flags for them (``--config``, ``--set key=value``,
``--print_config``, ``--model_file`` (a ``<step>.npz``, or a ``.npy``
the reference wrote), ``--load``, ``--train_cnn``, ``--load_cnn`` with
``--cnn_model_file`` (train only; eval and test ignore it, as in the JAX
CLI), ``--beam_size``, ``--shard_cache``, ``--verify_shards``,
``--anomaly_policy``, ``--keep_checkpoints``, ``--io_retries``,
``--watchdog``, ``--sweep``, ``--encoder_quant`` (serve and bulk
quantize; the other phases encode in full precision); for serve
``--port``, ``--max_batch``, ``--max_wait_ms``, ``--serve_mode``,
``--serve_decode_depth``; for route ``--replicas`` (which implies the
phase), ``--num_replicas``, ``--straggler_factor`` and ``--port`` (the
router's own); for bulk ``--bulk_input``, ``--bulk_output``,
``--bulk_shard_rows``; ``--supervise`` with ``--max_restarts``), so one
config file and one override list drive both packages.

``--print_config`` prints the resolved Config as JSON and exits 0
before anything else runs.  ``--supervise`` runs the same command in a
child process and restarts it with ``--load`` when it crashes, is
killed or is aborted by the watchdog (exit 86); ``--phase route``
fronts serve replicas (spawned as ``--phase serve`` children of this
CLI, or named by ``--replicas``).  Both parents are dispatched before
anything imports torch, so neither holds a CUDA context: the children
own the card.  ``SAT_TORCH_DEVICE=cpu`` in the environment asks every
phase (and the children, which inherit it) for the CPU.

Exit codes: train exits 1 when a checkpoint it depends on did not land
or on an injected preemption (``SAT_FI_DIE_AT_STEP``; resume with
``--load``), and 0 after a graceful SIGTERM/SIGINT stop; bulk exits 1 on
an injected preemption (relaunch to resume) and 0 after a graceful
stop; train and bulk exit 87 when the quarantine's systemic-corruption
ceiling trips, and 86 when the watchdog aborts a wedged run.
``--repair_shards`` rebuilds the shard-cache files holding rotted or
quarantined rows, prints a JSON report and exits 0, or 2 when no cache
exists; it touches no device.  Eval prints each score as ``name:
value``; ``--sweep`` scores every checkpoint under save_dir and prints
a ``step N: ...`` line for each.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import List, Optional

from .config import Config

PORTED_PHASES = ("train", "serve", "route", "eval", "test", "bulk")

# the reference's misspelled config keys, accepted like the JAX CLI does
_REFERENCE_KEY_ALIASES = {
    "num_initalize_layers": "num_initialize_layers",
    "dim_initalize_layer": "dim_initialize_layer",
}


def _parse_override(config: Config, key: str, raw: str):
    fields = {f.name for f in dataclasses.fields(Config)}
    if key not in fields:
        raise SystemExit(f"--set {key}: unknown Config field")
    current = getattr(config, key)
    if raw.lower() == "none":
        return None
    if isinstance(current, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, tuple):
        return tuple(int(x) for x in raw.split(","))
    if current is None:
        try:
            return int(raw)
        except ValueError:
            return raw
    return raw


def build_config(argv: Optional[List[str]] = None):
    """Returns (Config, cli options: model_file, load, load_cnn,
    cnn_model_file, sweep, repair_shards, print_config, supervise,
    max_restarts)."""
    p = argparse.ArgumentParser(
        prog="sat_tpu_torch", description="Show, Attend and Tell on PyTorch/CUDA"
    )
    p.add_argument(
        "--phase", default=None,
        choices=["train", "eval", "test", "serve", "route", "bulk"],
        help="default: train, or the --config file's phase when one is given",
    )
    p.add_argument("--config", default=None, help="JSON Config file (either package's)")
    p.add_argument(
        "--load", action="store_true",
        help="resume from the latest checkpoint in save_dir",
    )
    p.add_argument("--model_file", default=None, help="explicit checkpoint file")
    p.add_argument(
        "--load_cnn", action="store_true",
        help="train: import a pretrained CNN from --cnn_model_file before training",
    )
    p.add_argument(
        "--cnn_model_file", default="./vgg16_no_fc.npy",
        help="pretrained CNN npy (the reference's nested format)",
    )
    p.add_argument("--train_cnn", action="store_true", help="train: train the CNN too")
    p.add_argument(
        "--supervise", action="store_true",
        help="crash-only restart loop: keep this process torch-free and run "
             "the work in a child; a child that crashes, is killed or is "
             "aborted by the watchdog (exit 86) is relaunched with --load, "
             "after a jittered exponential backoff, within a restart budget",
    )
    p.add_argument(
        "--max_restarts", type=int, default=None, metavar="N",
        help="--supervise restart budget (default Config.supervise_max_restarts)",
    )
    p.add_argument(
        "--watchdog", type=float, default=None, metavar="SEC",
        help="arm the hang watchdog with this poll interval (sets "
             "watchdog_interval; per-phase deadlines via --set "
             "watchdog_step_s=... etc.; 0 disables, the default)",
    )
    p.add_argument(
        "--anomaly_policy", default=None, choices=["off", "warn", "skip", "rollback"],
        help="anomaly sentinel's response to NaN/Inf or spiking metrics at "
             "each log_every check: 'warn' (default) reports and stops "
             "blessing LAST_GOOD, 'skip' also suppresses checkpoint writes "
             "while unhealthy, 'rollback' restores LAST_GOOD and skips past "
             "the poison step, 'off' disarms the sentinel",
    )
    p.add_argument(
        "--keep_checkpoints", type=int, default=None, metavar="N",
        help="checkpoint retention: keep the newest N plus the LAST_GOOD "
             "target, delete the rest (default 0 = keep everything)",
    )
    p.add_argument(
        "--io_retries", type=int, default=None, metavar="N",
        help="retry budget for transient IO errors on checkpoint, shard, "
             "manifest and caption reads and writes, with jittered "
             "exponential backoff (default 3; 0 disables)",
    )
    p.add_argument(
        "--print_config", action="store_true",
        help="print the resolved Config as JSON and exit",
    )
    p.add_argument(
        "--replicas", default=None, metavar="HOST:PORT,...",
        help="route: front these pre-started serve replicas instead of "
             "spawning a local fleet (implies --phase route)",
    )
    p.add_argument(
        "--num_replicas", type=int, default=None, metavar="N",
        help="route: size of the locally spawned replica fleet (ignored "
             "with --replicas; default Config.route_num_replicas)",
    )
    p.add_argument(
        "--straggler_factor", type=float, default=None, metavar="X",
        help="fleet straggler threshold: name the worst replica when its "
             "request p99 exceeds the fleet median by this factor (default 2.0)",
    )
    p.add_argument("--beam_size", type=int, default=None)
    p.add_argument(
        "--shard_cache", default=None, choices=["auto", "on", "off"],
        help="preprocessed-image shard cache (data.shards): 'auto' uses a "
             "valid existing cache and decodes live otherwise, 'on' builds or "
             "extends the cache before the run, 'off' always decodes live",
    )
    p.add_argument(
        "--verify_shards", default=None, choices=["off", "sample", "open", "full"],
        help="verify gathered shard rows against their crc32c sidecars "
             "(data.integrity): 'sample' one rotating row every few gathers, "
             "'open' each shard in full on first touch, 'full' every row; a "
             "corrupt row falls back to live decode, failing that it is "
             "quarantined",
    )
    p.add_argument(
        "--repair_shards", action="store_true",
        help="rebuild only the shard files holding crc-mismatching or "
             "quarantined rows by re-decoding their images, print a JSON "
             "report and exit (no device needed)",
    )
    p.add_argument(
        "--sweep", action="store_true",
        help="eval phase: score every checkpoint under save_dir, writing "
             "<step>.txt dumps",
    )
    p.add_argument(
        "--port", type=int, default=None,
        help="serve: HTTP port (0 = ephemeral); route: the router's port",
    )
    p.add_argument("--max_batch", type=int, default=None, help="serve: most requests per batch")
    p.add_argument(
        "--max_wait_ms", type=float, default=None,
        help="serve: how long an underfull batch is held open",
    )
    p.add_argument(
        "--serve_mode", choices=("batch", "continuous"), default=None,
        help="serve: 'batch' dispatches whole padded batches; 'continuous' "
             "seeds requests into a paged slot pool between decode steps",
    )
    p.add_argument(
        "--serve_decode_depth", default=None, metavar="K1,K2,...",
        help="serve (continuous): the fused decode window's depths, starting "
             "at 1; the deepest runs while no request waits, K=1 otherwise",
    )
    p.add_argument(
        "--bulk_input", default=None, metavar="PATH",
        help="bulk: the image corpus, a directory tree (walked for images; "
             "other files are skipped and counted) or a text file listing "
             "one image path per line",
    )
    p.add_argument(
        "--bulk_output", default=None, metavar="DIR",
        help="bulk: output directory for captions_<shard>.jsonl, their crc "
             "sidecars and the bulk_manifest.json resume frontier",
    )
    p.add_argument(
        "--bulk_shard_rows", type=int, default=None, metavar="N",
        help="bulk: images per output shard, the resume grain",
    )
    p.add_argument(
        "--encoder_quant", choices=("off", "bf16", "int8"), default=None,
        help="serve and bulk: quantize the frozen CNN once at load, before "
             "warmup: 'int8' per-output-channel symmetric int8 kernels with "
             "calibrated activation scales (int8 x int8 -> int32 convs, the "
             "dequant fused into the bias add), 'bf16' bfloat16 kernels; "
             "batch norms folded into the convs.  Train, eval and test "
             "encode in full precision",
    )
    p.add_argument(
        "--telemetry", action="store_true",
        help="host-side span tracing (serve always turns it on; train, eval "
             "and test do not take it yet)",
    )
    p.add_argument(
        "--heartbeat_interval", type=float, default=None, metavar="SEC",
        help="seconds between heartbeat.json rewrites (default 10; 0 "
             "disables the heartbeat thread)",
    )
    p.add_argument(
        "--trace_export", default=None, metavar="PATH",
        help="serve: Chrome trace-event JSON written at shutdown, one lane "
             "a retained request; load in Perfetto or chrome://tracing",
    )
    p.add_argument(
        "--blackbox", action="store_true",
        help="serve: black-box flight recorder (a bounded on-disk event ring "
             "under <telemetry_dir>/blackbox and a postmortem_<run_id>/ "
             "bundle on an uncaught exception); implies --telemetry",
    )
    p.add_argument(
        "--serve_metering", choices=("on", "off"), default=None,
        help="serve: per-request cost attribution, the metering.jsonl ledger "
             "and the online capacity model (only with telemetry on, as "
             "serve always has it; default on)",
    )
    p.add_argument(
        "--slo_capacity_headroom_pct", type=float, default=None, metavar="PCT",
        help="serve: capacity_headroom SLO objective, burning when the "
             "capacity model's headroom gauge falls below PCT (0 disables; "
             "default 0)",
    )
    p.add_argument(
        "--tenants", default=None, metavar="SPEC",
        help="serve: multi-tenant registry, a JSON file path or an inline "
             "'name[:weight[:rps[:burst]]],...' list (the first entry is the "
             "default tenant of requests without X-Tenant): weighted "
             "deficit-round-robin lanes, token-bucket quotas, per-tenant SLO "
             "lanes and resident models (default '' = single-tenant)",
    )
    p.add_argument(
        "--encode_cache", choices=("on", "off"), default=None,
        help="serve: device-resident content-addressed LRU of encoder "
             "feature grids keyed by (image key, param fingerprint); a hit "
             "skips the encode, a miss encodes once with single-flight "
             "coalescing (default off)",
    )
    p.add_argument(
        "--encode_cache_mb", type=int, default=None,
        help="serve: device memory for the encode cache's ring (sized at "
             "warmup; default 64)",
    )
    p.add_argument(
        "--serve_tier", choices=("both", "encode", "decode"), default=None,
        help="serve: the fleet tier this replica advertises: 'encode' (the "
             "POST /encode feature-grid tier), 'decode' (fed grids) or "
             "'both' (default); every replica still captions images",
    )
    p.add_argument(
        "--serve_quality", choices=("on", "off"), default=None,
        help="serve and bulk: the caption-quality plane (per-request "
             "signals, streaming drift against a frozen reference, the "
             "exemplar recorder; bulk rows gain a quality block); default off",
    )
    p.add_argument(
        "--quality_reference", default=None, metavar="JSON",
        help="serve: a quality_reference.json (from GET /quality_reference) "
             "to load as the frozen drift reference; default '' freezes it "
             "from the first serve_quality_window requests",
    )
    p.add_argument(
        "--slo_quality_psi", type=float, default=None, metavar="PSI",
        help="serve: quality_drift SLO lane over quality/psi_max; "
             "diagnostic (/healthz stays ok while it burns); 0 disables",
    )
    p.add_argument(
        "--slo_quality_unk", type=float, default=None, metavar="RATE",
        help="serve: quality_unk SLO lane over quality/unk_rate; 0 disables",
    )
    p.add_argument(
        "--model_reload", type=float, default=None, metavar="SEC",
        help="serve: poll the lineage LAST_GOOD pointer every SEC seconds "
             "(jittered) and hot-swap new checkpoints through a canary "
             "stage (0 = off, the default)",
    )
    p.add_argument(
        "--canary_fraction", type=float, default=None, metavar="F",
        help="serve: fraction of requests routed to the candidate during "
             "the canary window, sticky per X-Request-Id",
    )
    p.add_argument(
        "--canary_window_s", type=float, default=None, metavar="SEC",
        help="serve: the canary window's length before promote or rollback "
             "is decided",
    )
    p.add_argument(
        "--promote_policy", choices=("auto", "manual"), default=None,
        help="serve: 'auto' promotes a candidate whose canary window "
             "elapsed without its SLO burning; 'manual' holds in CANARY "
             "until POST /promote or /rollback",
    )
    p.add_argument(
        "--set", action="append", default=[], metavar="KEY=VALUE",
        help="override any Config field, repeatable",
    )
    args = p.parse_args(argv)
    if args.sweep and (args.model_file or args.load):
        raise SystemExit(
            "--sweep scores every checkpoint under save_dir; it conflicts "
            "with --model_file/--load"
        )
    if args.config:
        # file values are the base; only explicit flags override them
        config = Config.load(args.config)
        if args.phase is not None:
            config = config.replace(phase=args.phase)
        if args.train_cnn:
            config = config.replace(train_cnn=True)
        if args.beam_size is not None:
            config = config.replace(beam_size=args.beam_size)
    else:
        config = Config(
            phase=args.phase if args.phase is not None else "train",
            train_cnn=args.train_cnn,
            beam_size=args.beam_size if args.beam_size is not None else 3,
        )
    if args.shard_cache is not None:
        config = config.replace(shard_cache=args.shard_cache)
    if args.encoder_quant is not None:
        config = config.replace(encoder_quant=args.encoder_quant)
    if args.verify_shards is not None:
        config = config.replace(verify_shards=args.verify_shards)
    if args.anomaly_policy is not None:
        config = config.replace(anomaly_policy=args.anomaly_policy)
    if args.keep_checkpoints is not None:
        config = config.replace(keep_checkpoints=args.keep_checkpoints)
    if args.io_retries is not None:
        config = config.replace(io_retries=args.io_retries)
    if args.straggler_factor is not None:
        config = config.replace(straggler_factor=args.straggler_factor)
    if args.replicas is not None:
        # naming endpoints implies the route phase (before --port below,
        # which binds the router in the route phase)
        config = config.replace(phase="route", route_replicas=args.replicas)
    if args.num_replicas is not None:
        config = config.replace(route_num_replicas=args.num_replicas)
    if args.bulk_input is not None:
        config = config.replace(bulk_input=args.bulk_input)
    if args.bulk_output is not None:
        config = config.replace(bulk_output=args.bulk_output)
    if args.bulk_shard_rows is not None:
        config = config.replace(bulk_shard_rows=args.bulk_shard_rows)
    if args.port is not None:
        # one --port flag, two listeners: the router's own in the route
        # phase, the replica's otherwise
        if config.phase == "route":
            config = config.replace(route_port=args.port)
        else:
            config = config.replace(serve_port=args.port)
    if args.max_batch is not None:
        config = config.replace(serve_max_batch=args.max_batch)
    if args.max_wait_ms is not None:
        config = config.replace(serve_max_wait_ms=args.max_wait_ms)
    if args.serve_mode is not None:
        config = config.replace(serve_mode=args.serve_mode)
    if args.telemetry:
        config = config.replace(telemetry=True)
    if args.blackbox:
        # the recorder rides the span recorder, so it implies the base layer
        config = config.replace(blackbox=True, telemetry=True)
    if args.heartbeat_interval is not None:
        config = config.replace(heartbeat_interval=args.heartbeat_interval)
    if args.trace_export is not None:
        config = config.replace(trace_export=args.trace_export)
    if args.serve_metering is not None:
        config = config.replace(serve_metering=args.serve_metering == "on")
    for flag, field in (
        ("tenants", "tenants"), ("encode_cache", "encode_cache"), ("encode_cache_mb", "encode_cache_mb"),
        ("serve_tier", "serve_tier"), ("serve_quality", "serve_quality"),
        ("quality_reference", "serve_quality_reference"), ("slo_quality_psi", "slo_quality_psi"),
        ("slo_quality_unk", "slo_quality_unk"), ("model_reload", "model_reload"),
        ("canary_fraction", "canary_fraction"), ("canary_window_s", "canary_window_s"),
        ("promote_policy", "promote_policy"),
    ):
        if getattr(args, flag) is not None:
            config = config.replace(**{field: getattr(args, flag)})
    if args.slo_capacity_headroom_pct is not None:
        config = config.replace(slo_capacity_headroom_pct=args.slo_capacity_headroom_pct)
    if args.serve_decode_depth is not None:
        config = config.replace(serve_decode_depth=tuple(
            int(k) for k in args.serve_decode_depth.split(",") if k
        ))
    if args.watchdog is not None:
        config = config.replace(watchdog_interval=args.watchdog)
    overrides = {}
    for item in args.set:
        if "=" not in item:
            raise SystemExit(f"--set expects KEY=VALUE, got {item!r}")
        key, raw = item.split("=", 1)
        key = _REFERENCE_KEY_ALIASES.get(key, key)
        overrides[key] = _parse_override(config, key, raw)
    if overrides:
        config = config.replace(**overrides)
    config = config.apply_env_paths()
    # checked against the resolved phase, so `--sweep --config <eval cfg>`
    # works without restating --phase
    if args.sweep and config.phase != "eval":
        raise SystemExit("--sweep only applies to --phase=eval")
    return config, {
        "model_file": args.model_file, "load": args.load, "load_cnn": args.load_cnn,
        "cnn_model_file": args.cnn_model_file, "sweep": args.sweep,
        "repair_shards": args.repair_shards, "print_config": args.print_config,
        "supervise": args.supervise, "max_restarts": args.max_restarts,
    }


def main(argv: Optional[List[str]] = None) -> int:
    config, cli = build_config(argv)
    if cli["print_config"]:
        import json

        print(json.dumps(config.to_dict(), indent=2, sort_keys=True))
        return 0
    if cli["repair_shards"]:
        import json

        from .data.integrity import repair_shards

        try:
            report = repair_shards(config)
        except FileNotFoundError:
            print(
                "sat_tpu_torch: --repair_shards: no shard cache exists for this config "
                f"(looked under {config.shard_cache_dir!r})",
                file=sys.stderr, flush=True,
            )
            return 2
        print(json.dumps(report, indent=2, sort_keys=True))
        return 0
    if cli["supervise"]:
        # the supervisor parent never imports torch: it must outlive a
        # child whose device runtime wedges, and holds no CUDA context of
        # its own.  The child re-enters this CLI without --supervise.
        from .resilience.supervisor import supervise

        return supervise(
            list(argv) if argv is not None else list(sys.argv[1:]),
            max_restarts=(
                cli["max_restarts"] if cli["max_restarts"] is not None
                else config.supervise_max_restarts
            ),
            backoff_base_s=config.supervise_backoff_s,
        )
    if config.phase == "route":
        # torch-free for the same reason: the replicas it spawns re-enter
        # this CLI in --phase serve and own the card
        from .serve.router import route

        return route(config)
    if config.phase == "serve":
        from .serve.server import serve

        return serve(config, model_file=cli["model_file"])

    from . import runtime
    from .resilience import retry
    from .resilience.faultinject import SimulatedPreemption
    from .resilience.quarantine import DATA_CORRUPTION_EXIT_CODE, SystemicCorruption

    retry.configure(config.io_retries, config.io_retry_base_s)
    if config.phase == "train":
        from .resilience.lineage import CheckpointWriteError

        state = runtime.setup_train_state(
            config, load=cli["load"], model_file=cli["model_file"],
            load_cnn=cli["load_cnn"], cnn_model_file=cli["cnn_model_file"],
        )
        try:
            runtime.train(config, state=state)
        except CheckpointWriteError as e:
            # the run trained, but a checkpoint it depends on did not land
            print(f"sat_tpu_torch: WARNING: {e}", file=sys.stderr, flush=True)
            return 1
        except SimulatedPreemption as e:
            # an injected preemption: exit like the killed process it
            # simulates; the supervisor relaunches with --load
            print(f"sat_tpu_torch: {e}", file=sys.stderr, flush=True)
            return 1
        except SystemicCorruption as e:
            # the data is rotten, not the process: a rerun re-reads the rot
            print(f"sat_tpu_torch: FATAL: {e}", file=sys.stderr, flush=True)
            return DATA_CORRUPTION_EXIT_CODE
        # a graceful SIGTERM/SIGINT stop returns here too: exit 0, resume with --load
        return 0
    if config.phase == "bulk":
        from .bulk.runner import run_bulk

        try:
            return run_bulk(config, model_file=cli["model_file"])
        except SimulatedPreemption as e:
            # an injected preemption: exit like a killed process; a
            # relaunch resumes from the manifest frontier
            print(f"sat_tpu_torch: {e}", file=sys.stderr, flush=True)
            return 1
        except SystemicCorruption as e:
            print(f"sat_tpu_torch: FATAL: {e}", file=sys.stderr, flush=True)
            return DATA_CORRUPTION_EXIT_CODE
    if config.phase == "eval":
        if cli["sweep"]:
            sweep = runtime.evaluate_sweep(config)
            for step in sorted(sweep):
                line = "  ".join(f"{k}={v:.4f}" for k, v in sweep[step].items())
                print(f"step {step}: {line}")
            return 0
        state = runtime.setup_state(config, load=True, model_file=cli["model_file"])
        scores = runtime.evaluate(config, state=state)
        for k, v in scores.items():
            print(f"{k}: {v:.4f}")
    else:
        state = runtime.setup_state(config, load=True, model_file=cli["model_file"])
        runtime.test(config, state=state)
    return 0


if __name__ == "__main__":
    sys.exit(main())
