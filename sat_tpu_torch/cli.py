"""Command-line driver: ``python -m sat_tpu_torch.cli --phase serve``.

The port of ``sat_tpu.cli`` for the phases ported so far — only
``serve``, which runs on the card.  It takes the JAX CLI's flags for that
phase (``--config``, ``--set key=value``, ``--port``, ``--max_batch``,
``--max_wait_ms``, ``--model_file``), so one config file and one
override list drive both packages.  Any other phase exits with "not
ported yet".
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import List, Optional

from .config import Config

PORTED_PHASES = ("serve",)

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
    """Returns (Config, model_file)."""
    p = argparse.ArgumentParser(
        prog="sat_tpu_torch", description="Show, Attend and Tell on PyTorch/CUDA"
    )
    p.add_argument(
        "--phase", default=None,
        choices=["train", "eval", "test", "serve", "route", "bulk"],
        help="default: train, or the --config file's phase when one is given",
    )
    p.add_argument("--config", default=None, help="JSON Config file (either package's)")
    p.add_argument("--model_file", default=None, help="explicit checkpoint file")
    p.add_argument("--port", type=int, default=None, help="serve: HTTP port (0 = ephemeral)")
    p.add_argument("--max_batch", type=int, default=None, help="serve: most requests per batch")
    p.add_argument(
        "--max_wait_ms", type=float, default=None,
        help="serve: how long an underfull batch is held open",
    )
    p.add_argument(
        "--set", action="append", default=[], metavar="KEY=VALUE",
        help="override any Config field, repeatable",
    )
    args = p.parse_args(argv)
    if args.config:
        config = Config.load(args.config)
        if args.phase is not None:
            config = config.replace(phase=args.phase)
    else:
        config = Config(phase=args.phase if args.phase is not None else "train")
    if args.port is not None:
        config = config.replace(serve_port=args.port)
    if args.max_batch is not None:
        config = config.replace(serve_max_batch=args.max_batch)
    if args.max_wait_ms is not None:
        config = config.replace(serve_max_wait_ms=args.max_wait_ms)
    overrides = {}
    for item in args.set:
        if "=" not in item:
            raise SystemExit(f"--set expects KEY=VALUE, got {item!r}")
        key, raw = item.split("=", 1)
        key = _REFERENCE_KEY_ALIASES.get(key, key)
        overrides[key] = _parse_override(config, key, raw)
    if overrides:
        config = config.replace(**overrides)
    return config.apply_env_paths(), args.model_file


def main(argv: Optional[List[str]] = None) -> int:
    config, model_file = build_config(argv)
    if config.phase not in PORTED_PHASES:
        raise SystemExit(
            f"sat_tpu_torch: phase {config.phase!r} is not ported yet "
            f"(ported: {', '.join(PORTED_PHASES)}); use python -m sat_tpu.cli"
        )
    from .serve.server import serve

    return serve(config, model_file=model_file)


if __name__ == "__main__":
    sys.exit(main())
