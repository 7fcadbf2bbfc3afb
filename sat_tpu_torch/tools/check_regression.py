"""Automated perf/quality regression gate over bench rows and compile
reports — the port of ``scripts/check_regression.py``, the same rules,
margins, exit codes and output over the port's artifacts.

Feed it the prior artifacts and a fresh one, and it exits nonzero when
the fresh numbers are worse than the best prior beyond a per-metric
noise margin.

Usage
-----
Trajectory mode (chronological; the LAST file is the candidate)::

    python -m sat_tpu_torch.tools.check_regression prior1.json prior2.json fresh.json

Explicit pair mode::

    python -m sat_tpu_torch.tools.check_regression --baseline prior.json --current fresh.json

Compile-report mode (may be combined with either of the above)::

    python -m sat_tpu_torch.tools.check_regression \
        --compile-baseline runs/prior/compile_report.json \
        --compile-current  out/telemetry/compile_report.json

Inputs accepted per file: a bench-contract JSONL stream
(``{"metric","value","unit","vs_baseline",...}`` per line, as every
``tools/bench_*.py`` vehicle prints), one JSON object/array of such rows,
or a bench-driver wrapper (``{"n","cmd","rc","tail","parsed"}`` — only
``parsed`` is read).  Wrappers whose run never produced numbers
(``parsed: null``) contribute nothing; when NO comparable pair exists the
gate exits 0 with a warning — an unreachable device must not fail CI,
only a measured regression may.

Schema compatibility: rows/reports stamped with a ``schema_version``
different from the port's ``sat_tpu_torch.telemetry.SCHEMA_VERSION`` are
REFUSED (exit 3).  Unstamped rows are legacy and compared best-effort.

Direction + margins: each metric has a better-direction (throughput up,
time/FLOPs/bytes down — see ``_lower_better``) and a noise margin in
percent (defaults below, override with ``--margin name=pct``).  The
candidate is compared against the BEST prior value so a noisy low prior
can't mask a real regression.

Infra-skip: a CANDIDATE artifact carrying ``error: device_unreachable``
rows means measurement never happened — an infrastructure outage, not a
metric regression.  The gate exits 3 with a named reason; measured
regressions in the same artifact still win (exit 2 takes precedence).

Compile reports: the port's ``telemetry/compile_report.py`` writes the
JAX package's document, so the gate reads the same keys under the same
function names (``train_step``, ``decode/encode``, ``decode/beam_search``).
What the port puts under them:

=================================  ==========================================
field read                         the port's value
=================================  ==========================================
``functions.<f>.cost.flops``       aten FLOPs of the first real call
                                   (``FlopCounterMode``) plus the hand
                                   kernel's FLOPs from its shapes
``functions.<f>.memory.temp_bytes``  the CUDA allocator's peak rise over that
                                   call (XLA: the executable's temp buffers)
``...memory.argument_bytes``       the call's input tensors' bytes
``...memory.output_bytes``         the call's output tensors' bytes
``functions.<f>.compile_seconds``  nvcc seconds spent in the call plus the
                                   call's own host seconds (informational,
                                   never gated, as in the JAX gate)
=================================  ==========================================

``memory`` is null on the CPU, and the fields the port cannot tell
(``transcendentals``, ``bytes_accessed``) are null; a null field is
skipped, as the JAX gate skips what its backend left out.

Exit codes: 0 = no regression (or nothing comparable), 2 = regression,
3 = incompatible schema or infra-skip (candidate is an unmeasured
device-unreachable artifact), 1 = IO/parse error; argparse's usage
errors exit 2.
"""

from __future__ import annotations

import argparse
import glob as _glob
import json
import sys
from typing import Any, Dict, List, Optional, Tuple

from ..telemetry import SCHEMA_VERSION


class SchemaMismatch(Exception):
    pass


# per-metric noise margins in percent of the best prior value
DEFAULT_MARGINS = {
    "flops": 1.0,              # compile-time FLOPs are exact; 1% = real change
    "temp_bytes": 2.0,         # HBM temp footprint: layout jitter only
    "output_bytes": 2.0,
    "argument_bytes": 2.0,
    "step_time_ms": 5.0,       # wall-clock: CI noise
    "train_captions_per_sec": 5.0,
    "eval_images_per_sec": 5.0,
    "Bleu_4": 1.0,             # quality: a point of BLEU is never noise
    "CIDEr": 1.0,
    "serve_encode_ms": 10.0,   # encode-lane timing: shared-host jitter
    "serve_encode_ms_int8": 10.0,
    "serve_encode_ms_bf16": 10.0,
    # quantization parity deltas are bounded-zero: the fixture harness
    # already holds them under their gate, so any measured GROWTH is a
    # quantizer regression (wrong scale axis, dropped dequant), not noise
    "quant_ctx_rel_err": 1.0,
    "quant_logit_drift": 1.0,
    # fleet rows ride N subprocess replicas on a shared CPU host — the
    # noisiest bench family we gate, so the margins are wide; a real
    # scaling regression moves goodput far more than this
    "fleet_goodput_rps": 10.0,
    "fleet_open_loop_p99_latency_ms": 15.0,
    "fleet_router_overhead_ms": 25.0,
    # bulk rows time whole CLI subprocesses (jax boot + checkpoint load +
    # decode) on a shared CPU host — wide margins like the fleet family
    "bulk_throughput_captions_s": 10.0,
    "bulk_resume_overhead_s": 25.0,
    # fused-decode rows (docs/SERVING.md "Fused decode window"): the
    # single-stream row is one closed-loop client on a shared CPU host —
    # per-request wall clock, so moderately noisy; admission p95 rides
    # the near-capacity open loop and inherits its burst jitter
    "serve_single_stream_latency_ms": 15.0,
    "serve_admission_latency_ms": 20.0,
    # lifecycle rows: the swap blackout is a continuous-mode pool drain
    # timed on a shared CPU host, and canary overhead is a ratio of two
    # open-loop p50s — both wall-clock-noisy families, wide margins
    "swap_blackout_ms": 25.0,
    "canary_overhead_pct": 25.0,
    # multi-tenant rows (docs/SERVING.md "Multi-tenant serving"): the
    # isolation ratio divides two open-loop p99s on a shared CPU host
    # (tail-over-tail — the noisiest shape we gate); fair-share error is
    # a completion-count fraction over a fixed window, much steadier
    "tenant_isolation_p99_ratio": 30.0,
    "tenant_fair_share_error": 25.0,
    # metering rows (docs/OBSERVABILITY.md "Cost attribution and tenant
    # metering"): overhead is a noise-floored microbench-over-p50 ratio
    # (bench_serve exit-gates the raw value at 0.5% separately); the
    # would-hit probe is a seeded-Zipf hit fraction, nearly deterministic
    "metering_overhead_pct": 25.0,
    "encode_cache_would_hit_ratio": 10.0,
    # encode-cache rows (docs/SERVING.md "Encode cache & tiered
    # fleets"): the ACTUAL hit ratio under seeded Zipf traffic is nearly
    # deterministic (bench_serve exit-gates the 0.6 floor separately);
    # the goodput row is an open loop on a shared CPU host — wide like
    # the fleet family, as is the two-hop disaggregated arm
    "encode_cache_hit_ratio": 10.0,
    "cache_serve_goodput_rps": 10.0,
    "fleet_disagg_goodput_rps": 10.0,
    # quality-plane row (docs/OBSERVABILITY.md "Caption quality"): the
    # same noise-floored microbench-over-p50 shape as metering_overhead
    # (bench_quality exit-gates the raw value at 0.5% separately)
    "quality_overhead_pct": 25.0,
}
FALLBACK_MARGIN = 5.0

# metrics where SMALLER is better; everything else is throughput/quality
_LOWER_BETTER_EXACT = {
    "step_time_ms",
    "compile_s",
    "telemetry_hot_path_overhead",
    "diag_tap_overhead",
    "ckpt_step_overhead",
    "flops",
    "transcendentals",
    "bytes_accessed",
    "temp_bytes",
    "output_bytes",
    "argument_bytes",
    "serve_encode_ms",
    "serve_single_stream_latency_ms",
    "serve_admission_latency_ms",
    "quant_ctx_rel_err",
    "quant_logit_drift",
    "tenant_isolation_p99_ratio",
    "tenant_fair_share_error",
}
# explicitly HIGHER-better (checked first — "per_sec" would otherwise
# trip the "_s" suffix heuristic below)
_HIGHER_BETTER_EXACT = {
    "train_captions_per_sec",
    "eval_images_per_sec",
    "shard_feed_speedup",
    "min_speedup",
    "fleet_goodput_rps",
    "fleet_disagg_goodput_rps",
    # a HIGHER would-be hit ratio means caching would pay off more —
    # the probe regressing toward 0 under the same seeded Zipf traffic
    # means the sketch (or its crc32c feed) broke
    "encode_cache_would_hit_ratio",
    # ...and the ACTUAL ratio regressing under the same traffic means
    # the device ring broke (keys drifting, over-eager flush/eviction)
    "encode_cache_hit_ratio",
    "Bleu_4",
    "CIDEr",
    "METEOR",
    "ROUGE_L",
}
_LOWER_BETTER_TOKENS = ("overhead", "seconds", "bytes", "latency")
_LOWER_BETTER_SUFFIXES = ("_ms", "_s", "_us", "_mb", "_time")
# quant-arm rows suffix the base metric with their mode
# (serve_encode_ms_int8, serve_closed_loop_throughput_bf16, ...) so the
# A/B pair gates independently; the variant inherits the base direction
_VARIANT_TAGS = ("_int8", "_bf16")


def _lower_better(metric: str) -> bool:
    for tag in _VARIANT_TAGS:
        if metric.endswith(tag):
            metric = metric[: -len(tag)]
            break
    if metric in _HIGHER_BETTER_EXACT:
        return False
    if metric in _LOWER_BETTER_EXACT:
        return True
    m = metric.lower()
    if "per_sec" in m or "speedup" in m or "throughput" in m:
        return False
    return any(tok in m for tok in _LOWER_BETTER_TOKENS) or m.endswith(
        _LOWER_BETTER_SUFFIXES
    )


def _check_schema(obj: Dict, path: str) -> None:
    v = obj.get("schema_version")
    if v is not None and v != SCHEMA_VERSION:
        raise SchemaMismatch(
            f"{path}: schema_version={v} is incompatible with this repo's "
            f"SCHEMA_VERSION={SCHEMA_VERSION} — refusing to compare"
        )


def _rows_from_obj(obj: Any, path: str) -> List[Dict]:
    """Normalize one parsed JSON value into BENCH rows."""
    if obj is None:
        return []
    if isinstance(obj, list):
        rows: List[Dict] = []
        for item in obj:
            rows.extend(_rows_from_obj(item, path))
        return rows
    if not isinstance(obj, dict):
        return []
    if "parsed" in obj and "rc" in obj:      # bench-driver wrapper
        return _rows_from_obj(obj.get("parsed"), path)
    if "metric" in obj:
        _check_schema(obj, path)
        value = obj.get("value")
        if isinstance(value, (int, float)):
            return [obj]
        return []                            # degraded row (value null)
    return []


# error strings that mean "the run never measured anything for
# infrastructure reasons" — candidate artifacts carrying them are an
# infra-skip (exit 3), never a regression
INFRA_SKIP_ERRORS = ("device_unreachable",)


def _errors_from_obj(obj: Any) -> List[str]:
    """Error strings carried by BENCH rows (``value`` null, ``error``
    set — the bench orchestrator's fallback line)."""
    if obj is None:
        return []
    if isinstance(obj, list):
        errors: List[str] = []
        for item in obj:
            errors.extend(_errors_from_obj(item))
        return errors
    if not isinstance(obj, dict):
        return []
    if "parsed" in obj and "rc" in obj:      # bench-driver wrapper
        return _errors_from_obj(obj.get("parsed"))
    err = obj.get("error")
    return [str(err)] if err else []


def load_errors(path: str) -> List[str]:
    """Error strings from one artifact file (same formats as load_rows)."""
    with open(path) as f:
        text = f.read().strip()
    if not text:
        return []
    try:
        return _errors_from_obj(json.loads(text))
    except json.JSONDecodeError:
        errors: List[str] = []
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                errors.extend(_errors_from_obj(json.loads(line)))
            except json.JSONDecodeError:
                continue
        return errors


def load_rows(path: str) -> List[Dict]:
    """BENCH rows from one artifact file (JSON, JSON array, JSONL, or
    driver wrapper).  IO/parse failures raise — a missing candidate file
    is a usage error, not a pass."""
    with open(path) as f:
        text = f.read().strip()
    if not text:
        return []
    try:
        return _rows_from_obj(json.loads(text), path)
    except json.JSONDecodeError:
        rows: List[Dict] = []
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            rows.extend(_rows_from_obj(json.loads(line), path))
        return rows


def best_prior(
    values: List[float], lower_better: bool
) -> float:
    return min(values) if lower_better else max(values)


def compare_metric(
    metric: str,
    prior: List[float],
    current: float,
    margins: Dict[str, float],
) -> Tuple[bool, str]:
    """(is_regression, human line) for one metric."""
    lower = _lower_better(metric)
    best = best_prior(prior, lower)
    margin = margins.get(metric, FALLBACK_MARGIN)
    if best == 0:
        delta_pct = 0.0 if current == 0 else float("inf")
    else:
        delta_pct = 100.0 * (current - best) / abs(best)
    worse = delta_pct > margin if lower else delta_pct < -margin
    arrow = "↓ better" if lower else "↑ better"
    verdict = "REGRESSION" if worse else "ok"
    return worse, (
        f"{metric:<32} best-prior {best:g}  current {current:g}  "
        f"delta {delta_pct:+.2f}% (margin {margin:g}%, {arrow}): {verdict}"
    )


def check_bench(
    prior_files: List[str],
    current_file: str,
    margins: Dict[str, float],
) -> Tuple[int, List[str]]:
    """Compare the candidate file's rows against every prior file.
    Returns (regression_count, report_lines); raises SchemaMismatch."""
    prior_by_metric: Dict[str, List[float]] = {}
    prior_step_ms: Dict[str, List[float]] = {}
    for path in prior_files:
        for row in load_rows(path):
            prior_by_metric.setdefault(row["metric"], []).append(
                float(row["value"])
            )
            if isinstance(row.get("step_time_ms"), (int, float)):
                prior_step_ms.setdefault(row["metric"], []).append(
                    float(row["step_time_ms"])
                )

    current_rows = load_rows(current_file)
    lines: List[str] = []
    regressions = 0
    compared = 0
    for row in current_rows:
        metric = row["metric"]
        if metric in prior_by_metric:
            compared += 1
            worse, line = compare_metric(
                metric, prior_by_metric[metric], float(row["value"]), margins
            )
            regressions += worse
            lines.append(line)
        # step_time_ms rides many throughput rows as an extra field and
        # regresses independently of the headline metric
        if metric in prior_step_ms and isinstance(
            row.get("step_time_ms"), (int, float)
        ):
            compared += 1
            worse, line = compare_metric(
                "step_time_ms",
                prior_step_ms[metric],
                float(row["step_time_ms"]),
                margins,
            )
            regressions += worse
            lines.append(f"[{metric}] {line}")
    if not compared:
        lines.append(
            "warning: no comparable metric rows between candidate and "
            "priors (unparsed/degraded artifacts?) — nothing to gate"
        )
    return regressions, lines


def check_compile_reports(
    baseline_path: str, current_path: str, margins: Dict[str, float]
) -> Tuple[int, List[str]]:
    """Gate per-function FLOPs and HBM footprints between two
    compile_report.json files; compile time is reported, never gated
    (cache hits make it meaningless across runs)."""
    with open(baseline_path) as f:
        base = json.load(f)
    with open(current_path) as f:
        cur = json.load(f)
    _check_schema(base, baseline_path)
    _check_schema(cur, current_path)
    lines: List[str] = []
    regressions = 0
    compared = 0
    for name, cur_fn in (cur.get("functions") or {}).items():
        base_fn = (base.get("functions") or {}).get(name)
        if not base_fn:
            continue
        pairs: List[Tuple[str, Optional[float], Optional[float]]] = [
            (
                "flops",
                (base_fn.get("cost") or {}).get("flops"),
                (cur_fn.get("cost") or {}).get("flops"),
            )
        ]
        for key in ("temp_bytes", "output_bytes", "argument_bytes"):
            pairs.append(
                (
                    key,
                    (base_fn.get("memory") or {}).get(key),
                    (cur_fn.get("memory") or {}).get(key),
                )
            )
        for key, b, c in pairs:
            if b is None or c is None:
                continue
            compared += 1
            worse, line = compare_metric(key, [float(b)], float(c), margins)
            regressions += worse
            lines.append(f"[{name}] {line}")
        b_s, c_s = base_fn.get("compile_seconds"), cur_fn.get("compile_seconds")
        if b_s is not None and c_s is not None:
            lines.append(
                f"[{name}] compile_seconds {b_s:g} -> {c_s:g} (informational)"
            )
    if not compared:
        lines.append(
            "warning: compile reports share no comparable functions/fields"
        )
    return regressions, lines


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sat_tpu_torch.tools.check_regression",
        description="BENCH/compile_report regression gate "
        "(exit 0 ok, 2 regression, 3 schema mismatch)"
    )
    ap.add_argument(
        "trajectory",
        nargs="*",
        help="bench artifacts in chronological order; the LAST is the candidate",
    )
    ap.add_argument("--baseline", help="explicit prior bench artifact")
    ap.add_argument("--current", help="explicit candidate bench artifact")
    ap.add_argument("--compile-baseline", help="prior compile_report.json")
    ap.add_argument("--compile-current", help="candidate compile_report.json")
    ap.add_argument(
        "--margin",
        action="append",
        default=[],
        metavar="METRIC=PCT",
        help="override a per-metric noise margin (repeatable)",
    )
    args = ap.parse_args(argv)

    margins = dict(DEFAULT_MARGINS)
    for spec in args.margin:
        name, _, pct = spec.partition("=")
        try:
            margins[name] = float(pct)
        except ValueError:
            ap.error(f"--margin {spec!r}: expected METRIC=PCT")

    # shells without glob expansion (CI yaml) pass the pattern literally
    files: List[str] = []
    for pattern in args.trajectory:
        matched = sorted(_glob.glob(pattern)) if any(
            ch in pattern for ch in "*?["
        ) else [pattern]
        files.extend(matched)

    jobs = 0
    regressions = 0
    candidate_errors: List[str] = []
    try:
        if args.baseline or args.current:
            if not (args.baseline and args.current):
                ap.error("--baseline and --current must be given together")
            jobs += 1
            n, lines = check_bench([args.baseline], args.current, margins)
            regressions += n
            candidate_errors.extend(load_errors(args.current))
            print("\n".join(lines))
        if len(files) >= 2:
            jobs += 1
            n, lines = check_bench(files[:-1], files[-1], margins)
            regressions += n
            candidate_errors.extend(load_errors(files[-1]))
            print("\n".join(lines))
        elif files:
            # a single artifact has nothing to regress against: validate
            # it (schema + parse) and pass
            jobs += 1
            rows = load_rows(files[0])
            candidate_errors.extend(load_errors(files[0]))
            print(
                f"{files[0]}: {len(rows)} row(s), no prior artifacts — "
                "nothing to gate"
            )
        if args.compile_baseline or args.compile_current:
            if not (args.compile_baseline and args.compile_current):
                ap.error(
                    "--compile-baseline and --compile-current must be "
                    "given together"
                )
            jobs += 1
            n, lines = check_compile_reports(
                args.compile_baseline, args.compile_current, margins
            )
            regressions += n
            print("\n".join(lines))
    except SchemaMismatch as e:
        print(f"check_regression: {e}", file=sys.stderr)
        return 3
    except (OSError, json.JSONDecodeError, KeyError, ValueError) as e:
        print(f"check_regression: bad artifact: {e}", file=sys.stderr)
        return 1

    if jobs == 0:
        ap.error("nothing to do: pass a trajectory, --baseline/--current, "
                 "or --compile-baseline/--compile-current")
    if regressions:
        # measured regressions outrank an infra-skip: numbers that DID
        # land and got worse must fail the gate even if a later attempt
        # in the same artifact hit the outage
        print(f"check_regression: {regressions} regression(s)", file=sys.stderr)
        return 2
    skips = sorted({e for e in candidate_errors if e in INFRA_SKIP_ERRORS})
    if skips:
        print(
            f"check_regression: infra-skip ({', '.join(skips)}) — the "
            "candidate artifact records an infrastructure outage, not a "
            "measurement; nothing was gated",
            file=sys.stderr,
        )
        return 3
    for e in sorted({e for e in candidate_errors if e not in INFRA_SKIP_ERRORS}):
        print(
            f"check_regression: warning: candidate carries error rows "
            f"({e}) — not a recognized infra-skip reason",
            file=sys.stderr,
        )
    print("check_regression: no regressions")
    return 0


if __name__ == "__main__":
    sys.exit(main())
