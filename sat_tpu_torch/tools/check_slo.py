"""CI gate over SLO alert logs (``slo.jsonl`` from telemetry/slo.py).

The port of ``scripts/check_slo.py``, over the port's SLO logs (the same
record format and schema version).  Like every tool here it asks for the
card unless ``SAT_TORCH_DEVICE=cpu`` asks for the CPU, though the gate
itself is host JSON work.

The SLO engine appends one record per ok↔burning transition.  This
script turns that log into exit codes the same way ``check_regression.py``
gates BENCH rows: point it at one or more ``slo.jsonl`` files (a chaos
campaign's, a serve soak's, a training run's) and it fails CI when an
objective is burning.

Usage::

    python -m sat_tpu_torch.tools.check_slo <slo.jsonl> [more.jsonl ...] [--strict]

Default policy: an objective whose LAST transition is ``burning`` (it
never recovered before the run ended) fails the gate.  ``--strict``
fails on ANY burning transition, recovered or not — for runs that are
supposed to stay inside objective the whole time.

Schema compatibility: records stamped with a ``schema_version`` other
than this repo's ``sat_tpu_torch.telemetry.SCHEMA_VERSION`` are refused — a
changed contract must bump the version, not silently reinterpret logs.
Torn trailing lines (a run killed mid-append) are tolerated and skipped,
matching every other JSONL reader in the repo.

Exit codes: 0 = all objectives ended (and under ``--strict`` stayed)
ok, 2 = burning objective, 3 = incompatible schema, 1 = usage/IO error.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

from ..telemetry import SCHEMA_VERSION


def load_records(path: str) -> List[Dict]:
    """Parse one slo.jsonl tolerantly: torn/garbage lines are skipped
    (counted to stderr), schema mismatches raise to the exit-3 path."""
    records: List[Dict] = []
    torn = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                torn += 1
                continue
            if not isinstance(rec, dict) or "name" not in rec:
                torn += 1
                continue
            v = rec.get("schema_version")
            if v is not None and v != SCHEMA_VERSION:
                raise SystemExit3(
                    f"{path}: schema_version={v} is incompatible with this "
                    f"repo's {SCHEMA_VERSION}; regenerate the log"
                )
            records.append(rec)
    if torn:
        print(
            f"check_slo: {path}: skipped {torn} unparsable line(s)",
            file=sys.stderr,
        )
    return records


class SystemExit3(Exception):
    """Schema refusal (exit 3), distinct from usage/IO errors (exit 1)."""


def evaluate(records: List[Dict], strict: bool) -> List[str]:
    """Names of objectives that fail the gate under the chosen policy."""
    last: Dict[str, Dict] = {}
    ever_burned: Dict[str, Dict] = {}
    for rec in records:
        last[rec["name"]] = rec
        if rec.get("event") == "burning":
            ever_burned[rec["name"]] = rec
    if strict:
        return sorted(ever_burned)
    return sorted(
        name for name, rec in last.items() if rec.get("event") == "burning"
    )


def _describe(rec: Dict) -> str:
    t = rec.get("target")
    m = rec.get("measured_fast")
    return (
        f"{rec.get('name')} [{rec.get('kind')}]: event={rec.get('event')} "
        f"measured={m} target={t} burn_fast={rec.get('burn_fast')} "
        f"burn_slow={rec.get('burn_slow')}"
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sat_tpu_torch.tools.check_slo",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("logs", nargs="+", help="slo.jsonl file(s) to gate")
    ap.add_argument(
        "--strict",
        action="store_true",
        help="fail on any burning transition, even if it later recovered",
    )
    args = ap.parse_args(argv)
    from ..device import resolve_device

    resolve_device()

    failed: List[str] = []
    total = 0
    try:
        for path in args.logs:
            records = load_records(path)
            total += len(records)
            for rec in records:
                print(f"check_slo: {path}: {_describe(rec)}")
            bad = evaluate(records, args.strict)
            failed.extend(f"{path}:{name}" for name in bad)
    except SystemExit3 as e:
        print(f"check_slo: REFUSED — {e}", file=sys.stderr)
        return 3
    except OSError as e:
        print(f"check_slo: cannot read log: {e}", file=sys.stderr)
        return 1

    if not total:
        # no transitions at all = nothing ever burned: a clean run's
        # slo.jsonl is empty or absent-but-named, and that passes
        print("check_slo: no transitions recorded — all objectives ok")
        return 0
    if failed:
        mode = "burned at least once" if args.strict else "ended burning"
        print(
            f"check_slo: FAIL — {len(failed)} objective(s) {mode}: "
            + ", ".join(failed),
            file=sys.stderr,
        )
        return 2
    print("check_slo: PASS — every objective ended ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
