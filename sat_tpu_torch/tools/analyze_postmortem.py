"""One-command summarizer for black-box postmortem bundles.

The port's own copy of ``scripts/analyze_postmortem.py``, with its flags,
its ``--json`` summary and its exit codes.  ``telemetry/blackbox.py``
drops a ``postmortem_<run_id>/`` directory on every abnormal exit path
(watchdog 86, data-corruption 87, sentinel trip, uncaught exception,
SIGTERM mid-checkpoint).  This tool turns that directory back into an
incident narrative: what the run was doing (span tail + journal
timeline), what it looked like (final counters and gauges, fleet view),
and a probable cause keyed on the exit code and the last recorded phase
— the part a paged human wants first.

Usage::

    python -m sat_tpu_torch.tools.analyze_postmortem <bundle-or-telemetry-dir> [--json]
    python -m sat_tpu_torch.tools.analyze_postmortem run/telemetry   # newest bundle

``--json`` emits a machine-readable summary (CI and the chaos campaign
assert on ``probable_cause`` / ``wedged_phase``).  Exit codes: 0 =
summarized, 1 = no bundle found / unreadable.  Reads files only: it
imports neither torch nor the rest of the port.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Optional

WATCHDOG_RC = 86
CORRUPTION_RC = 87


def _find_bundle(path: str) -> Optional[str]:
    """``path`` itself when it holds a manifest, else the newest
    ``postmortem_*`` directory below it."""
    if os.path.isfile(os.path.join(path, "manifest.json")):
        return path
    candidates = sorted(
        glob.glob(os.path.join(path, "postmortem_*")),
        key=lambda p: os.path.getmtime(p) if os.path.isdir(p) else 0,
    )
    return candidates[-1] if candidates else None


def _read_json(bundle: str, name: str):
    try:
        with open(os.path.join(bundle, name)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _read_jsonl(path: str) -> List[Dict]:
    out: List[Dict] = []
    try:
        with open(path) as f:
            for line in f:
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue  # torn line — expected at the crash edge
    except OSError:
        pass
    return out


def _ring_records(bundle: str) -> List[Dict]:
    records: List[Dict] = []
    for seg in sorted(glob.glob(os.path.join(bundle, "blackbox", "seg_*.jsonl"))):
        records.extend(_read_jsonl(seg))
    records.sort(key=lambda r: r.get("t", 0))
    return records


def probable_cause(manifest: Dict, bundle: str) -> Dict:
    """The heuristics: exit code first, then reason, then the last phase
    the span tail recorded.  Returns the machine summary dict."""
    reason = manifest.get("reason", "unknown")
    rc = manifest.get("exit_code")
    wedged = manifest.get("phase") or manifest.get("last_phase")
    out: Dict = {
        "reason": reason,
        "exit_code": rc,
        "last_phase": manifest.get("last_phase"),
        "wedged_phase": None,
        "probable_cause": f"abnormal exit ({reason})",
        "evidence": [],
    }
    if rc == WATCHDOG_RC or reason == "watchdog_wedge":
        out["wedged_phase"] = wedged
        over = manifest.get("overdue_s")
        out["probable_cause"] = (
            f"run wedged in phase '{wedged}'"
            + (f" ({over}s past its deadline)" if over is not None else "")
            + " — the watchdog aborted it (exit 86)"
        )
        if os.path.isfile(os.path.join(bundle, "watchdog_stacks.txt")):
            out["evidence"].append(
                "watchdog_stacks.txt holds the all-thread stacks at dump time"
            )
    elif rc == CORRUPTION_RC or reason == "systemic_corruption":
        rows = _read_jsonl(os.path.join(bundle, "quarantine.jsonl"))
        shards = sorted({r.get("shard", "?") for r in rows if isinstance(r, dict)})
        out["probable_cause"] = (
            "systemic input-data corruption — the quarantine ceiling "
            "tripped (exit 87); restarting will NOT help, repair the data"
        )
        if rows:
            out["evidence"].append(
                f"quarantine.jsonl tail: {len(rows)} records, shards {shards[:5]}"
            )
    elif reason == "anomaly_rollback":
        out["probable_cause"] = (
            "non-finite/spiking metrics tripped the anomaly sentinel "
            f"at step {manifest.get('step')} — training rolled back to "
            "LAST_GOOD"
        )
        if manifest.get("reason_detail") or manifest.get("reason"):
            out["evidence"].append(f"sentinel: {manifest.get('reason')}")
    elif reason == "sigterm_during_checkpoint":
        final = manifest.get("final_checkpoint") or ""
        out["probable_cause"] = (
            f"{manifest.get('signal', 'SIGTERM')} during the final "
            "checkpoint window — "
            + (
                f"the final write landed ({final})"
                if final
                else "no final checkpoint path was recorded"
            )
        )
    elif reason == "uncaught_exception":
        out["probable_cause"] = (
            f"uncaught exception: {manifest.get('error', '<unrecorded>')}"
        )
    elif reason in ("checkpoint_write_failed", "simulated_preemption"):
        out["probable_cause"] = (
            f"{reason.replace('_', ' ')}: {manifest.get('error', '')}".strip()
        )
    fleet = _read_json(bundle, "fleet.json")
    if fleet:
        verdict = fleet.get("straggler") or {}
        if verdict.get("verdict"):
            out["straggler"] = {
                "process_index": verdict.get("process_index"),
                "host": verdict.get("host"),
                "skew": verdict.get("skew"),
            }
            out["evidence"].append(
                f"fleet.json names p{verdict.get('process_index')} "
                f"({verdict.get('host')}) as a straggler "
                f"({verdict.get('skew')}x the fleet median)"
            )
    flooder = _flooding_tenant(_read_json(bundle, "state.json") or {})
    if flooder:
        out["flooding_tenant"] = flooder["tenant"]
        out["evidence"].append(
            f"tenant {flooder['tenant']!r} dominates the shed counters: "
            f"{flooder['shed']} shed of {flooder['requests']} requests "
            f"({flooder['shed_share']:.0%} of all tenant sheds) — "
            "probable flooding tenant"
        )
    return out


def _flooding_tenant(state: Dict) -> Optional[Dict]:
    """Name the tenant behind an overload from the per-tenant counters
    the multi-tenant serve/route planes emit (``serve/tenant_<t>_shed``
    etc.).  Returns the tenant holding the majority of tenant-scoped
    sheds, or None when the run was single-tenant / nothing shed."""
    counters = state.get("counters") or {}
    shed: Dict[str, int] = {}
    requests: Dict[str, int] = {}
    for key, value in counters.items():
        for prefix in ("serve/tenant_", "route/tenant_"):
            if not key.startswith(prefix):
                continue
            rest = key[len(prefix):]
            name, _, kind = rest.rpartition("_")
            if not name or name == "unknown":
                continue
            if kind == "shed":
                shed[name] = shed.get(name, 0) + int(value)
            elif kind == "requests":
                requests[name] = requests.get(name, 0) + int(value)
    total_shed = sum(shed.values())
    if total_shed <= 0:
        return None
    worst = max(shed, key=shed.get)
    share = shed[worst] / total_shed
    if share < 0.5:
        return None  # no single tenant dominates — not a flood story
    return {
        "tenant": worst,
        "shed": shed[worst],
        "requests": requests.get(worst, 0),
        "shed_share": share,
    }


def _fmt_ts(t: float, base: float) -> str:
    return f"t+{t - base:8.3f}s"


def summarize(bundle: str) -> Dict:
    manifest = _read_json(bundle, "manifest.json") or {}
    summary = probable_cause(manifest, bundle)
    summary["bundle"] = bundle
    summary["run_id"] = manifest.get("run_id")
    summary["time_unix"] = manifest.get("time_unix")
    return summary


def print_report(bundle: str, summary: Dict) -> None:
    manifest = _read_json(bundle, "manifest.json") or {}
    print(f"postmortem bundle: {bundle}")
    print(
        f"  run {manifest.get('run_id')} — reason={summary['reason']} "
        f"exit_code={summary['exit_code']}"
    )
    print(f"\nPROBABLE CAUSE: {summary['probable_cause']}")
    for ev in summary.get("evidence", []):
        print(f"  * {ev}")

    records = _ring_records(bundle)
    events = [r for r in records if r.get("kind") == "event"]
    if records:
        base = records[0].get("t", 0.0)
        print(f"\ntimeline (black-box ring, {len(records)} records):")
        shown = events[-12:] if events else records[-12:]
        skip = ("t", "mono_ns", "kind", "event", "counters", "gauges")
        for r in shown:
            desc = r.get("event", r.get("kind", "?"))
            detail = " ".join(
                f"{k}={v}" for k, v in r.items() if k not in skip
            )
            print(f"  {_fmt_ts(r.get('t', base), base)}  {desc}  {detail}")
        journals = [r for r in records if r.get("kind") == "snapshot"]
        if journals:
            print(
                f"  last journal: step={journals[-1].get('step')} "
                f"(of {len(journals)} snapshots retained)"
            )

    spans = _read_json(bundle, "spans_tail.json") or []
    if spans:
        print(f"\nfinal {manifest.get('span_tail_s', 30)}s of host spans "
              f"({len(spans)} spans, most recent last):")
        for s in spans[-10:]:
            print(
                f"  {s.get('name', '?'):24s} {s.get('dur_ms', 0):10.3f} ms"
            )

    state = _read_json(bundle, "state.json") or {}
    gauges = state.get("gauges", {})
    if gauges:
        interesting = {
            k: v
            for k, v in sorted(gauges.items())
            if k.split("/")[0]
            in ("train", "fleet", "watchdog", "data", "slo", "supervisor",
                "serve", "route")
        }
        if interesting:
            print("\nfinal gauges:")
            for k, v in list(interesting.items())[:20]:
                print(f"  {k} = {v}")

    present = sorted(os.listdir(bundle))
    print(f"\nbundle contents: {', '.join(present)}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sat_tpu_torch.tools.analyze_postmortem",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("path", help="bundle dir, or a telemetry dir to search")
    ap.add_argument(
        "--json",
        action="store_true",
        help="machine-readable summary on stdout (CI asserts on this)",
    )
    args = ap.parse_args(argv)

    bundle = _find_bundle(args.path)
    if bundle is None:
        print(
            f"analyze_postmortem: no postmortem_* bundle under {args.path}",
            file=sys.stderr,
        )
        return 1
    summary = summarize(bundle)
    if args.json:
        print(json.dumps(summary, indent=1, sort_keys=True))
    else:
        print_report(bundle, summary)
    return 0


if __name__ == "__main__":
    sys.exit(main())
