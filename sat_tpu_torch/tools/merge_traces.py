"""Merge per-process Chrome traces into one Perfetto timeline.

The port of ``scripts/merge_traces.py``, over the port's trace exports
(the same Chrome trace format and ``otherData`` fields).  Like every tool
here it asks for the card unless ``SAT_TORCH_DEVICE=cpu`` asks for the
CPU, though the merge itself is host JSON work.

Every process of a multi-host run exports its own ``trace.json`` (the
``_telemetry_finish`` epilogue) with the trace ``pid`` set to the run's
``process_index`` — distinct, stable lanes.  Timestamps inside each file
are microseconds since THAT process's recorder anchor, so the files
cannot be naively concatenated: each process enabled telemetry at a
slightly different wall-clock instant.  ``otherData.anchor_unix``
records the absolute anchor, and this script shifts every event by
``(anchor_unix - min_anchor) * 1e6`` so all lanes share the earliest
process's timebase — skew between hosts is then *visible* in the merged
view instead of silently collapsed.

Usage::

    python -m sat_tpu_torch.tools.merge_traces run/p0/telemetry/trace.json \
        run/p1/telemetry/trace.json --out merged_trace.json

Lanes: each input keeps its own pid (process_index); a
``process_name`` metadata event per lane labels it ``sat_tpu host pN``
(inputs that already carry process_name metadata keep theirs).  Inputs
missing ``anchor_unix`` merge unshifted with a warning — still useful
for single-host request-lane merges.

Exit codes: 0 = merged, 1 = usage/IO error, 2 = no events merged.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

from ..utils.fileio import atomic_write


def _load(path: str) -> Dict:
    with open(path, "r") as f:
        return json.load(f)


def merge(docs: List[Dict]) -> Dict:
    """Pure merge of parsed trace documents (tested directly)."""
    anchors = [
        d.get("otherData", {}).get("anchor_unix") for d in docs
    ]
    known = [a for a in anchors if a is not None]
    base = min(known) if known else 0.0
    events: List[Dict] = []
    hosts: List[Dict] = []
    seen_names = set()
    for doc, anchor in zip(docs, anchors):
        other = doc.get("otherData", {})
        pidx = other.get("process_index", other.get("os_pid", 0))
        shift_us = ((anchor - base) * 1e6) if anchor is not None else 0.0
        if anchor is None:
            print(
                f"merge_traces: input for p{pidx} has no anchor_unix — "
                "merging unshifted",
                file=sys.stderr,
            )
        lane_pids = set()
        for ev in doc.get("traceEvents", []):
            ev = dict(ev)
            if "ts" in ev:
                ev["ts"] = ev["ts"] + shift_us
            lane_pids.add(ev.get("pid"))
            if ev.get("name") == "process_name":
                seen_names.add(ev.get("pid"))
            events.append(ev)
        for pid in sorted(p for p in lane_pids if p is not None):
            if pid not in seen_names:
                seen_names.add(pid)
                events.append(
                    {
                        "name": "process_name",
                        "ph": "M",
                        "pid": pid,
                        "args": {"name": f"sat_tpu host p{pid}"},
                    }
                )
        hosts.append(
            {
                "process_index": pidx,
                "anchor_unix": anchor,
                "shift_us": round(shift_us, 1),
                "events": len(doc.get("traceEvents", [])),
                "run_id": other.get("run_id"),
            }
        )
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"merged_from": hosts, "anchor_unix": base},
    }


def main(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(prog="python -m sat_tpu_torch.tools.merge_traces",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("traces", nargs="+", help="per-process trace.json files")
    ap.add_argument("--out", default="merged_trace.json")
    args = ap.parse_args(argv)
    from ..device import resolve_device

    resolve_device()

    docs = []
    for path in args.traces:
        try:
            docs.append(_load(path))
        except (OSError, ValueError) as e:
            print(f"merge_traces: cannot read {path}: {e}", file=sys.stderr)
            return 1
    merged = merge(docs)
    if not merged["traceEvents"]:
        print("merge_traces: no events in any input", file=sys.stderr)
        return 2
    atomic_write(args.out, "w", lambda f: json.dump(merged, f))
    lanes = sorted(
        {h["process_index"] for h in merged["otherData"]["merged_from"]}
    )
    print(
        f"merge_traces: {len(merged['traceEvents'])} events from "
        f"{len(docs)} trace(s) -> {args.out} (lanes: {lanes}) — open in "
        "https://ui.perfetto.dev"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
