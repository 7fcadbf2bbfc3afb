"""Telemetry exporters — the port's copy of ``sat_tpu.telemetry.exporters``
less the step-time breakdown.

* :func:`export_chrome_trace` — trace-event JSON (``ph:"X"`` complete
  events, microsecond timestamps) loadable in Perfetto /
  ``chrome://tracing``, one track per recording thread; the serve
  phase's request lanes ride in through ``extra_events``;
* :func:`rotating_append` — the size-capped JSONL sink every serve log
  (``access.jsonl``, ``metering.jsonl``, ``slo.jsonl``) writes through,
  and :func:`append_jsonl` / :func:`snapshot_row` over it;
* ``export_attention_jsonl`` writes one record a captioned image
  (per-word alpha grids, entropy and coverage statistics);
  ``render_attention_sheet`` writes a self-contained HTML contact sheet
  of the same grids.  The sheet keeps the JAX package's title, so the two
  packages' sheets read alike.

Every writer degrades to a warning on failure: observability never kills
a run.  Trace documents name the process ``sat_tpu host``, as the JAX
package's do, so one reader merges both.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from ..utils.fileio import atomic_write
from . import process_identity, run_id


# ---------------------------------------------------------------------------
# Chrome trace-event JSON
# ---------------------------------------------------------------------------


def chrome_trace(
    tel,
    process_name: Optional[str] = None,
    extra_events: Optional[List[Dict]] = None,
    pid: Optional[int] = None,
) -> Dict:
    """The trace-event document for ``tel``'s retained span window.

    Timestamps are microseconds since the recorder's anchor; the absolute
    anchor (unix seconds) rides in ``otherData`` for post-hoc alignment
    with ``metrics.jsonl``'s wall-clock stamps.  ``extra_events`` are
    pre-built trace events appended verbatim — the request lanes from
    ``tracectx.RequestTracer.trace_events`` ride in through here.

    The trace ``pid`` defaults to the run's **process_index** (not the OS
    pid): per-host traces from one multi-host run then occupy distinct,
    stable lanes, and ``scripts/merge_traces.py`` can concatenate them
    into one Perfetto timeline with a lane per host.  The OS pid still
    rides in ``otherData``.
    """
    names, ids, t0s, durs, tids = tel.spans_snapshot()
    process_index, process_count = process_identity()
    if pid is None:
        pid = process_index
    if process_name is None:
        process_name = (
            f"sat_tpu host p{process_index}"
            if process_count > 1
            else "sat_tpu host"
        )
    events: List[Dict] = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": pid,
            "args": {"name": process_name},
        }
    ]
    anchor = tel.anchor_ns
    for k in range(len(ids)):
        events.append(
            {
                "name": names[int(ids[k])],
                "cat": "host",
                "ph": "X",
                "pid": pid,
                "tid": int(tids[k]),
                "ts": (int(t0s[k]) - anchor) / 1e3,
                "dur": int(durs[k]) / 1e3,
            }
        )
    if extra_events:
        events.extend(extra_events)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "run_id": run_id(),
            "anchor_unix": tel.anchor_unix,
            "os_pid": os.getpid(),
            "process_index": process_index,
            "process_count": process_count,
            "counters": tel.counters(),
            "gauges": tel.gauges(),
        },
    }


def export_chrome_trace(
    tel, path: str, extra_events: Optional[List[Dict]] = None
) -> Optional[str]:
    """Write the Perfetto-loadable trace JSON atomically; returns the path
    (None when the write failed — reported, never raised)."""
    try:
        doc = chrome_trace(tel, extra_events=extra_events)
        atomic_write(path, "w", lambda f: json.dump(doc, f))
        return path
    except (OSError, ValueError) as e:
        print(
            f"sat_tpu_torch: telemetry trace export failed ({path}): {e}",
            file=sys.stderr,
            flush=True,
        )
        return None


# ---------------------------------------------------------------------------
# periodic telemetry.jsonl
# ---------------------------------------------------------------------------


def snapshot_row(tel, step: Optional[int] = None) -> Dict:
    """One JSON-able snapshot of the recorder: counters, gauges, and
    per-span running (count, total ms, max ms) — same stamp fields as
    ``metrics.jsonl`` rows so the two join on (run_id, step/time)."""
    spans = {
        name: {
            "count": c,
            "total_ms": round(total / 1e6, 3),
            "max_ms": round(mx / 1e6, 3),
        }
        for name, (c, total, mx) in tel.aggregates().items()
    }
    row: Dict = {
        "run_id": run_id(),
        "wall_time": round(time.time(), 6),
        "mono_ns": time.perf_counter_ns(),
        "counters": tel.counters(),
        "gauges": tel.gauges(),
        "spans": spans,
    }
    if step is not None:
        row["step"] = int(step)
    return row


def rotating_append(
    path: str, line: str, cap_bytes: int = 0, tel=None
) -> bool:
    """Append one line to a size-capped JSONL file.

    When the file would grow past ``cap_bytes`` the current file rolls to
    ``<path>.1`` (single rollover — at most ``2 * cap_bytes`` on disk, the
    previous ``.1`` is dropped) and the append lands in a fresh file.
    ``cap_bytes <= 0`` disables rotation.  Failures degrade to a one-line
    warning (and the ``telemetry/export_errors`` counter when ``tel`` is
    given) — the shared sink for ``telemetry.jsonl`` / ``access.jsonl`` /
    ``slo.jsonl``, so none of them can fill a disk or kill a run.
    Returns True when the line landed."""
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        data = line if line.endswith("\n") else line + "\n"
        if cap_bytes > 0:
            try:
                size = os.path.getsize(path)
            except OSError:
                size = 0
            if size and size + len(data.encode("utf-8")) > cap_bytes:
                os.replace(path, path + ".1")
        with open(path, "a") as f:
            f.write(data)
        return True
    except (OSError, ValueError) as e:
        if tel is not None:
            tel.count("telemetry/export_errors")
        print(
            f"sat_tpu_torch: telemetry append failed ({path}): {e}",
            file=sys.stderr,
            flush=True,
        )
        return False


def append_jsonl(
    tel, path: str, step: Optional[int] = None, cap_bytes: int = 0
) -> None:
    """Append one snapshot row through the rotating sink; failures degrade
    to a one-line warning (tracked by ``telemetry/export_errors``)."""
    try:
        line = json.dumps(snapshot_row(tel, step))
    except (TypeError, ValueError) as e:
        tel.count("telemetry/export_errors")
        print(
            f"sat_tpu_torch: telemetry.jsonl append failed ({path}): {e}",
            file=sys.stderr,
            flush=True,
        )
        return
    rotating_append(path, line, cap_bytes, tel=tel)


# ---------------------------------------------------------------------------
# attention introspection: attn.jsonl + HTML contact sheet
# ---------------------------------------------------------------------------


def attention_record(row: Dict) -> Optional[Dict]:
    """One machine-readable attention record for a decoded caption.

    ``row`` is a decode_dataset result carrying ``words`` and beam-0
    ``alphas`` [len(words), N] (present when ``save_attention_maps`` is
    on).  Returns None for rows without alphas (mesh paths that dropped
    them, rows past the dedup).  Per-word entropy H_t = -Σ_i α_ti ln α_ti
    and the coverage deviation mean_i (1 - Σ_t α_ti)² are the decode-time
    twins of the JAX package's ``diag/attn_entropy`` /
    ``diag/alpha_coverage_dev`` train taps, so train and eval attention
    health read on one scale."""
    if "alphas" not in row or row.get("alphas") is None:
        return None
    alphas = np.asarray(row["alphas"], dtype=np.float32)   # [L, N]
    if alphas.ndim != 2 or alphas.shape[0] == 0:
        return None
    L, N = alphas.shape
    g = int(round(np.sqrt(N)))
    clipped = np.clip(alphas, 1e-10, 1.0)
    entropy = -np.sum(alphas * np.log(clipped), axis=-1)   # [L]
    coverage = alphas.sum(axis=0)                          # [N]
    dev = 1.0 - coverage
    return {
        "run_id": run_id(),
        "image_id": row.get("image_id"),
        "image_file": row.get("image_file"),
        "caption": row.get("caption"),
        "words": list(row.get("words", [])),
        "grid": g,
        "num_ctx": int(N),
        "entropy": [round(float(h), 4) for h in entropy],
        "entropy_mean": round(float(entropy.mean()), 4),
        "entropy_frac_mean": round(float(entropy.mean() / np.log(N)), 4),
        "coverage_dev": round(float(np.mean(dev * dev)), 5),
        "alpha_max": round(float(alphas.max()), 4),
        "alphas": [[round(float(a), 4) for a in word_row] for word_row in alphas],
    }


def export_attention_jsonl(results: List[Dict], path: str) -> int:
    """Write one attention record per captioned image; returns the count
    written (0 when no row carried alphas).  Failures degrade to a
    warning — artifact export never kills eval."""
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        n = 0
        with open(path, "w") as f:
            for row in results:
                rec = attention_record(row)
                if rec is None:
                    continue
                f.write(json.dumps(rec) + "\n")
                n += 1
        return n
    except (OSError, ValueError) as e:
        print(
            f"sat_tpu_torch: attn.jsonl export failed ({path}): {e}",
            file=sys.stderr,
            flush=True,
        )
        return 0


def render_attention_sheet(
    results: List[Dict], path: str, max_images: int = 16, cell_px: int = 5
) -> Optional[str]:
    """Self-contained HTML contact sheet of per-word alpha grids.

    One row per caption: each generated word gets a g×g heat grid (pure
    CSS cells, no image deps — renders anywhere, ships in one file) with
    its entropy underneath; a caption-level summary leads the row.  Cell
    intensity shares one scale per caption (alpha_max), the same
    no-per-tile-autoscaling rule as the cv2 panels — a near-uniform map
    must not fake the contrast of a peaked one."""
    recs = [r for r in map(attention_record, results) if r is not None]
    if not recs:
        return None
    shown = recs[:max_images]
    parts: List[str] = [
        "<!doctype html><html><head><meta charset='utf-8'>"
        "<title>sat_tpu attention contact sheet</title><style>"
        "body{font-family:sans-serif;background:#fafafa;margin:16px}"
        ".cap{background:#fff;border:1px solid #ddd;border-radius:6px;"
        "padding:10px;margin-bottom:14px}"
        ".meta{font-size:13px;color:#333;margin-bottom:6px}"
        ".tiles{display:flex;flex-wrap:wrap;gap:8px}"
        ".tile{text-align:center}"
        ".word{font-size:11px;max-width:90px;overflow:hidden;"
        "text-overflow:ellipsis;white-space:nowrap}"
        ".ent{font-size:10px;color:#777}"
        "table.g{border-collapse:collapse}"
        f"table.g td{{width:{cell_px}px;height:{cell_px}px;padding:0}}"
        "</style></head><body>",
        f"<h2>attention contact sheet — {len(recs)} captions"
        f"{' (showing ' + str(len(shown)) + ')' if len(shown) < len(recs) else ''}"
        f"</h2><div class='meta'>run {run_id()} — cell intensity is "
        "α scaled by the caption's max; H is per-word entropy "
        "(ln N = uniform)</div>",
    ]
    for rec in shown:
        g = rec["grid"]
        vmax = rec["alpha_max"] or 1.0
        parts.append(
            "<div class='cap'><div class='meta'>"
            f"<b>{rec.get('image_id')}</b> — “{rec.get('caption')}” "
            f"(H̄={rec['entropy_mean']:.2f}, "
            f"uniformity={rec['entropy_frac_mean']:.2f}, "
            f"coverage_dev={rec['coverage_dev']:.4f})</div><div class='tiles'>"
        )
        for word, ent, word_alphas in zip(
            rec["words"], rec["entropy"], rec["alphas"]
        ):
            rows_html = []
            for r in range(g):
                cells = "".join(
                    f"<td style='background:rgba(185,28,28,"
                    f"{min(1.0, word_alphas[r * g + c] / vmax):.2f})'></td>"
                    for c in range(g)
                )
                rows_html.append(f"<tr>{cells}</tr>")
            parts.append(
                f"<div class='tile'><table class='g'>{''.join(rows_html)}"
                f"</table><div class='word'>{word}</div>"
                f"<div class='ent'>H={ent:.2f}</div></div>"
            )
        parts.append("</div></div>")
    parts.append("</body></html>")
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        atomic_write(path, "w", lambda f: f.write("".join(parts)))
        return path
    except (OSError, ValueError) as e:
        print(
            f"sat_tpu_torch: attention sheet export failed ({path}): {e}",
            file=sys.stderr,
            flush=True,
        )
        return None
