"""Fleet telemetry — the port of ``sat_tpu.telemetry.fleet``: the
cross-process aggregation of a parallel run and the straggler rule.

* **Sidecars** — each rank atomically rewrites a small
  ``heartbeat_p<process_index>.json`` in a directory the ranks share
  (``Config.fleet_dir``; by default the run's telemetry directory above
  the ranks' own): the ~6 scalars of :data:`FLEET_SCALARS` (step-time
  p50/p95, data wait, dispatch, rss, quarantined count) and identity.
* **Aggregation** — at the log boundary rank 0 merges one row a rank
  into ``fleet.json`` (rows, skew ratios, a straggler verdict naming the
  worst rank when its step-time p95 exceeds the median by
  ``straggler_factor``), ``fleet_history.jsonl`` and ``fleet/*`` gauges.
  The rows come from one small gather the runtime injects (``gather_fn``,
  ~6 float64s a rank over the CPU gloo group) or, without one, from the
  sidecar files.

The serve router's fleet view names its slow replica with the same
:func:`straggler_verdict`.  Torn sidecars are skipped and counted
(``fleet/torn_sidecars``); a fleet-plane failure costs a warning, never
the run.  The module imports no torch.
"""

from __future__ import annotations

import collections
import glob
import json
import os
import re
import socket
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ..utils.fileio import atomic_write
from . import SCHEMA_VERSION, run_id
from .heartbeat import _rss_bytes


def straggler_verdict(named_values: Dict[str, float], factor: float) -> Dict:
    """The fleet straggler rule, as a pure decision both planes share.

    Train side: per-host step-time p95s; serve side: the router's fleet
    view feeds per-replica request p99s.  With >= 2 reporters and a
    positive median, the worst reporter is named a straggler when its
    value STRICTLY exceeds ``median * factor`` — equality is "keeping
    up".  Returns ``{"verdict": bool, ...}`` with ``name``/``value``/
    ``median``/``skew`` when at least one reporter supplied a value."""
    if not named_values:
        return {"verdict": False}
    worst_name = max(named_values, key=lambda k: named_values[k])
    worst = float(named_values[worst_name])
    median = float(np.median(list(named_values.values())))
    return {
        "verdict": (
            len(named_values) >= 2 and median > 0 and worst > median * factor
        ),
        "name": worst_name,
        "value": round(worst, 4),
        "median": round(median, 4),
        "skew": round(worst / median, 4) if median > 0 else 0.0,
    }


# The all-gathered row, in wire order.  Adding a scalar appends here (old
# aggregators ignore trailing extras); changing a meaning bumps
# SCHEMA_VERSION.
FLEET_SCALARS = (
    "step_p50_ms",
    "step_p95_ms",
    "data_wait_ms",
    "dispatch_ms",
    "rss_mb",
    "quarantined",
)

_SIDECAR_RE = re.compile(r"heartbeat_p(\d+)\.json$")


def sidecar_path(fleet_dir: str, process_index: int) -> str:
    return os.path.join(fleet_dir, f"heartbeat_p{int(process_index)}.json")


def _atomic_json(path: str, doc) -> None:
    """Hot-path atomic JSON rewrite: fixed per-pid tmp name + replace.
    Fleet files have exactly one writer per process, so a fixed tmp name
    is race-free and the ``os.replace`` keeps readers torn-proof."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(json.dumps(doc))
    os.replace(tmp, path)


def _span_percentiles_ms(tel, name: str) -> tuple:
    """(p50, p95) of a span's ring window in ms; (0, 0) when unrecorded."""
    samples = tel.durations_ns(name)
    if len(samples) == 0:
        return 0.0, 0.0
    p50, p95 = np.percentile(samples, (50, 95))
    return float(p50) / 1e6, float(p95) / 1e6


def _span_mean_ms(tel, name: str) -> float:
    agg = tel.aggregates().get(name)
    if not agg or agg[0] == 0:
        return 0.0
    count, total_ns, _ = agg
    return float(total_ns) / count / 1e6


def read_sidecars(fleet_dir: str, tel=None) -> List[Dict]:
    """Every parseable sidecar in ``fleet_dir``, sorted by process_index.

    Torn/partial/garbage files are skipped (counted on ``tel`` when
    given); a sidecar whose filename index disagrees with its payload
    keeps the payload's claim — the filename only routes discovery."""
    rows: List[Dict] = []
    for path in sorted(glob.glob(os.path.join(fleet_dir, "heartbeat_p*.json"))):
        m = _SIDECAR_RE.search(path)
        if not m:
            continue
        try:
            with open(path) as f:
                row = json.load(f)
            if not isinstance(row, dict):
                raise ValueError("sidecar is not a JSON object")
        except (OSError, ValueError) as e:
            if tel is not None:
                tel.count("fleet/torn_sidecars")
            print(
                f"sat_tpu_torch: fleet sidecar unreadable, skipping ({path}): {e}",
                file=sys.stderr,
                flush=True,
            )
            continue
        row.setdefault("process_index", int(m.group(1)))
        rows.append(row)
    rows.sort(key=lambda r: int(r.get("process_index", 0)))
    return rows


def aggregate_rows(
    rows: List[Dict],
    straggler_factor: float,
    process_count: Optional[int] = None,
) -> Dict:
    """Merge per-host sidecar rows into the fleet.json document.

    Pure (no IO, no clock beyond the stamp): the unit tests drive every
    straggler edge case through here.  The verdict rule: with >= 2 hosts
    reporting and a positive fleet median, the worst host is named a
    straggler when its ``step_p95_ms`` STRICTLY exceeds
    ``median * straggler_factor`` — equality is "keeping up"."""
    hosts: List[Dict] = []
    for row in rows:
        entry = {
            "process_index": int(row.get("process_index", 0)),
            "host": row.get("host", f"p{row.get('process_index', 0)}"),
            "pid": row.get("pid"),
            "step": row.get("step"),
            "time_unix": row.get("time_unix"),
            "run_id": row.get("run_id"),
        }
        for key in FLEET_SCALARS:
            v = row.get(key, 0.0)
            try:
                entry[key] = float(v)
            except (TypeError, ValueError):
                entry[key] = 0.0
        hosts.append(entry)
    hosts.sort(key=lambda h: h["process_index"])

    doc: Dict = {
        "schema_version": SCHEMA_VERSION,
        "run_id": run_id(),
        "time_unix": round(time.time(), 3),
        "process_count": (
            int(process_count) if process_count else len(hosts)
        ),
        "hosts_reporting": len(hosts),
        "straggler_factor": float(straggler_factor),
        "hosts": hosts,
    }
    summary: Dict = {}
    if hosts:
        for key in FLEET_SCALARS:
            vals = [h[key] for h in hosts]
            summary[f"{key}_median"] = round(float(np.median(vals)), 4)
            summary[f"{key}_max"] = round(max(vals), 4)
        # keys are list positions, not process indices: a duplicate
        # sidecar index must not collapse two hosts into one dict slot
        ruling = straggler_verdict(
            {str(i): h["step_p95_ms"] for i, h in enumerate(hosts)},
            straggler_factor,
        )
        median = ruling["median"]
        worst = hosts[int(ruling["name"])]
        skew = ruling["skew"]
        summary["step_p95_skew"] = skew
        for h in hosts:
            h["skew"] = round(h["step_p95_ms"] / median, 4) if median > 0 else 0.0
        if ruling["verdict"]:
            doc["straggler"] = {
                "verdict": True,
                "process_index": worst["process_index"],
                "host": worst["host"],
                "step_p95_ms": round(worst["step_p95_ms"], 4),
                "fleet_median_ms": round(median, 4),
                "skew": round(skew, 4),
                "factor": float(straggler_factor),
                "reason": (
                    f"host {worst['host']} (p{worst['process_index']}) "
                    f"step p95 {worst['step_p95_ms']:.1f} ms exceeds "
                    f"fleet median {median:.1f} ms x {straggler_factor:g}"
                ),
            }
        else:
            doc["straggler"] = {"verdict": False}
    doc["fleet"] = summary
    return doc


def aggregate_directory(
    fleet_dir: str,
    straggler_factor: float,
    process_count: Optional[int] = None,
    tel=None,
    write: bool = True,
) -> Optional[Dict]:
    """File-based merge: read every sidecar under ``fleet_dir``, build the
    fleet document, and (by default) atomically write ``fleet.json`` next
    to the sidecars.  Standalone — usable after the run or from tools
    with no recorder."""
    rows = read_sidecars(fleet_dir, tel=tel)
    if not rows:
        return None
    doc = aggregate_rows(rows, straggler_factor, process_count=process_count)
    if write:
        try:
            atomic_write(
                os.path.join(fleet_dir, "fleet.json"),
                "w",
                lambda f: json.dump(doc, f, indent=1),
            )
        except OSError as e:
            print(
                f"sat_tpu_torch: fleet.json write failed ({fleet_dir}): {e}",
                file=sys.stderr,
                flush=True,
            )
    return doc


class FleetPlane:
    """Per-process fleet participant: sidecar writer + (on process 0)
    the aggregator.

    ``tick(step, gather_fn=...)`` runs at the log boundary on every
    process: write the local sidecar, then on process 0 merge the fleet
    view — from ``gather_fn`` rows when the runtime injected a collective
    transport, else from the sidecar files — into ``fleet.json``,
    ``fleet_history.jsonl`` (bounded, the black box copies its tail into
    postmortem bundles), and ``fleet/*`` gauges.  ``finish()`` repeats a
    file-based tick so the artifacts record the terminal step even when
    the run dies between boundaries; it must never gather (processes are
    desynchronized during teardown)."""

    def __init__(
        self,
        fleet_dir: str,
        process_index: int,
        process_count: int,
        tel,
        straggler_factor: float = 2.0,
        history_cap_bytes: int = 1 << 20,
        host: Optional[str] = None,
    ) -> None:
        self.fleet_dir = fleet_dir
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.straggler_factor = float(straggler_factor)
        self.history_cap_bytes = int(history_cap_bytes)
        self._tel = tel
        self._host = host or socket.gethostname()
        self._warned = False
        self._last_step: Optional[int] = None
        # the rank's own step times (ns) on a mesh, noted by the train loop
        self._own_ns: collections.deque = collections.deque(maxlen=4096)
        # a fleet_dir named for this run may not exist yet; a failure here
        # degrades at the first sidecar write, as any write failure does
        try:
            os.makedirs(fleet_dir, exist_ok=True)
        except OSError:
            pass

    # -- local side --------------------------------------------------------

    def note_step(self, own_ns: int) -> None:
        """One step's own time on a mesh: its wall time less the time it
        spent blocked in collectives.  The ranks' collectives block every
        one of them until the slowest arrives, so their ``train/step``
        spans are equal and cannot name a straggler; once steps are noted,
        the sidecar's ``step_p50_ms``/``step_p95_ms`` come from these."""
        self._own_ns.append(int(own_ns))

    def local_row(self, step: Optional[int] = None) -> Dict:
        """The sidecar payload: FLEET_SCALARS plus identity."""
        tel = self._tel
        if self._own_ns:
            p50, p95 = (float(v) / 1e6 for v in np.percentile(np.asarray(self._own_ns), (50, 95)))
        else:
            p50, p95 = _span_percentiles_ms(tel, "train/step")
        quarantined = tel.gauges().get(
            "data/quarantined_total", tel.counters().get("data/quarantined", 0)
        )
        return {
            "schema_version": SCHEMA_VERSION,
            "run_id": run_id(),
            "process_index": self.process_index,
            "process_count": self.process_count,
            "host": self._host,
            "pid": os.getpid(),
            "time_unix": round(time.time(), 3),
            "step": int(step) if step is not None else None,
            "step_p50_ms": round(p50, 4),
            "step_p95_ms": round(p95, 4),
            "data_wait_ms": round(_span_mean_ms(tel, "train/data_wait"), 4),
            "dispatch_ms": round(_span_mean_ms(tel, "train/dispatch"), 4),
            "rss_mb": round(_rss_bytes() / (1 << 20), 1),
            "quarantined": float(quarantined or 0),
        }

    def write_sidecar(self, step: Optional[int] = None) -> Optional[Dict]:
        row = self.local_row(step)
        try:
            _atomic_json(
                sidecar_path(self.fleet_dir, self.process_index), row
            )
        except OSError as e:
            self._warn(f"sidecar write failed: {e}")
            return None
        return row

    # -- aggregation -------------------------------------------------------

    def tick(
        self,
        step: int,
        gather_fn: Optional[Callable] = None,
    ) -> Optional[Dict]:
        """One log-boundary pass; returns the fleet doc on process 0."""
        self._last_step = int(step)
        row = self.write_sidecar(step)
        rows: Optional[List[Dict]] = None
        if gather_fn is not None and row is not None:
            # the collective transport: ~6 float64s per host, injected by
            # the runtime (this module never imports torch).  ALL processes
            # must make the call; only process 0 uses the result.
            vec = np.array(
                [row[k] for k in FLEET_SCALARS], dtype=np.float64
            )
            try:
                mat = gather_fn(vec)
            except Exception as e:
                self._warn(f"fleet gather failed, falling back to sidecars: {e}")
                mat = None
            if mat is not None and self.process_index == 0:
                sidecars = {
                    int(r.get("process_index", -1)): r
                    for r in read_sidecars(self.fleet_dir, tel=self._tel)
                }
                rows = []
                for p in range(len(mat)):
                    peer = dict(sidecars.get(p, {}))
                    peer["process_index"] = p
                    peer.setdefault("host", f"p{p}")
                    for k, v in zip(FLEET_SCALARS, mat[p]):
                        peer[k] = float(v)
                    rows.append(peer)
        if self.process_index != 0:
            return None
        if rows is None:
            rows = read_sidecars(self.fleet_dir, tel=self._tel)
        if not rows:
            return None
        doc = aggregate_rows(
            rows, self.straggler_factor, process_count=self.process_count
        )
        self._publish(doc)
        return doc

    def finish(self) -> Optional[Dict]:
        """Terminal file-based tick (never collective — see class doc)."""
        try:
            return self.tick(self._last_step or 0, gather_fn=None)
        except Exception as e:  # observability never takes the run down
            self._warn(f"final fleet aggregate failed: {e}")
            return None

    def _publish(self, doc: Dict) -> None:
        tel = self._tel
        tel.gauge("fleet/hosts_reporting", doc["hosts_reporting"])
        summary = doc.get("fleet", {})
        if "step_p95_skew" in summary:
            tel.gauge("fleet/step_p95_skew", summary["step_p95_skew"])
            tel.gauge("fleet/step_p95_ms_max", summary["step_p95_ms_max"])
            tel.gauge("fleet/step_p95_ms_median", summary["step_p95_ms_median"])
            tel.gauge("fleet/quarantined_total", summary["quarantined_max"])
        straggler = doc.get("straggler", {})
        tel.gauge(
            "fleet/straggler_index",
            straggler.get("process_index", -1) if straggler.get("verdict") else -1,
        )
        try:
            _atomic_json(os.path.join(self.fleet_dir, "fleet.json"), doc)
            from .exporters import rotating_append

            rotating_append(
                os.path.join(self.fleet_dir, "fleet_history.jsonl"),
                json.dumps(
                    {
                        "time_unix": doc["time_unix"],
                        "hosts_reporting": doc["hosts_reporting"],
                        "fleet": doc.get("fleet", {}),
                        "straggler": doc.get("straggler", {}),
                    }
                ),
                self.history_cap_bytes,
                tel=tel,
            )
        except OSError as e:
            self._warn(f"fleet.json write failed: {e}")

    def _warn(self, msg: str) -> None:
        if not self._warned:
            self._warned = True
            print(
                f"sat_tpu_torch: fleet telemetry degraded ({self.fleet_dir}): {msg}",
                file=sys.stderr,
                flush=True,
            )
