"""Run-health heartbeat: an atomically replaced JSON file watchers can poll
— the port's copy of ``sat_tpu.telemetry.heartbeat``, same file format.

A long run is usually observed from the *outside* — a supervisor shell,
a bench orchestrator, a human with ``watch jq``.  Log files answer "what
happened"; the heartbeat answers "is it alive RIGHT NOW and how fast":
one small JSON object (``heartbeat.json``), rewritten in place with
tmp+rename every ``interval_s`` seconds by a daemon thread, holding

* liveness: ``seq`` (monotone write counter), ``time_unix``, ``pid``;
* progress: ``step``, ``epoch``, ``steps_per_s`` (measured between
  heartbeat ticks, not cumulative — a stall shows up within one tick);
* recoverability: ``last_checkpoint_step`` and ``last_checkpoint_age_s``;
* environment: ``rss_mb``, the compile count and seconds (always 0 in
  the port, which compiles nothing; kept so one reader parses both
  packages' files), plus every telemetry counter;
* one block per gauge family (``bulk``, ``data``, ``serve``, ...).

The writer thread must never take the run down: every failure degrades
to a single warning.  Device state is read exclusively through gauges
the instrumented loops already set.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Dict, Optional

from ..utils.fileio import atomic_write
from . import SCHEMA_VERSION, process_identity, run_id


def _rss_bytes() -> int:
    """Resident set size; 0 when unknowable (non-Linux without resource)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        try:
            import resource

            return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        except Exception:
            return 0


class Heartbeat:
    """Daemon-thread writer of ``heartbeat.json``.

    ``static`` carries fields known at start (backend, phase); everything
    dynamic is read from ``tel``'s gauges/counters at write time, so the
    hot loop communicates with the heartbeat exclusively through the
    telemetry registry — no extra shared state, no extra syncs.
    """

    def __init__(
        self,
        path: str,
        interval_s: float,
        tel,
        static: Optional[Dict] = None,
        sampler=None,
    ) -> None:
        self.path = path
        self.interval_s = max(0.05, float(interval_s))
        self._tel = tel
        self._static = dict(static or {})
        # optional zero-arg callable merged into each beat (a device-
        # memory probe); a sampler failure or an empty return degrades to
        # absence
        self._sampler = sampler
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._seq = 0
        self._prev: Optional[tuple] = None  # (time, step) of the last write
        self._warned = False

    # -- payload -----------------------------------------------------------

    def _payload(self) -> Dict:
        gauges = self._tel.gauges()
        counters = self._tel.counters()
        now = time.time()
        step = gauges.get("train/step")
        steps_per_s = None
        if step is not None and self._prev is not None:
            dt = now - self._prev[0]
            if dt > 0 and step >= self._prev[1]:
                steps_per_s = round((step - self._prev[1]) / dt, 3)
        if step is not None:
            self._prev = (now, step)
        last_save = gauges.get("ckpt/last_save_unix")
        # multi-host identity (telemetry.process_identity, (0, 1) in a
        # single-process run): heartbeat files on shared storage must say
        # which host wrote each
        process_index, process_count = process_identity()
        payload = {
            # consumers get the same contract check_regression gives bench
            # rows: refuse payloads whose schema they don't understand
            "schema_version": SCHEMA_VERSION,
            "run_id": run_id(),
            "seq": self._seq,
            "pid": os.getpid(),
            "process_index": process_index,
            "process_count": process_count,
            "time_unix": round(now, 3),
            "interval_s": self.interval_s,
            "step": int(step) if step is not None else None,
            "epoch": gauges.get("data/epoch"),
            "steps_per_s": steps_per_s,
            "last_checkpoint_step": gauges.get("ckpt/last_save_step"),
            "last_checkpoint_age_s": (
                round(now - last_save, 1) if last_save is not None else None
            ),
            "compile_count": 0,
            "compile_seconds": 0.0,
            "rss_mb": round(_rss_bytes() / (1 << 20), 1),
            "counters": counters,
        }
        # last diag-tap / compile-accounting snapshot: the instrumented
        # loops gauge these at the log boundary, so one heartbeat file
        # answers "is the gradient sane and what does the step cost"
        diag = {k[len("diag/"):]: v for k, v in gauges.items() if k.startswith("diag/")}
        if diag:
            payload["diag"] = diag
        xla = {k[len("xla/"):]: v for k, v in gauges.items() if k.startswith("xla/")}
        if xla:
            payload["xla"] = xla
        # serving gauges (serve/): readiness, queue depth, warm buckets —
        # one heartbeat file answers "is the server up, is the queue
        # backing up"
        srv = {k[len("serve/"):]: v for k, v in gauges.items() if k.startswith("serve/")}
        if srv:
            payload["serve"] = srv
        # watchdog ladder state (resilience.watchdog): 0 ok / 1 stalled /
        # 2 dumped / 3 aborting, plus seconds the stalled phase has been
        # open — the heartbeat is how an outside watcher sees a stall
        # while it is still recoverable
        wdg = {
            k[len("watchdog/"):]: v
            for k, v in gauges.items()
            if k.startswith("watchdog/")
        }
        if wdg:
            payload["watchdog"] = wdg
        sup = {
            k[len("supervisor/"):]: v
            for k, v in gauges.items()
            if k.startswith("supervisor/")
        }
        if sup:
            payload["supervisor"] = sup
        # data-plane health (data.integrity / resilience.quarantine):
        # quarantined totals + fraction, prefetch depth — a watcher sees
        # input corruption being contained while the run keeps training
        data = {
            k[len("data/"):]: v
            for k, v in gauges.items()
            if k.startswith("data/")
        }
        if data:
            payload["data"] = data
        # bulk offline-captioning progress (bulk/): images done / total,
        # captions/s, ETA, quarantined count, device-ms per image — the
        # heartbeat is how a watcher tracks a dataset-scale job without
        # tailing its log
        bulk = {
            k[len("bulk/"):]: v
            for k, v in gauges.items()
            if k.startswith("bulk/")
        }
        if bulk:
            payload["bulk"] = bulk
        # SLO engine state (telemetry.slo): per-objective burn rate and
        # burning flag plus the burning_total roll-up — the heartbeat is
        # where an outside watcher sees an objective start to burn
        slo = {
            k[len("slo/"):]: v for k, v in gauges.items() if k.startswith("slo/")
        }
        if slo:
            payload["slo"] = slo
        # model-lifecycle plane (lifecycle/): state code, serving
        # vs candidate step, canary divergence, last swap blackout — a
        # watcher sees a canary in flight (state 3) and its verdict
        # without hitting /stats
        lc = {
            k[len("lifecycle/"):]: v
            for k, v in gauges.items()
            if k.startswith("lifecycle/")
        }
        if lc:
            payload["lifecycle"] = lc
        # fleet aggregate (telemetry.fleet): hosts reporting, step-p95
        # skew, straggler index — process 0's heartbeat answers "which
        # host is slow" without opening fleet.json
        fleet = {
            k[len("fleet/"):]: v
            for k, v in gauges.items()
            if k.startswith("fleet/")
        }
        if fleet:
            payload["fleet"] = fleet
        # caption-quality plane (telemetry.quality): per-signal PSI vs
        # the frozen reference, unk-rate, outlier count — the heartbeat
        # is where a watcher sees the model drift before anyone reads a
        # caption
        quality = {
            k[len("quality/"):]: v
            for k, v in gauges.items()
            if k.startswith("quality/")
        }
        if quality:
            payload["quality"] = quality
        if self._sampler is not None:
            try:
                payload.update(self._sampler() or {})
            except Exception:
                pass  # device stats are best-effort, never fatal
        payload.update(self._static)
        return payload

    def payload(self) -> Dict:
        """One payload snapshot without writing the file — the serving
        frontend's ``GET /healthz`` rides the exact fields watchers poll
        out of heartbeat.json."""
        return self._payload()

    def write_now(self) -> None:
        """One atomic write; failures warn once and never raise."""
        try:
            payload = self._payload()
            self._seq += 1
            atomic_write(
                self.path, "w", lambda f: json.dump(payload, f, indent=1)
            )
        except Exception as e:
            if not self._warned:
                self._warned = True
                print(
                    f"sat_tpu_torch: heartbeat disabled — write failed "
                    f"({self.path}): {e}",
                    file=sys.stderr,
                    flush=True,
                )

    # -- lifecycle ---------------------------------------------------------

    def _run(self) -> None:
        self.write_now()  # first beat immediately: watchers see the run early
        while not self._stop.wait(self.interval_s):
            self.write_now()

    def start(self) -> "Heartbeat":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="sat-heartbeat", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        """Final beat (so the file records the terminal step) + join."""
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None
        self.write_now()

    def __enter__(self) -> "Heartbeat":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
