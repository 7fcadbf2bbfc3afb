"""Black-box flight recorder — the port's copy of
``sat_tpu.telemetry.blackbox``: a bounded on-disk ring and postmortem
bundles.

* :class:`BlackBox` — a bounded ring of rotating JSONL segments
  (``<dir>/seg_000.jsonl`` ...).  The serve loop journals one-line events
  on notable transitions; disk use is capped at ``segments *
  segment_bytes``.  Appends are plain ``O_APPEND`` writes — no fsync, no
  device sync — and readers skip torn lines.
* :func:`dump_postmortem` — on an abnormal exit (an uncaught exception in
  serve), assemble ``postmortem_<run_id>/`` under the telemetry dir:
  manifest with the probable phase, the last seconds of spans, the ring
  segments, counters and gauges, the heartbeat, ``slo.jsonl`` /
  ``telemetry.jsonl`` tails and the config snapshot.

Every teardown goes through ONE registered finalizer chain
(:func:`register_finalizer` / :func:`run_finalizers`), and :func:`dump`
flushes that chain *before* reading any file.  Degrade-don't-raise
throughout: a recorder failure warns once and never takes the run down.
"""

from __future__ import annotations

import atexit
import glob
import json
import os
import shutil
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..utils.fileio import atomic_write
from . import SCHEMA_VERSION, run_id


class BlackBox:
    """Bounded rotating-segment JSONL journal (the on-disk ring)."""

    def __init__(
        self,
        dir: str,
        tel,
        segment_bytes: int = 1 << 20,
        segments: int = 4,
    ) -> None:
        self.dir = dir
        self._tel = tel
        self.segment_bytes = max(4096, int(segment_bytes))
        self.segments = max(2, int(segments))
        self._lock = threading.Lock()
        self._warned = False
        self._idx = 0
        try:
            os.makedirs(self.dir, exist_ok=True)
            # continue the ring across a supervisor restart: resume on the
            # most recently touched segment so the previous incarnation's
            # tail survives until the ring genuinely wraps past it
            existing = sorted(glob.glob(os.path.join(self.dir, "seg_*.jsonl")))
            if existing:
                newest = max(existing, key=os.path.getmtime)
                self._idx = int(os.path.basename(newest)[4:-6])
        except (OSError, ValueError) as e:
            self._warn(f"init failed: {e}")

    def _segment_path(self, idx: int) -> str:
        return os.path.join(self.dir, f"seg_{idx:03d}.jsonl")

    # -- write side --------------------------------------------------------

    def append(self, kind: str, fields: Dict) -> None:
        """One journal line; rotates (and truncates the oldest segment)
        when the current segment is full.  Never raises."""
        record = {
            "t": round(time.time(), 3),
            "mono_ns": time.perf_counter_ns(),
            "kind": kind,
            **fields,
        }
        try:
            line = json.dumps(record) + "\n"
        except (TypeError, ValueError) as e:
            self._warn(f"unserializable record ({kind}): {e}")
            return
        try:
            with self._lock:
                path = self._segment_path(self._idx)
                try:
                    size = os.path.getsize(path)
                except OSError:
                    size = 0
                if size >= self.segment_bytes:
                    self._idx = (self._idx + 1) % self.segments
                    path = self._segment_path(self._idx)
                    open(path, "w").close()  # reclaim the oldest slot
                with open(path, "a") as f:
                    f.write(line)
        except OSError as e:
            self._warn(f"append failed: {e}")

    def journal(self, step: Optional[int] = None) -> None:
        """The per-log-boundary snapshot: step + counters + gauges."""
        self.append(
            "snapshot",
            {
                "step": step,
                "counters": self._tel.counters(),
                "gauges": self._tel.gauges(),
            },
        )

    def event(self, event: str, **fields) -> None:
        """A one-line notable transition (sentinel trip, SIGTERM, ...)."""
        self.append("event", {"event": event, **fields})

    def flush(self) -> None:
        """Finalizer-chain hook.  Appends hit the OS directly (no
        userspace buffer), so this is a checkpoint in the ordering
        contract rather than real work; it must stay idempotent."""

    # -- read side ---------------------------------------------------------

    def read_all(self) -> Tuple[List[Dict], int]:
        """(records sorted by wall time, torn-line count).  Torn or
        garbage lines — a process killed mid-append — are skipped."""
        records: List[Dict] = []
        torn = 0
        for path in sorted(glob.glob(os.path.join(self.dir, "seg_*.jsonl"))):
            try:
                with open(path) as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            rec = json.loads(line)
                            if not isinstance(rec, dict):
                                raise ValueError("not an object")
                            records.append(rec)
                        except ValueError:
                            torn += 1
            except OSError:
                continue
        records.sort(key=lambda r: r.get("t", 0))
        return records, torn

    def span_tail(self, seconds: float = 30.0) -> List[Dict]:
        """The recorder's span-ring entries from the last ``seconds``,
        with wall-clock start times (anchor_unix + monotonic offset)."""
        tel = self._tel
        names, ids, t0s, durs, tids = tel.spans_snapshot()
        if len(ids) == 0:
            return []
        cutoff = time.perf_counter_ns() - int(seconds * 1e9)
        anchor_ns = getattr(tel, "anchor_ns", 0)
        anchor_unix = getattr(tel, "anchor_unix", 0.0)
        out = []
        for k in range(len(ids)):
            if int(t0s[k]) < cutoff:
                continue
            out.append(
                {
                    "name": names[int(ids[k])],
                    "t_unix": round(
                        anchor_unix + (int(t0s[k]) - anchor_ns) / 1e9, 6
                    ),
                    "dur_ms": round(int(durs[k]) / 1e6, 4),
                    "tid": int(tids[k]),
                }
            )
        out.sort(key=lambda s: s["t_unix"])
        return out

    def _warn(self, msg: str) -> None:
        if not self._warned:
            self._warned = True
            print(
                f"sat_tpu_torch: black box degraded ({self.dir}): {msg}",
                file=sys.stderr,
                flush=True,
            )


# ---------------------------------------------------------------------------
# the single finalizer chain (shutdown-ordering contract)
# ---------------------------------------------------------------------------

_FINALIZERS: List[Tuple[str, Callable[[], None]]] = []
_CHAIN_LOCK = threading.Lock()
_RUNNING = threading.local()


def register_finalizer(name: str, fn: Callable[[], None]) -> None:
    """Add an IDEMPOTENT flush-style callback to the process's one
    teardown chain.  The chain runs (in registration order) at atexit, at
    normal run teardown, and — crucially — inside :func:`dump` before the
    bundle reads any file, so an exit-86/87 path can never observe
    half-torn-down state."""
    with _CHAIN_LOCK:
        for i, (existing, _) in enumerate(_FINALIZERS):
            if existing == name:
                # re-registration (a second train() in the same process)
                # replaces the stale callback instead of stacking it
                _FINALIZERS[i] = (name, fn)
                return
        _FINALIZERS.append((name, fn))


def run_finalizers() -> None:
    """Run the chain; every failure is contained.  Safe to call more than
    once (callbacks are idempotent by contract) but never re-entrantly —
    a finalizer that crashes into dump() must not recurse."""
    if getattr(_RUNNING, "active", False):
        return
    _RUNNING.active = True
    try:
        with _CHAIN_LOCK:
            chain = list(_FINALIZERS)
        for name, fn in chain:
            try:
                fn()
            except Exception as e:
                print(
                    f"sat_tpu_torch: finalizer {name!r} failed: {e}",
                    file=sys.stderr,
                    flush=True,
                )
    finally:
        _RUNNING.active = False


atexit.register(run_finalizers)


# ---------------------------------------------------------------------------
# process-wide install + postmortem dump
# ---------------------------------------------------------------------------

_INSTALLED: Optional[Dict] = None


def install(
    bb: BlackBox,
    *,
    telemetry_dir: str,
    fleet_dir: str = "",
    config_snapshot: Optional[Dict] = None,
    quarantine_ledger: str = "",
) -> None:
    """Make ``bb`` the process's postmortem source so far-away abnormal
    paths (watchdog abort, CLI exception handlers) can call :func:`dump`
    without plumbing.  Also threads the ring flush onto the finalizer
    chain — the ONE place teardown is allowed to touch it."""
    global _INSTALLED
    _INSTALLED = {
        "bb": bb,
        "telemetry_dir": telemetry_dir,
        "fleet_dir": fleet_dir or telemetry_dir,
        "config_snapshot": config_snapshot,
        "quarantine_ledger": quarantine_ledger,
    }
    register_finalizer("blackbox-ring", bb.flush)


def installed() -> Optional[BlackBox]:
    return _INSTALLED["bb"] if _INSTALLED else None


def uninstall() -> None:
    """Detach the recorder (tests; runs keep it until process exit so
    late aborts still dump)."""
    global _INSTALLED
    _INSTALLED = None


def _reset_for_tests() -> None:
    global _INSTALLED
    with _CHAIN_LOCK:
        _FINALIZERS.clear()
    _INSTALLED = None


def dump(reason: str, exit_code: Optional[int] = None, **fields) -> Optional[str]:
    """Assemble the postmortem bundle for the installed recorder (no-op
    when none is installed).  Returns the bundle path.  Never raises —
    this runs on paths that are already dying."""
    ctx = _INSTALLED
    if ctx is None:
        return None
    try:
        return dump_postmortem(
            reason,
            exit_code=exit_code,
            bb=ctx["bb"],
            telemetry_dir=ctx["telemetry_dir"],
            fleet_dir=ctx["fleet_dir"],
            config_snapshot=ctx["config_snapshot"],
            quarantine_ledger=ctx["quarantine_ledger"],
            extra=fields,
        )
    except Exception as e:
        print(
            f"sat_tpu_torch: postmortem dump failed ({reason}): {e}",
            file=sys.stderr,
            flush=True,
        )
        return None


def _tail_lines(path: str, n: int = 200) -> Optional[List[str]]:
    try:
        with open(path) as f:
            return f.readlines()[-n:]
    except OSError:
        return None


def _copy_if_exists(src: str, dst_dir: str) -> None:
    try:
        if os.path.isfile(src):
            shutil.copy2(src, os.path.join(dst_dir, os.path.basename(src)))
    except OSError:
        pass


def _write_tail(src: str, dst: str, n: int = 200) -> None:
    lines = _tail_lines(src, n)
    if lines is not None:
        try:
            with open(dst, "w") as f:
                f.writelines(lines)
        except OSError:
            pass


def dump_postmortem(
    reason: str,
    exit_code: Optional[int],
    bb: BlackBox,
    telemetry_dir: str,
    fleet_dir: str = "",
    config_snapshot: Optional[Dict] = None,
    quarantine_ledger: str = "",
    span_tail_s: float = 30.0,
    extra: Optional[Dict] = None,
) -> str:
    """Build ``postmortem_<run_id>/`` under ``telemetry_dir``.  Every
    artifact copy is individually best-effort: a bundle with a hole beats
    no bundle.  Files the run owns are FLUSHED first via the finalizer
    chain, then only read — the ring is never truncated or rotated here."""
    run_finalizers()  # flush-before-read: the ordering contract
    fleet_dir = fleet_dir or telemetry_dir
    bundle = os.path.join(telemetry_dir, f"postmortem_{run_id()}")
    os.makedirs(bundle, exist_ok=True)

    spans = []
    try:
        spans = bb.span_tail(span_tail_s)
    except Exception:
        pass
    manifest = {
        "schema_version": SCHEMA_VERSION,
        "run_id": run_id(),
        "reason": reason,
        "exit_code": exit_code,
        "time_unix": round(time.time(), 3),
        "pid": os.getpid(),
        "span_tail_s": span_tail_s,
        "last_phase": spans[-1]["name"] if spans else None,
        **(extra or {}),
    }
    try:
        atomic_write(
            os.path.join(bundle, "manifest.json"),
            "w",
            lambda f: json.dump(manifest, f, indent=1),
        )
    except OSError:
        pass
    try:
        atomic_write(
            os.path.join(bundle, "spans_tail.json"),
            "w",
            lambda f: json.dump(spans, f, indent=1),
        )
    except OSError:
        pass
    try:
        state = {"counters": bb._tel.counters(), "gauges": bb._tel.gauges()}
        atomic_write(
            os.path.join(bundle, "state.json"),
            "w",
            lambda f: json.dump(state, f, indent=1),
        )
    except Exception:
        pass

    # the ring itself (copied, never moved: the run may still be writing)
    ring_dir = os.path.join(bundle, "blackbox")
    try:
        os.makedirs(ring_dir, exist_ok=True)
        for seg in sorted(glob.glob(os.path.join(bb.dir, "seg_*.jsonl"))):
            _copy_if_exists(seg, ring_dir)
    except OSError:
        pass

    # run-health artifacts other subsystems already maintain
    for name in (
        "heartbeat.json",
        "watchdog_stacks.txt",
        "compile_report.json",
        "breakdown.json",
    ):
        _copy_if_exists(os.path.join(telemetry_dir, name), bundle)
    _copy_if_exists(os.path.join(fleet_dir, "fleet.json"), bundle)
    for sidecar in sorted(glob.glob(os.path.join(fleet_dir, "heartbeat_p*.json"))):
        _copy_if_exists(sidecar, bundle)
    for name, src_dir in (
        ("slo.jsonl", telemetry_dir),
        ("telemetry.jsonl", telemetry_dir),
        ("fleet_history.jsonl", fleet_dir),
    ):
        _write_tail(
            os.path.join(src_dir, name), os.path.join(bundle, name)
        )
    if quarantine_ledger:
        _write_tail(
            quarantine_ledger, os.path.join(bundle, "quarantine.jsonl")
        )
    if config_snapshot is not None:
        try:
            atomic_write(
                os.path.join(bundle, "config.json"),
                "w",
                lambda f: json.dump(config_snapshot, f, indent=1, sort_keys=True),
            )
        except (OSError, TypeError, ValueError):
            pass
    print(
        f"sat_tpu_torch: postmortem bundle written: {bundle} "
        f"(reason={reason}, exit_code={exit_code}) — summarize with "
        "scripts/analyze_postmortem.py",
        file=sys.stderr,
        flush=True,
    )
    return bundle
