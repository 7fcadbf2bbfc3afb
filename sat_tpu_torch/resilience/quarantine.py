"""Poison-sample quarantine: contain bad records instead of crashing — the
port's copy of ``sat_tpu.resilience.quarantine``, same ledger format.

``data/integrity.py`` is the detection half of the data plane's immune
system; this module is the containment half:

* an **append-only JSONL ledger** (``quarantine.jsonl`` next to the
  run's summaries) records every quarantined record — file, reason,
  kind (image/caption), epoch/step, content sha — one atomic line per
  record, so a watcher can tail it and a replay can preload it;
* **deterministic substitution**: a quarantined row is replaced
  in-batch by a known-good row chosen by a stable hash of the
  quarantine key, so batch geometry never changes and a replayed run
  given the same ledger is bitwise-identical to the run that produced
  it;
* a **quarantine-fraction ceiling**: sporadic corruption is contained,
  but when more than ``quarantine_max_fraction`` of all rows seen have
  been quarantined (and at least ``MIN_RECORDS_FOR_CEILING`` records
  are involved), the corruption is systemic — training on mostly
  substituted data is worse than stopping — and the run aborts with
  :data:`DATA_CORRUPTION_EXIT_CODE` (87; 86 is the watchdog's).
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

from .. import telemetry

# Exit-code vocabulary (see resilience/watchdog.py): 86 = wedged run
# aborted by the watchdog; 87 = systemic data corruption — the
# quarantine ceiling tripped.  Distinct codes because a supervisor must
# restart 86 (state on disk is good) and must NOT restart 87
# (restarting re-reads the same rotten data).
DATA_CORRUPTION_EXIT_CODE = 87

# The ceiling never fires on fewer than this many quarantined records:
# one bad file in a ten-image smoke run is sporadic, not systemic.
MIN_RECORDS_FOR_CEILING = 8


class SystemicCorruption(RuntimeError):
    """Raised when the quarantine-fraction ceiling trips; mapped to
    exit code 87 by ``cli.main`` (train and bulk)."""


def ledger_path_for(config) -> str:
    """Ledger location: ``config.quarantine_ledger`` when set, else
    ``quarantine.jsonl`` beside the run's summaries."""
    if getattr(config, "quarantine_ledger", ""):
        return config.quarantine_ledger
    return os.path.join(config.summary_dir, "quarantine.jsonl")


def _norm(path: str) -> str:
    return os.path.normpath(os.path.abspath(path))


def _file_sha(path: str) -> Optional[str]:
    try:
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for block in iter(lambda: f.read(1 << 20), b""):
                h.update(block)
        return h.hexdigest()
    except OSError:
        return None


class QuarantineManager:
    """Thread-safe quarantine ledger + substitution policy.

    One instance per run, shared by every ``PrefetchLoader`` the run
    constructs (train and eval), because the ceiling is a *run-level*
    judgement.  All methods may be called from prefetch producer and
    decode threads.
    """

    def __init__(
        self,
        ledger_path: str,
        max_fraction: float = 0.5,
        min_records: int = MIN_RECORDS_FOR_CEILING,
        appends: bool = True,
    ) -> None:
        self.ledger_path = ledger_path
        # False: a mesh rank whose model-axis peer writes the shared ledger
        self.appends = appends
        self.max_fraction = float(max_fraction)
        self.min_records = int(min_records)
        self._lock = threading.Lock()
        # file-kind entries keyed by normalized absolute path; caption-
        # kind entries keyed by batch position (pass, batch, row) — a
        # file appears under several captions, so a bad *caption* row
        # is identified by where it sits in the epoch stream, which is
        # deterministic (DataSet order is a pure function of seed+epoch)
        self._by_file: Dict[str, Dict[str, Any]] = {}
        self._by_pos: Dict[Tuple[int, int, int], Dict[str, Any]] = {}
        self._rows_seen = 0
        self._load()

    # -- ledger ------------------------------------------------------------

    def _load(self) -> None:
        """Preload an existing ledger (replay path): already-known
        records are substituted proactively, never re-appended."""
        try:
            with open(self.ledger_path) as f:
                lines = f.readlines()
        except OSError:
            return
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                entry = json.loads(line)
            except ValueError:
                continue  # torn tail line: the ledger itself can be torn
            self._index(entry)
        self._gauge_locked()

    def _index(self, entry: Dict[str, Any]) -> None:
        if entry.get("kind") == "caption" and "pos" in entry:
            self._by_pos[tuple(entry["pos"])] = entry
        elif entry.get("file"):
            self._by_file[_norm(entry["file"])] = entry

    def _append(self, entry: Dict[str, Any]) -> None:
        d = os.path.dirname(self.ledger_path)
        if d:
            os.makedirs(d, exist_ok=True)
        # O_APPEND single-write: atomic enough for one-writer JSONL, and
        # a torn final line is tolerated by _load()
        with open(self.ledger_path, "a") as f:
            f.write(json.dumps(entry, sort_keys=True) + "\n")
            f.flush()

    # -- queries (producer threads) ----------------------------------------

    def known_bad_file(self, image_file: str) -> bool:
        with self._lock:
            return _norm(image_file) in self._by_file

    def known_bad_pos(self, pass_idx: int, batch: int, row: int) -> bool:
        with self._lock:
            return (pass_idx, batch, row) in self._by_pos

    def files(self) -> List[str]:
        """Normalized paths of every file-kind quarantined record (the
        ``--repair_shards`` suspect list)."""
        with self._lock:
            return sorted(self._by_file)

    @property
    def total(self) -> int:
        with self._lock:
            return len(self._by_file) + len(self._by_pos)

    # -- bookkeeping -------------------------------------------------------

    def note_rows(self, n: int) -> None:
        """Count rows entering the pipeline (the ceiling's denominator)."""
        with self._lock:
            self._rows_seen += int(n)

    def _gauge_locked(self) -> None:
        total = len(self._by_file) + len(self._by_pos)
        telemetry.gauge("data/quarantined_total", total)
        telemetry.gauge(
            "data/quarantined_fraction",
            round(total / max(1, self._rows_seen), 4),
        )

    # -- the one write path ------------------------------------------------

    def quarantine(
        self,
        image_file: str,
        reason: str,
        kind: str = "image",
        pos: Optional[Tuple[int, int, int]] = None,
        exc: Optional[BaseException] = None,
        record: bool = True,
    ) -> None:
        """Record one bad row.  Dedups (a bad file re-encountered every
        epoch is one ledger line), appends, updates telemetry, and
        raises :class:`SystemicCorruption` when the ceiling trips.
        ``record=False`` (a mesh rank's row of another rank's block)
        indexes and counts the row without appending it: its owner
        does."""
        with self._lock:
            key_file = _norm(image_file) if image_file else ""
            if kind == "caption" and pos is not None:
                if tuple(pos) in self._by_pos:
                    return
            elif key_file and key_file in self._by_file:
                return
            gauges = telemetry.get().gauges()
            entry: Dict[str, Any] = {
                "file": key_file,
                "reason": str(reason),
                "kind": kind,
                "epoch": gauges.get("data/epoch"),
                "step": gauges.get("train/step"),
                "sha": _file_sha(key_file) if key_file else None,
            }
            if pos is not None:
                entry["pos"] = list(pos)
            if exc is not None:
                entry["error"] = f"{type(exc).__name__}: {exc}"
            self._index(entry)
            if record and self.appends:
                self._append(entry)
            telemetry.count("data/quarantined")
            self._gauge_locked()
            total = len(self._by_file) + len(self._by_pos)
            fraction = total / max(1, self._rows_seen)
            if total >= self.min_records and fraction > self.max_fraction:
                raise SystemicCorruption(
                    f"systemic data corruption: {total} of "
                    f"{self._rows_seen} rows quarantined "
                    f"({fraction:.0%} > ceiling "
                    f"{self.max_fraction:.0%}) — refusing to train on "
                    f"mostly substituted data (exit "
                    f"{DATA_CORRUPTION_EXIT_CODE}); ledger: "
                    f"{self.ledger_path}"
                )

    # -- deterministic substitution ----------------------------------------

    @staticmethod
    def substitute_index(key: str, num_healthy: int) -> int:
        """Stable healthy-row choice for a quarantined row: a hash of
        the quarantine key, so the same ledger replayed yields the same
        substitutions (bitwise-reproducible batches)."""
        return zlib.crc32(key.encode("utf-8")) % max(1, num_healthy)
