"""Exemplar flight recorder — bounded capture of outlier requests.

The port's copy of ``sat_tpu.telemetry.exemplar``.

The quality plane's black box (``blackbox.py``'s rotating-segment
discipline applied to whole requests): when the streaming monitor
flags a request as an outlier — low beam margin, high unk rate, drift
contribution, eos truncation, shed/timeout — the recorder tail-samples
it into ``<dir>/seg_NNN.jsonl`` plus a crc32c-named copy of the raw
request image bytes, enough for ``scripts/replay_exemplar.py`` to boot
a fresh engine and reproduce the caption bitwise.

Bounded by construction: segments rotate at a fixed count x size, image
payloads share one disk budget with oldest-first eviction, and capture
is rate-limited so an anomaly storm records a sample, not the storm.
Appends are O_APPEND JSON lines; readers tolerate torn tails (a process
killed mid-append).  Jax-free and never raises into the serve path.
"""

from __future__ import annotations

import glob
import json
import os
import sys
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

META_FILE = "meta.json"


def _crc32c_hex(data: bytes) -> str:
    # zlib.crc32 (not the castagnoli polynomial) would be a different
    # checksum family than the shard sidecars use; route through the
    # same helper so "crc32c-named" means one thing repo-wide
    from ..utils.summary import crc32c

    return f"{crc32c(data):08x}"


def alphas_digest(alphas) -> Optional[str]:
    """A stable 8-hex digest of a request's drained attention maps —
    enough to tell two replays produced identical alphas without
    storing the full [K, T, N] tensor per exemplar."""
    if alphas is None:
        return None
    import numpy as np

    a = np.ascontiguousarray(np.asarray(alphas, np.float32))  # sync-ok: host numpy, already drained
    return f"{zlib.crc32(a.tobytes()) & 0xFFFFFFFF:08x}"


class ExemplarRecorder:
    """Rotating on-disk capture of outlier requests.

    One instance per serve process; ``record`` is called from the detok
    thread (outliers) and the HTTP error paths (shed/timeout), so it
    takes a lock, does bounded I/O, and swallows every failure — a full
    disk degrades capture, never serving.
    """

    def __init__(
        self,
        dir: str,
        *,
        budget_mb: float = 64.0,
        segment_rows: int = 64,
        segments: int = 8,
        image_cap_kb: float = 512.0,
        min_interval_s: float = 0.25,
        clock=time.monotonic,
    ) -> None:
        self.dir = dir
        self.budget_bytes = int(budget_mb * (1 << 20))
        self.segment_rows = max(1, int(segment_rows))
        self.segments = max(2, int(segments))
        self.image_cap = int(image_cap_kb * 1024)
        self.min_interval_s = float(min_interval_s)  # sync-ok: host config scalar
        self._clock = clock
        self._lock = threading.Lock()
        self._t_last = -float("inf")  # sync-ok: host sentinel
        self._idx = 0
        self._rows_in_seg = 0
        self.recorded = 0
        self.dropped = 0
        self._warned = False
        try:
            os.makedirs(self.dir, exist_ok=True)
            existing = sorted(
                glob.glob(os.path.join(self.dir, "seg_*.jsonl"))
            )
            if existing:
                newest = max(existing, key=os.path.getmtime)
                self._idx = int(os.path.basename(newest)[4:-6])
                with open(newest) as f:
                    self._rows_in_seg = sum(1 for _ in f)
        except (OSError, ValueError) as e:
            self._warn(f"init failed: {e}")

    # -- write side --------------------------------------------------------

    def write_meta(self, meta: Dict) -> None:
        """The replay context (config snapshot, checkpoint step, vocab
        fingerprint) written once at boot — replay refuses to guess."""
        try:
            path = os.path.join(self.dir, META_FILE)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(meta, f, sort_keys=True, indent=1)
            os.replace(tmp, path)
        except (OSError, TypeError, ValueError) as e:
            self._warn(f"meta write failed: {e}")

    def record(
        self,
        *,
        reasons: List[str],
        request_id: str = "",
        tenant: str = "",
        caption: str = "",
        beams: Optional[List[Dict]] = None,
        signals: Optional[Dict[str, float]] = None,
        image_bytes: Optional[bytes] = None,
        alphas=None,
        status: int = 200,
        extra: Optional[Dict] = None,
    ) -> bool:
        """Tail-sample one outlier request; True when it landed on disk.
        Rate-limited: captures closer together than ``min_interval_s``
        are counted (``dropped``) but not written."""
        now = self._clock()
        with self._lock:
            if now - self._t_last < self.min_interval_s:
                self.dropped += 1
                return False
            self._t_last = now
            row = {
                "t_unix": round(time.time(), 3),
                "reasons": list(reasons),
                "request_id": request_id,
                "tenant": tenant,
                "status": int(status),
                "caption": caption,
                "beams": beams or [],
                "signals": {
                    k: round(float(v), 6)  # sync-ok: host scalar, already drained
                    for k, v in (signals or {}).items()
                },
                "alphas_digest": alphas_digest(alphas),
            }
            if extra:
                row.update(extra)
            try:
                row["image"], row["image_bytes"] = self._store_image(
                    image_bytes
                )
                self._append(row)
                self.recorded += 1
            except (OSError, TypeError, ValueError) as e:
                self._warn(f"record failed: {e}")
                return False
            try:
                self._enforce_budget()
            except OSError:
                pass  # budget enforcement is best-effort
            return True

    def _store_image(
        self, image_bytes: Optional[bytes]
    ) -> Tuple[Optional[str], int]:
        """(stored filename | None, original byte count).  Size-capped:
        an oversized body records its metadata but not its payload."""
        if not image_bytes:
            return None, 0
        n = len(image_bytes)
        if n > self.image_cap:
            return None, n
        name = f"img_{_crc32c_hex(image_bytes)}.bin"
        path = os.path.join(self.dir, name)
        if not os.path.exists(path):
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(image_bytes)
            os.replace(tmp, path)
        return name, n

    def _append(self, row: Dict) -> None:
        if self._rows_in_seg >= self.segment_rows:
            self._idx = (self._idx + 1) % self.segments
            self._rows_in_seg = 0
            path = self._segment_path(self._idx)
            open(path, "w").close()  # reclaim the oldest slot
        path = self._segment_path(self._idx)
        with open(path, "a") as f:
            f.write(json.dumps(row, sort_keys=True) + "\n")
        self._rows_in_seg += 1

    def _segment_path(self, idx: int) -> str:
        return os.path.join(self.dir, f"seg_{idx:03d}.jsonl")

    def _enforce_budget(self) -> None:
        """Keep the whole directory (segments + images) under the disk
        budget: unreferenced/oldest image payloads go first, then the
        oldest non-current segments."""
        entries = []
        total = 0
        for name in os.listdir(self.dir):
            path = os.path.join(self.dir, name)
            try:
                st = os.stat(path)
            except OSError:
                continue
            total += st.st_size
            entries.append((st.st_mtime, st.st_size, name, path))
        if total <= self.budget_bytes:
            return
        current = os.path.basename(self._segment_path(self._idx))
        for _mtime, size, name, path in sorted(entries):
            if name in (current, META_FILE):
                continue
            try:
                os.remove(path)
            except OSError:
                continue
            total -= size
            if total <= self.budget_bytes:
                return

    def _warn(self, msg: str) -> None:
        if not self._warned:
            self._warned = True
            print(f"sat_tpu_torch exemplar recorder: {msg}", file=sys.stderr)

    # -- read side ---------------------------------------------------------

    def stats(self) -> Dict:
        with self._lock:
            return {"recorded": self.recorded, "dropped": self.dropped}


def read_meta(dir: str) -> Optional[Dict]:
    try:
        with open(os.path.join(dir, META_FILE)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def read_exemplars(dir: str) -> Tuple[List[Dict], int]:
    """(exemplar rows sorted by wall time, torn-line count).  Torn or
    garbage lines — a process killed mid-append — are skipped."""
    rows: List[Dict] = []
    torn = 0
    for path in sorted(glob.glob(os.path.join(dir, "seg_*.jsonl"))):
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
                        rows.append(rec)
                    except ValueError:
                        torn += 1
        except OSError:
            continue
    rows.sort(key=lambda r: r.get("t_unix", 0))
    return rows, torn


def load_image(dir: str, row: Dict) -> Optional[bytes]:
    """The stored request bytes for one exemplar row (None when the
    image was over the size cap or already evicted by the budget)."""
    name = row.get("image")
    if not name:
        return None
    try:
        with open(os.path.join(dir, name), "rb") as f:
            return f.read()
    except OSError:
        return None
