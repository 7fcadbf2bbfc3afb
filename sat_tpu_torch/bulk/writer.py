"""Sharded caption output: ``captions_<shard>.jsonl`` + crc32c sidecar — the
port's copy of ``sat_tpu.bulk.writer``, same bytes.

Crash-only discipline, mirroring the shard cache's append-only build
(``data.shards``): every output shard is written in full to
``<name>.jsonl.tmp`` and ``os.replace``d into place only once complete,
so the final filename existing IS the commit record.  A kill -9
mid-shard leaves only a ``.tmp`` orphan, which resume deletes and
re-decodes from the shard's first row — rows are never appended to a
surviving file, which is how the no-duplicate/no-missing-row guarantee
holds without any intra-shard bookkeeping.

Each committed shard gets a ``<name>.jsonl.crc32c`` sidecar (rows,
whole-file crc, per-row crcs — ``utils.summary.crc32c``, the same
polynomial as the input shard cache's row sidecars) written through
``retry_io`` + ``atomic_write``; :func:`verify_shard` re-checks a file
against it (and optionally the manifest's recorded row count/crc)
before resume skips the shard.

Rows are serialized with ``json.dumps(obj, sort_keys=True)`` and no
timestamps or host identity — an interrupted-and-resumed run must
produce bitwise-identical files to an uninterrupted one.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

from ..resilience.retry import retry_io
from ..utils.fileio import atomic_write
from ..utils.summary import crc32c


def shard_filename(shard_idx: int) -> str:
    return f"captions_{shard_idx:05d}.jsonl"


def sidecar_path(shard_path: str) -> str:
    return shard_path + ".crc32c"


def encode_row(obj: dict) -> bytes:
    """The one serialization used by writer and verifier alike: sorted
    keys, newline-terminated, UTF-8.  Determinism lives here."""
    return (json.dumps(obj, sort_keys=True) + "\n").encode("utf-8")


class ShardWriter:
    """Writes one output shard (see module docstring).  Rows are buffered
    in memory as well as streamed to the tmp file — shards are small by
    construction (``--bulk_shard_rows``, default 256) and the buffer is
    what makes the whole-file crc and the sidecar exact without a
    re-read."""

    def __init__(self, out_dir: str, shard_idx: int):
        os.makedirs(out_dir, exist_ok=True)
        self.shard_idx = shard_idx
        self.path = os.path.join(out_dir, shard_filename(shard_idx))
        self.tmp = self.path + ".tmp"
        self._blobs: List[bytes] = []
        self._row_crcs: List[int] = []
        self._f = open(self.tmp, "wb")

    @property
    def rows(self) -> int:
        return len(self._blobs)

    def write_row(self, obj: dict) -> None:
        blob = encode_row(obj)
        self._f.write(blob)
        self._blobs.append(blob)
        self._row_crcs.append(crc32c(blob))

    def finish(self) -> Tuple[str, int, int]:
        """fsync + commit the shard; returns ``(filename, rows, crc)``
        for the caller's manifest entry.  The sidecar lands after the
        rename — a crash between the two leaves a file that fails
        :func:`verify_shard` and gets re-decoded (identically)."""
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        file_crc = crc32c(b"".join(self._blobs))
        retry_io(
            lambda: os.replace(self.tmp, self.path),
            desc=f"commit {os.path.basename(self.path)}",
        )
        payload = json.dumps(
            {"rows": self.rows, "crc32c": file_crc, "row_crc32c": self._row_crcs},
            sort_keys=True,
        )
        retry_io(
            lambda: atomic_write(
                sidecar_path(self.path), "w", lambda f: f.write(payload + "\n")
            ),
            desc=f"write {os.path.basename(sidecar_path(self.path))}",
        )
        return os.path.basename(self.path), self.rows, file_crc

    def abort(self) -> None:
        try:
            self._f.close()
        finally:
            if os.path.exists(self.tmp):
                os.unlink(self.tmp)


def verify_shard(
    shard_path: str,
    expect_rows: Optional[int] = None,
    expect_crc: Optional[int] = None,
) -> bool:
    """True iff the committed shard matches its sidecar (whole-file and
    per-row crcs) and, when given, the manifest's recorded row count and
    crc.  Any failure — missing file, missing/torn sidecar, mismatch —
    is False: the caller re-decodes the shard, trading time for
    certainty."""
    try:
        with open(shard_path, "rb") as f:
            data = f.read()
        with open(sidecar_path(shard_path)) as f:
            side = json.load(f)
    except (OSError, ValueError):
        return False
    lines = data.splitlines(keepends=True)
    if not isinstance(side, dict):
        return False
    row_crcs = side.get("row_crc32c")
    if side.get("rows") != len(lines) or not isinstance(row_crcs, list):
        return False
    if len(row_crcs) != len(lines):
        return False
    if side.get("crc32c") != crc32c(data):
        return False
    if any(crc32c(line) != c for line, c in zip(lines, row_crcs)):
        return False
    if expect_rows is not None and expect_rows != len(lines):
        return False
    if expect_crc is not None and expect_crc != side.get("crc32c"):
        return False
    return True
