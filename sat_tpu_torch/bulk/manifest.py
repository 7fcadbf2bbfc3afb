"""The bulk progress manifest: the exact resume frontier, atomically — the
port's copy of ``sat_tpu.bulk.manifest``, same file format.

``bulk_manifest.json`` lives in the output directory and records, after
every completed output shard, which shards are done and what their
output files should contain (row count + whole-file crc32c).  A
relaunched job (a re-run after kill -9, on any machine) reloads it, re-derives the shard plan from the
corpus, and re-decodes only the shards without a completed entry —
completed outputs are never rewritten, which is what makes resume
bitwise.

Durability discipline: every write rides
``resilience.retry.retry_io`` around ``utils.fileio.atomic_write``
(tmp + fchmod + ``os.replace``), so a flaky mount costs a backoff and a
kill -9 mid-write leaves either the previous manifest or the new one,
never a torn hybrid.  The read side is correspondingly paranoid:
anything unparseable or structurally wrong loads as ``None`` (= start
from an empty frontier), because the output files themselves are
re-verified against the manifest before a shard is skipped — a lost
manifest costs re-decoding, never correctness.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import List, Optional

from ..resilience.retry import retry_io
from ..utils.fileio import atomic_write

MANIFEST_NAME = "bulk_manifest.json"

# Manifest layout version: bump when a field changes meaning.  A reader
# seeing a different format starts fresh rather than misinterpreting.
MANIFEST_FORMAT = 1


def manifest_path_for(bulk_output: str) -> str:
    return os.path.join(bulk_output, MANIFEST_NAME)


def corpus_fingerprint(files: List[str], rows_per_shard: int, image_size: int) -> str:
    """sha256 over the ordered corpus and the parameters that shape the
    outputs.  Deliberately EXCLUDES device count / pool geometry / host
    details: those may change across a resume (elastic resume) and must
    not invalidate completed shards.  Includes ``image_size``
    because a different resize produces different captions — resuming a
    224px run at 32px must restart, not splice."""
    h = hashlib.sha256()
    h.update(f"format={MANIFEST_FORMAT};rows={rows_per_shard};size={image_size};".encode())
    for f in files:
        h.update(f.encode("utf-8", "surrogatepass"))
        h.update(b"\n")
    return h.hexdigest()


def new_manifest(files: List[str], rows_per_shard: int, image_size: int) -> dict:
    num_shards = (len(files) + rows_per_shard - 1) // rows_per_shard
    return {
        "format": MANIFEST_FORMAT,
        "corpus_sha": corpus_fingerprint(files, rows_per_shard, image_size),
        "total_images": len(files),
        "shard_rows": rows_per_shard,
        "image_size": image_size,
        "num_shards": num_shards,
        # str(shard_idx) -> {"file", "rows", "crc32c"}; str keys because
        # this round-trips through JSON
        "completed": {},
    }


def load_manifest(path: str) -> Optional[dict]:
    """Load a manifest, or ``None`` when there is none to trust: missing
    file, torn/invalid JSON, wrong format, or a structurally bogus
    ``completed`` map.  ``None`` always means "empty frontier", which is
    safe (never wrong, at worst slow) because shard skipping re-verifies
    the actual output files against the recorded row crc."""
    try:
        with open(path) as f:
            m = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(m, dict) or m.get("format") != MANIFEST_FORMAT:
        return None
    done = m.get("completed")
    if not isinstance(done, dict):
        return None
    for k, v in done.items():
        if not (
            isinstance(k, str) and k.isdigit() and isinstance(v, dict)
            and isinstance(v.get("file"), str)
            and isinstance(v.get("rows"), int)
            and isinstance(v.get("crc32c"), int)
        ):
            return None
    return m


def write_manifest(path: str, manifest: dict) -> None:
    """Durable, atomic, retrying write (see module docstring)."""
    payload = json.dumps(manifest, indent=2, sort_keys=True)
    retry_io(
        lambda: atomic_write(path, "w", lambda f: f.write(payload + "\n")),
        desc=f"write {os.path.basename(path)}",
    )


def mark_completed(
    manifest: dict, shard_idx: int, filename: str, rows: int, crc: int
) -> None:
    manifest["completed"][str(shard_idx)] = {
        "file": filename,
        "rows": rows,
        "crc32c": crc,
    }
