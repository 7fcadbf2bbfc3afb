"""Checkpoint lineage — the port's copy of ``sat_tpu.resilience.lineage``.

Layout of a save_dir (the JAX package's)::

    save_dir/
      1500.npz  1500.npz.sha256     # sha256 sidecar, optional JSON meta line
      LAST_GOOD                      # text: "1500\\n"
      config.json                    # step-stamped Config sidecar
      REJECTED                       # JSONL: steps the lifecycle refused
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import sys
import zipfile
from typing import List, Optional, Tuple

LAST_GOOD_NAME = "LAST_GOOD"
REJECTED_NAME = "REJECTED"
SIDECAR_SUFFIX = ".sha256"

_STEP_RE = re.compile(r"(\d+)\.npz")


class CheckpointWriteError(RuntimeError):
    """A checkpoint the training loop depended on did not land (a queued
    async write failed, or the final save failed verification)."""


def _atomic_write_text(path: str, text: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def checkpoint_steps(save_dir: str) -> List[int]:
    """Sorted steps of the real ``<step>.npz`` files under ``save_dir``:
    non-empty regular files only (temps, sidecars and husks are skipped)."""
    steps = []
    if not os.path.isdir(save_dir):
        return steps
    for fn in os.listdir(save_dir):
        m = _STEP_RE.fullmatch(fn)
        if not m:
            continue
        path = os.path.join(save_dir, fn)
        try:
            if not os.path.isfile(path) or os.path.getsize(path) == 0:
                continue
        except OSError:
            continue
        steps.append(int(m.group(1)))
    return sorted(set(steps))


def sidecar_path(ckpt_path: str) -> str:
    return ckpt_path + SIDECAR_SUFFIX


def file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def write_sidecar(
    ckpt_path: str, vocab: Optional[dict] = None, topology: Optional[dict] = None
) -> str:
    """Hash the checkpoint into its sidecar; ``vocab`` (the vocabulary
    fingerprint) and ``topology`` (the devices it was written from) ride
    one JSON line after the digest, as in the JAX package."""
    digest = file_sha256(ckpt_path)
    lines = f"{digest}  {os.path.basename(ckpt_path)}\n"
    meta = {k: v for k, v in (("topology", topology), ("vocab", vocab)) if v}
    if meta:
        lines += json.dumps(meta, sort_keys=True) + "\n"
    _atomic_write_text(sidecar_path(ckpt_path), lines)
    return digest


def read_sidecar_meta(ckpt_path: str) -> dict:
    """The sidecar's JSON metadata record, or {} when there is none."""
    try:
        with open(sidecar_path(ckpt_path)) as f:
            for line in f.read().splitlines()[1:]:
                line = line.strip()
                if line.startswith("{"):
                    return json.loads(line)
    except (OSError, ValueError):
        return {}
    return {}


def verify_checkpoint(ckpt_path: str) -> Tuple[bool, str]:
    """Is ``ckpt_path`` restorable?  (ok, reason).  sha256 against the
    sidecar when there is one, else every zip member's CRC."""
    if not os.path.isfile(ckpt_path):
        return False, "missing"
    try:
        if os.path.getsize(ckpt_path) == 0:
            return False, "empty file"
        sc = sidecar_path(ckpt_path)
        if os.path.isfile(sc):
            with open(sc) as f:
                want = (f.read().split() or [""])[0]
            got = file_sha256(ckpt_path)
            if got != want:
                return False, f"sha256 mismatch (sidecar {want[:12]}…, file {got[:12]}…)"
            return True, "sha256 ok"
        with zipfile.ZipFile(ckpt_path) as z:
            bad = z.testzip()
            if bad is not None:
                return False, f"corrupt member {bad}"
        return True, "zip crc ok (no sidecar)"
    except (OSError, zipfile.BadZipFile, ValueError) as e:
        return False, f"unreadable: {e}"


def mark_last_good(save_dir: str, step: int) -> None:
    _atomic_write_text(os.path.join(save_dir, LAST_GOOD_NAME), f"{int(step)}\n")


def last_good_step(save_dir: str) -> Optional[int]:
    try:
        with open(os.path.join(save_dir, LAST_GOOD_NAME)) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


def last_good_checkpoint(save_dir: str) -> Optional[str]:
    """The newest checkpoint that verifies, at or below the ``LAST_GOOD``
    pointer when there is one (walking back past rotted files); None when
    no candidate verifies."""
    pointed = last_good_step(save_dir)
    candidates = checkpoint_steps(save_dir)
    if pointed is not None:
        candidates = [s for s in candidates if s <= pointed]
    for step in sorted(candidates, reverse=True):
        path = os.path.join(save_dir, f"{step}.npz")
        ok, reason = verify_checkpoint(path)
        if ok:
            return path
        print(
            f"sat_tpu_torch: last-good candidate {path} rejected ({reason}); walking back",
            file=sys.stderr,
            flush=True,
        )
    return None


def _rejected_path(save_dir: str) -> str:
    return os.path.join(save_dir, REJECTED_NAME)


def rejected_steps(save_dir: str) -> set:
    """Steps the lifecycle controller has permanently rejected (failed
    canary, vocab mismatch, shape drift).  A rejected step is never
    re-canaried even if LAST_GOOD still points at it."""
    steps = set()
    try:
        with open(_rejected_path(save_dir)) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    steps.add(int(json.loads(line)["step"]))
                except (ValueError, KeyError, TypeError):
                    continue
    except OSError:
        pass
    return steps


def is_rejected(save_dir: str, step: int) -> bool:
    return int(step) in rejected_steps(save_dir)


def mark_rejected(save_dir: str, step: int, reason: str) -> bool:
    """Append ``step`` to the rejection ledger (one JSON line an entry).
    Exactly once: False without writing when the step is already there.
    A torn tail line (a crashed append) is skipped by the reader, and the
    next append starts on a fresh line."""
    step = int(step)
    if is_rejected(save_dir, step):
        return False
    record = json.dumps({"step": step, "reason": str(reason)}, sort_keys=True)
    path = _rejected_path(save_dir)
    prefix = ""
    try:
        with open(path, "rb") as f:
            f.seek(-1, os.SEEK_END)
            if f.read(1) != b"\n":
                prefix = "\n"
    except (OSError, ValueError):
        pass
    with open(path, "a") as f:
        f.write(prefix + record + "\n")
        f.flush()
        os.fsync(f.fileno())
    return True


def apply_retention(save_dir: str, keep: int) -> List[str]:
    """Keep the newest ``keep`` checkpoints and the ``LAST_GOOD`` target,
    delete the rest with their sidecars (``keep`` <= 0 keeps everything).
    Returns the deleted paths."""
    if keep <= 0:
        return []
    steps = checkpoint_steps(save_dir)
    protect = set(steps[-keep:])
    pointed = last_good_step(save_dir)
    if pointed is not None:
        protect.add(pointed)
    deleted = []
    for step in steps:
        if step in protect:
            continue
        path = os.path.join(save_dir, f"{step}.npz")
        for victim in (path, sidecar_path(path)):
            try:
                os.unlink(victim)
                deleted.append(victim)
            except FileNotFoundError:
                pass
            except OSError as e:  # retention must never kill training
                print(f"sat_tpu_torch: retention could not delete {victim}: {e}",
                      file=sys.stderr, flush=True)
    return deleted


def finalize_save(save_dir: str, path: str, step: int, healthy: bool, keep: int) -> bool:
    """The lineage tail of a save: (sidecar when none) → verify →
    ``LAST_GOOD`` advanced only when the file verified and the run was
    ``healthy`` → retention.  Returns whether the file verified; a failed
    verify is reported, not raised: the previous ``LAST_GOOD`` stays the
    recovery point.  An existing sidecar is trusted, never rewritten: it
    was hashed right after the write, and hashing again would bless any
    rot since."""
    if not os.path.isfile(sidecar_path(path)):
        write_sidecar(path)
    ok, reason = verify_checkpoint(path)
    if not ok:
        print(f"sat_tpu_torch: checkpoint {path} FAILED post-write verification ({reason}); "
              "LAST_GOOD not advanced", file=sys.stderr, flush=True)
    elif not healthy:
        print(f"sat_tpu_torch: checkpoint {path} written while metrics were anomalous; "
              "LAST_GOOD not advanced", file=sys.stderr, flush=True)
    else:
        mark_last_good(save_dir, step)
    apply_retention(save_dir, keep)
    return ok
