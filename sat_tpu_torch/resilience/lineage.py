"""Checkpoint lineage — the port's copy of the read side of
``sat_tpu.resilience.lineage``, plus the two writes a serving fixture needs.

Layout of a save_dir (the JAX package's)::

    save_dir/
      1500.npz  1500.npz.sha256     # sha256 sidecar, optional JSON meta line
      LAST_GOOD                      # text: "1500\\n"
      config.json                    # step-stamped Config sidecar
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
SIDECAR_SUFFIX = ".sha256"

_STEP_RE = re.compile(r"(\d+)\.npz")


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


def write_sidecar(ckpt_path: str, vocab: Optional[dict] = None) -> str:
    """Hash the checkpoint into its sidecar; ``vocab`` (the vocabulary
    fingerprint) rides a JSON line after the digest, as in the JAX
    package."""
    digest = file_sha256(ckpt_path)
    lines = f"{digest}  {os.path.basename(ckpt_path)}\n"
    if vocab:
        lines += json.dumps({"vocab": vocab}, sort_keys=True) + "\n"
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
