"""Host-side file I/O — the port's copy of ``sat_tpu.utils.fileio``.

``atomic_write`` writes a durable artifact (results.json, score dumps,
the attention sheet) as a tmp file plus a rename, with the final mode
honoring the process umask, so a preempted process never leaves a torn
file.  ``read_text``/``read_json`` are the read-side twins for small
inputs (caption JSONs), retried on transient IO errors by
``resilience.retry``.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import IO, Any, Callable

from ..resilience.retry import retry_io


def atomic_write(path: str, mode: str, writer: Callable[[IO], None]) -> None:
    """Write ``path`` atomically: ``writer(f)`` into a tmp file in the same
    directory, fchmod to umask-derived permissions, then ``os.replace``.

    ``mode`` is 'w' (text) or 'wb' (binary).
    """
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        umask = os.umask(0)
        os.umask(umask)
        os.fchmod(fd, 0o666 & ~umask)
        with os.fdopen(fd, mode) as f:
            writer(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def read_text(path: str, desc: str = "") -> str:
    """Read a small text file through ``resilience.retry.retry_io``."""

    def read() -> str:
        with open(path) as f:
            return f.read()

    return retry_io(read, desc=desc or f"read {path}")


def read_json(path: str, desc: str = "") -> Any:
    """``read_text`` + ``json.loads``."""
    return json.loads(read_text(path, desc=desc or f"read json {path}"))
