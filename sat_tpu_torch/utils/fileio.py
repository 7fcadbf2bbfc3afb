"""Host-side file I/O — the port's copy of ``sat_tpu.utils.fileio``.

``atomic_write`` writes a durable artifact (results.json, score dumps,
the attention sheet) as a tmp file plus a rename, with the final mode
honoring the process umask, so a preempted process never leaves a torn
file.  ``read_text``/``read_json`` are the read-side twins for small
inputs (caption JSONs): a transient IO error (EIO, EAGAIN, ESTALE and
kin, the hiccups of a network mount) is retried with jittered
exponential backoff; a missing file or a permission error raises at once.
"""

from __future__ import annotations

import errno
import json
import os
import random
import sys
import tempfile
import time
from typing import IO, Any, Callable

_MAX_DELAY_S = 2.0
# process-wide, set once from Config (``io_retries``, ``io_retry_base_s``)
# by the CLI, as the JAX package does
_defaults = {"retries": 3, "base_delay_s": 0.05}

_RETRYABLE_ERRNOS = frozenset(
    getattr(errno, name)
    for name in (
        "EIO", "EAGAIN", "EBUSY", "EINTR", "ETIMEDOUT", "ESTALE",
        "ENETDOWN", "ENETUNREACH", "ENETRESET", "ECONNRESET",
        "ECONNABORTED", "EREMOTEIO",
    )
    if hasattr(errno, name)
)
_FATAL_OSERROR_TYPES = (
    FileNotFoundError, PermissionError, IsADirectoryError,
    NotADirectoryError, FileExistsError,
)
_jitter_rng = random.Random(0x5A7)


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


def configure_retries(retries: int, base_delay_s: float) -> None:
    """Install the process-wide retry budget and first backoff delay."""
    _defaults["retries"] = max(0, int(retries))
    _defaults["base_delay_s"] = float(base_delay_s)


def _retryable(exc: BaseException) -> bool:
    """Transient transport trouble (worth a second attempt) against a
    wrong program or environment (never retried)."""
    if not isinstance(exc, OSError) or isinstance(exc, _FATAL_OSERROR_TYPES):
        return False
    if isinstance(exc, (TimeoutError, BlockingIOError, InterruptedError, ConnectionError)):
        return True
    return exc.errno in _RETRYABLE_ERRNOS


def read_text(path: str, desc: str = "") -> str:
    """Read a small text file, retrying transient IO errors (by default
    three times; backoff 50 ms doubling, capped at 2 s, jittered ×0.5–1.5)."""
    budget = _defaults["retries"]
    for attempt in range(budget + 1):
        try:
            with open(path) as f:
                return f.read()
        except OSError as e:
            if not _retryable(e) or attempt == budget:
                raise
            delay = min(_defaults["base_delay_s"] * 2.0 ** attempt, _MAX_DELAY_S)
            delay *= _jitter_rng.uniform(0.5, 1.5)
            print(
                f"sat_tpu_torch: transient IO error on {desc or f'read {path}'} "
                f"(attempt {attempt + 1}/{budget + 1}): {e} — retrying in "
                f"{delay * 1e3:.0f} ms",
                file=sys.stderr,
                flush=True,
            )
            time.sleep(delay)
    raise AssertionError("unreachable")


def read_json(path: str, desc: str = "") -> Any:
    """``read_text`` + ``json.loads``."""
    return json.loads(read_text(path, desc=desc or f"read json {path}"))
