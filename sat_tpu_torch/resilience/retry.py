"""Retrying host IO — the port's copy of ``sat_tpu.resilience.retry``.

``retry_io`` wraps the durable-IO call sites (checkpoint reads and
writes, caption-file reads) with bounded retries, exponential backoff
and jitter.  Errors that signal a wrong program or environment (missing
file, permission, a path that is a directory) raise at once; transient
transport errors (EIO, EAGAIN, ESTALE and kin, the hiccups of a network
mount) back off and retry; anything that is not an ``OSError``
propagates untouched.  Every attempt first passes the
``SAT_FI_IO_FAILURES`` injection hook (``resilience.faultinject``); each
retry counts ``io/retries`` on the telemetry registry.
"""

from __future__ import annotations

import errno
import random
import sys
import time
from typing import Callable, Optional, Tuple, TypeVar

from .. import telemetry
from .faultinject import consume_io_fault

T = TypeVar("T")

RETRYABLE_ERRNOS = frozenset(
    getattr(errno, name)
    for name in (
        "EIO", "EAGAIN", "EBUSY", "EINTR", "ETIMEDOUT", "ESTALE",
        "ENETDOWN", "ENETUNREACH", "ENETRESET", "ECONNRESET",
        "ECONNABORTED", "EREMOTEIO",
    )
    if hasattr(errno, name)
)

FATAL_OSERROR_TYPES = (
    FileNotFoundError, PermissionError, IsADirectoryError,
    NotADirectoryError, FileExistsError,
)

# process-wide, set once from Config (``io_retries``, ``io_retry_base_s``)
_defaults = {"retries": 3, "base_delay_s": 0.05}

# jitter decorrelates processes; a fixed seed keeps one process's runs
# reproducible
_jitter_rng = random.Random(0x5A7)


def configure(retries: Optional[int] = None, base_delay_s: Optional[float] = None) -> None:
    """Install the process-wide retry budget and first backoff delay."""
    if retries is not None:
        _defaults["retries"] = max(0, int(retries))
    if base_delay_s is not None:
        _defaults["base_delay_s"] = float(base_delay_s)


def backoff_delay(
    attempt: int,
    *,
    base_delay_s: float,
    max_delay_s: float = 2.0,
    jitter: Tuple[float, float] = (0.5, 1.5),
    rng: Optional[random.Random] = None,
) -> float:
    """``base * 2**attempt`` capped at ``max_delay_s``, scaled by a uniform
    draw from ``jitter`` (from ``rng``, else the module's own generator).
    Shared by :func:`retry_io` and the crash-only supervisor."""
    delay = min(float(base_delay_s) * (2.0 ** attempt), max_delay_s)
    return delay * (rng or _jitter_rng).uniform(*jitter)


def is_retryable(exc: BaseException) -> bool:
    """Transient (worth another attempt) against fatal."""
    if not isinstance(exc, OSError) or isinstance(exc, FATAL_OSERROR_TYPES):
        return False
    if isinstance(exc, (TimeoutError, BlockingIOError, InterruptedError, ConnectionError)):
        return True
    return exc.errno in RETRYABLE_ERRNOS


def retry_io(
    fn: Callable[[], T],
    *,
    desc: str,
    retries: Optional[int] = None,
    base_delay_s: Optional[float] = None,
    max_delay_s: float = 2.0,
) -> T:
    """``fn()`` with up to ``retries`` retries on transient IO errors (by
    default three; backoff 50 ms doubling, capped at 2 s, jittered
    ×0.5–1.5).  ``desc`` names the operation in the warnings and is what
    ``SAT_FI_IO_FAILURES=n:substr`` matches against."""
    budget = _defaults["retries"] if retries is None else max(0, int(retries))
    base = _defaults["base_delay_s"] if base_delay_s is None else float(base_delay_s)
    for attempt in range(budget + 1):
        try:
            consume_io_fault(desc)
            return fn()
        except OSError as e:
            if not is_retryable(e) or attempt == budget:
                raise
            telemetry.count("io/retries")
            delay = backoff_delay(attempt, base_delay_s=base, max_delay_s=max_delay_s)
            print(
                f"sat_tpu_torch: transient IO error on {desc} (attempt {attempt + 1}/"
                f"{budget + 1}): {e} — retrying in {delay * 1e3:.0f} ms",
                file=sys.stderr,
                flush=True,
            )
            time.sleep(delay)
    raise AssertionError("unreachable")
