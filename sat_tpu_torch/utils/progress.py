"""Per-batch progress reporting for the train loop — the port's copy of
``sat_tpu.utils.progress``.

The reference tqdm-bars every loop (its base_model.py:49-50, 82, 131);
this is the dependency-free equivalent.  On a tty it redraws one
``\\r`` status line (rate-limited so the hot loop never stalls on
stderr); on a non-tty (batch logs, CI) it prints a full line every
``every`` items plus a final one, so long runs stay observable without
megabytes of log spam.

Deliberately metric-free: fetching a loss for the bar would sync with
the device every step.
"""

from __future__ import annotations

import sys
import time
from typing import Iterable, Iterator, Optional, TextIO


class Progress:
    def __init__(
        self,
        total: int,
        desc: str = "",
        stream: Optional[TextIO] = None,
        every: Optional[int] = None,
        initial: int = 0,
        min_interval_s: float = 0.1,
    ):
        self.total = total
        self.desc = desc
        self.stream = stream if stream is not None else sys.stderr
        self.every = every if every else max(1, total // 20)
        self.count = initial
        self._initial = initial  # resume cursor: not work done by this run
        self._t0 = time.perf_counter()
        self._last_draw = 0.0
        self._min_interval = min_interval_s
        self._tty = bool(getattr(self.stream, "isatty", lambda: False)())
        self._drew = False

    def _line(self) -> str:
        elapsed = time.perf_counter() - self._t0
        done = self.count - self._initial
        rate = done / elapsed if elapsed > 0 else 0.0
        return (
            f"{self.desc}: {self.count}/{self.total} "
            f"[{elapsed:.0f}s, {rate:.2f} it/s]"
        )

    def update(self, n: int = 1) -> None:
        self.count += n
        now = time.perf_counter()
        if self._tty:
            if now - self._last_draw >= self._min_interval or self.count >= self.total:
                self.stream.write("\r" + self._line())
                self.stream.flush()
                self._last_draw = now
                self._drew = True
        elif self.count % self.every == 0:
            self.stream.write(self._line() + "\n")
            self.stream.flush()

    def close(self) -> None:
        if self._tty:
            if self._drew:
                self.stream.write("\r" + self._line() + "\n")
                self.stream.flush()
        elif self.count % self.every != 0:
            # final line unless update() just printed this exact count
            self.stream.write(self._line() + "\n")
            self.stream.flush()

    def __enter__(self) -> "Progress":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def track(
    iterable: Iterable,
    total: int,
    desc: str = "",
    stream: Optional[TextIO] = None,
    every: Optional[int] = None,
) -> Iterator:
    """Wrap an iterable with a Progress bar (the tqdm call-shape)."""
    with Progress(total, desc, stream=stream, every=every) as bar:
        for item in iterable:
            yield item
            bar.update()
