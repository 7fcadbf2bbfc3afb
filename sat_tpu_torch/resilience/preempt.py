"""Graceful preemption: SIGTERM/SIGINT → stop at the next step boundary — the
port's copy of ``sat_tpu.resilience.preempt``.

Schedulers preempt with a SIGTERM and a grace window; dying mid-step
wastes everything since the last periodic checkpoint.  ``GracefulShutdown``
converts the first signal into a flag the train loop polls at each step
boundary, so the loop can flush a final checkpoint through the async
writer and return cleanly (exit 0 — the supervisor relaunches straight
into the resume path).  A second signal restores the previous handler's
behavior, so an operator's double Ctrl-C still kills a wedged run.

Signal handlers can only be installed from the main thread; elsewhere
(tests driving ``train()`` from a worker thread, notebook kernels) the
context manager degrades to an inert flag — polling still works, nothing
raises.

The ``defer()`` window protects the one place a second signal used to be
able to do real damage: the final checkpoint flush + landing verify.  A
force-kill signal arriving inside ``with shutdown.defer():`` is held —
recorded, acknowledged on stderr — and the previous handler's behavior
runs only when the window closes, so a perfectly-timed double-SIGTERM can
no longer race the write between rename and verify.
"""

from __future__ import annotations

import contextlib
import signal
import sys
import threading
from typing import Optional


class GracefulShutdown:
    """Context manager; ``stop_requested`` flips on the first SIGTERM or
    SIGINT and the previous handlers come back on exit."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self):
        self._stop = threading.Event()
        self._previous = {}
        self._installed = False
        self._deferred = 0
        self._pending_force: Optional[int] = None
        self.signal_name: Optional[str] = None

    @property
    def stop_requested(self) -> bool:
        return self._stop.is_set()

    @contextlib.contextmanager
    def defer(self):
        """Critical-write window: a force-kill (second) signal delivered
        inside is held until the window closes, so it cannot interrupt a
        checkpoint flush between rename and verify.  Re-entrant; the held
        signal fires when the outermost window exits."""
        self._deferred += 1
        try:
            yield self
        finally:
            self._deferred -= 1
            if self._deferred == 0 and self._pending_force is not None:
                signum = self._pending_force
                self._pending_force = None
                self._force(signum, None)

    def _force(self, signum, frame):
        # fall through to the original disposition (usually
        # KeyboardInterrupt / death)
        previous = self._previous.get(signum)
        if callable(previous):
            previous(signum, frame)
        elif previous == signal.SIG_DFL:
            signal.signal(signum, signal.SIG_DFL)
            signal.raise_signal(signum)

    def _handler(self, signum, frame):
        if self._stop.is_set():
            # second signal: operator means it — but never mid-flush; a
            # deferred window holds the force-kill until the checkpoint
            # write verifies, then lets it land
            if self._deferred > 0:
                self._pending_force = signum
                print(
                    "sat_tpu_torch: force-stop signal held until the in-flight "
                    "checkpoint write verifies",
                    file=sys.stderr,
                    flush=True,
                )
                return
            self._force(signum, frame)
            return
        self._stop.set()
        self.signal_name = signal.Signals(signum).name
        print(
            f"sat_tpu_torch: caught {self.signal_name} — finishing the current "
            "step, flushing a final checkpoint, then exiting cleanly "
            "(signal again to force)",
            file=sys.stderr,
            flush=True,
        )

    def __enter__(self) -> "GracefulShutdown":
        if threading.current_thread() is threading.main_thread():
            for sig in self.SIGNALS:
                self._previous[sig] = signal.signal(sig, self._handler)
            self._installed = True
        return self

    def __exit__(self, *exc) -> None:
        if self._installed:
            for sig, previous in self._previous.items():
                try:
                    signal.signal(sig, previous)
                except (ValueError, OSError):  # interpreter shutting down
                    pass
            self._installed = False
        return None
