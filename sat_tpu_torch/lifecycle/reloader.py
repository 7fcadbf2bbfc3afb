"""LAST_GOOD pointer watcher — the lifecycle plane's trigger.

The port's copy of ``sat_tpu.lifecycle.reloader``.

A background thread polls the lineage ``LAST_GOOD`` pointer (mtime is
not trusted alone — the pointer is an atomic rename, so content is
re-read every poll; both are one tiny file read) with a jittered
interval so a fleet of replicas sharing one save_dir doesn't thundering-
herd the filesystem.  When the pointer names a NEW step that is neither
the currently served one nor in the rejection ledger, ``on_new(step,
path)`` fires — at most once per distinct step, however long the load
it triggers takes.

Jax-free: polling and firing are host IO; the loading it triggers
happens in the controller's cycle thread.
"""

from __future__ import annotations

import os
import random
import sys
import threading
from typing import Callable, Optional

from ..resilience import lineage


class Reloader:
    """Watch ``save_dir``'s LAST_GOOD pointer; fire ``on_new`` on change.

    ``current_step`` is a callable returning the step being served (the
    engine moves it on promote, so the reloader never re-fires for the
    checkpoint that just won).  ``poll_once`` is the unit-testable core;
    the thread is just poll_once on a jittered timer.
    """

    def __init__(
        self,
        save_dir: str,
        interval_s: float,
        on_new: Callable[[int, str], None],
        current_step: Optional[Callable[[], int]] = None,
        tel=None,
        jitter: float = 0.2,
    ) -> None:
        from .. import telemetry

        self.save_dir = save_dir
        self.interval_s = float(interval_s)  # sync-ok: host config scalar
        self.on_new = on_new
        self.current_step = current_step
        self.jitter = float(jitter)  # sync-ok: host config scalar
        self._tel = tel if tel is not None else telemetry.get()
        self._seen: Optional[int] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- the poll (unit-tested directly) -----------------------------------

    def poll_once(self) -> Optional[int]:
        """One pointer read.  Returns the step fired, or None when the
        pointer is absent, unchanged, rejected, or already serving."""
        step = lineage.last_good_step(self.save_dir)
        if step is None or step == self._seen:
            return None
        # mark seen BEFORE any skip decision: a rejected or already-
        # serving step must not be re-examined every poll
        self._seen = step
        if self.current_step is not None and step == self.current_step():
            return None
        if lineage.is_rejected(self.save_dir, step):
            self._tel.count("lifecycle/skipped_rejected")
            print(
                f"sat_tpu_torch: lifecycle reloader skipping step {step} — in "
                "the rejection ledger",
                file=sys.stderr,
                flush=True,
            )
            return None
        path = os.path.join(self.save_dir, f"{step}.npz")
        self._tel.count("lifecycle/reloads_triggered")
        self.on_new(step, path)
        return step

    def mark_seen(self, step: int) -> None:
        """Startup bookkeeping: the checkpoint loaded at boot must not
        immediately re-trigger a canary of itself."""
        self._seen = int(step)

    # -- the thread --------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            # jittered sleep FIRST: the server just loaded this pointer's
            # target at startup, so an immediate poll is always a no-op
            delay = self.interval_s * random.uniform(
                1 - self.jitter, 1 + self.jitter
            )
            if self._stop.wait(timeout=max(0.01, delay)):
                return
            try:
                self.poll_once()
            except Exception as e:  # polling must never die
                print(
                    f"sat_tpu_torch: lifecycle reloader poll failed: {e}",
                    file=sys.stderr,
                    flush=True,
                )

    def start(self) -> "Reloader":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="sat-lifecycle-reloader", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
