"""Progress watchdog: detect a wedged run, dump, abort — the port's copy of
``sat_tpu.resilience.watchdog`` (without its telemetry gauges, trace flush
and black-box bundle, which are not ported).

A side thread watches phase *guards*: the train loop brackets each
region that could wedge with ``with wd.phase("dispatch"):`` (entry
records a host timestamp, exit clears it).  When an open phase outlives
its deadline the watchdog escalates: a warning, then a ``faulthandler``
all-thread stack dump to ``dump_path``, then after ``grace_s`` the
``pre_abort`` hook (bounded; the train loop passes the async checkpoint
writer's flush so ``LAST_GOOD`` lands) and an exit with
``WATCHDOG_EXIT_CODE``.  A phase's deadline is enforced only after the
phase has completed once, so a cold first step never trips it.  The
watchdog reads host clocks only, never the device.
"""

from __future__ import annotations

import faulthandler
import os
import sys
import threading
import time
from typing import Callable, Dict, Optional

# The JAX package's "wedged, state on disk is good, restart me" code.
WATCHDOG_EXIT_CODE = 86

OK, STALLED, DUMPED, ABORTING = 0, 1, 2, 3


class _PhaseGuard:
    """Context manager bracketing one instrumented region."""

    __slots__ = ("_wd", "_name")

    def __init__(self, wd: "Watchdog", name: str):
        self._wd = wd
        self._name = name

    def __enter__(self):
        self._wd._enter(self._name)
        return self

    def __exit__(self, *exc):
        self._wd._exit(self._name)
        return False


class Watchdog:
    """Observer thread enforcing per-phase progress deadlines.

    Parameters
    ----------
    deadlines: phase name -> seconds the phase may stay open once it has
        completed at least once.  Phases without an entry are tracked
        (visible in the stack dump) but never enforced.
    poll_s: observer wake-up cadence; detection latency is one poll.
    dump_path: where the faulthandler all-thread stack dump lands.
    pre_abort: best-effort callable run (bounded by ``grace_s``) before
        the abort — the train loop passes the async checkpoint writer's
        ``flush`` so LAST_GOOD lands before the process dies.
    abort: the final rung.  Defaults to ``os._exit(WATCHDOG_EXIT_CODE)``;
        tests inject a recorder.
    """

    def __init__(
        self,
        deadlines: Dict[str, float],
        *,
        poll_s: float = 1.0,
        grace_s: float = 2.0,
        dump_path: Optional[str] = None,
        pre_abort: Optional[Callable[[], None]] = None,
        abort: Optional[Callable[[int], None]] = None,
    ) -> None:
        self.deadlines = {k: v for k, v in deadlines.items() if v and v > 0}
        self.poll_s = max(0.05, poll_s)
        self.grace_s = max(0.0, grace_s)
        self.dump_path = dump_path
        self.pre_abort = pre_abort
        self._abort = abort if abort is not None else self._default_abort
        # phase name -> monotonic entry time; written by instrumented
        # threads, read by the observer.  Plain dict ops are atomic under
        # the GIL and a torn read here costs one poll of latency, not
        # correctness, so no lock on the hot path.
        self._active: Dict[str, float] = {}
        self._completed: Dict[str, bool] = {}
        self.state = OK
        self.stalled_phase: Optional[str] = None
        self.aborted_rc: Optional[int] = None  # set when abort is injected
        self._dumped_at: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # every deadline comparison reads this clock; tests swap in a
        # fake (use_clock) so stall/no-stall scenarios are exact instead
        # of racing wall time under suite load (the TenantRegistry
        # injectable-clock pattern)
        self._clock = time.monotonic

    def use_clock(self, clock: Callable[[], float]) -> "Watchdog":
        """Swap the monotonic time source (tests only)."""
        self._clock = clock
        return self

    # -- instrumentation (called from watched threads) ---------------------

    def phase(self, name: str) -> _PhaseGuard:
        return _PhaseGuard(self, name)

    def _enter(self, name: str) -> None:
        self._active[name] = self._clock()

    def _exit(self, name: str) -> None:
        self._active.pop(name, None)
        self._completed[name] = True
        if self.state != OK and self.stalled_phase == name:
            # the phase the ladder was climbing on just completed after
            # all — stand down (a dump may already have landed; that is
            # evidence, not damage)
            self.state = OK
            self.stalled_phase = None
            self._dumped_at = None

    # -- observer ----------------------------------------------------------

    def start(self) -> "Watchdog":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="sat-watchdog", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _overdue(self) -> Optional[tuple]:
        """(phase, seconds overdue) of the worst enforced open phase."""
        now = self._clock()
        worst = None
        for name, t0 in list(self._active.items()):
            deadline = self.deadlines.get(name)
            if deadline is None or not self._completed.get(name):
                continue
            over = (now - t0) - deadline
            if over > 0 and (worst is None or over > worst[1]):
                worst = (name, over)
        return worst

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            self.check()

    def check(self) -> None:
        """One observer tick (public so tests and the bench can drive the
        ladder without waiting on the poll clock)."""
        worst = self._overdue()
        if worst is None:
            if self.state != OK:
                self.state = OK
                self.stalled_phase = None
                self._dumped_at = None
            return
        name, over = worst
        if self.state == OK:
            self.state = STALLED
            self.stalled_phase = name
            print(
                f"sat_tpu_torch watchdog: phase {name!r} exceeded its "
                f"{self.deadlines[name]:g}s deadline by {over:.1f}s — "
                "escalating (stack dump next tick, then abort)",
                file=sys.stderr,
                flush=True,
            )
            return
        if self.state == STALLED:
            self.state = DUMPED
            self._dumped_at = self._clock()
            self._dump(name, over)
            return
        if self.state == DUMPED and (
            self._clock() - (self._dumped_at or 0.0) >= self.grace_s
        ):
            self.state = ABORTING
            print(
                f"sat_tpu_torch watchdog: phase {name!r} still wedged "
                f"{over:.1f}s past deadline — landing LAST_GOOD and "
                f"aborting with exit code {WATCHDOG_EXIT_CODE}",
                file=sys.stderr,
                flush=True,
            )
            self._run_pre_abort()
            self._abort(WATCHDOG_EXIT_CODE)

    # -- escalation rungs --------------------------------------------------

    def _dump(self, name: str, over: float) -> None:
        """Rung 2: all-thread stacks, best-effort."""
        if not self.dump_path:
            return
        try:
            os.makedirs(os.path.dirname(self.dump_path) or ".", exist_ok=True)
            with open(self.dump_path, "w") as f:
                f.write(
                    f"sat_tpu_torch watchdog stack dump: phase={name} "
                    f"overdue={over:.1f}s deadline={self.deadlines[name]:g}s "
                    f"pid={os.getpid()}\n"
                )
                f.flush()
                faulthandler.dump_traceback(file=f, all_threads=True)
            print(
                f"sat_tpu_torch watchdog: stack dump written to {self.dump_path}",
                file=sys.stderr,
                flush=True,
            )
        except Exception as e:
            print(f"sat_tpu_torch watchdog: stack dump failed: {e!r}", file=sys.stderr)

    def _run_pre_abort(self) -> None:
        """Rung 3 prologue: run ``pre_abort`` in a helper thread bounded
        by ``grace_s`` — the hook itself may be wedged (a checkpoint
        flush stuck on the same dead device), and the abort must not be."""
        if self.pre_abort is None:
            return
        done = threading.Event()

        def _run():
            try:
                self.pre_abort()
            except Exception as e:
                print(
                    f"sat_tpu_torch watchdog: pre-abort hook failed: {e!r}",
                    file=sys.stderr,
                    flush=True,
                )
            finally:
                done.set()

        t = threading.Thread(target=_run, name="sat-watchdog-preabort", daemon=True)
        t.start()
        if not done.wait(timeout=max(self.grace_s, 2.0)):
            print(
                "sat_tpu_torch watchdog: pre-abort hook wedged too — aborting anyway",
                file=sys.stderr,
                flush=True,
            )

    def _default_abort(self, code: int) -> None:
        self.aborted_rc = code
        sys.stderr.flush()
        sys.stdout.flush()
        os._exit(code)


def deadlines_from_config(config) -> Dict[str, float]:
    """The per-phase deadline map the train loop arms (seconds; a value
    of 0 disables that phase).  ``step`` brackets the whole loop body —
    the net that catches a wedge landing *between* finer-grained phases."""
    return {
        "step": config.watchdog_step_s,
        "data_wait": config.watchdog_data_wait_s,
        "dispatch": config.watchdog_dispatch_s,
        "checkpoint": config.watchdog_checkpoint_s,
    }
