"""On-demand profiler windows: bounded live captures without a restart —
``sat_tpu.telemetry.profwin``'s ``ProfileLatch`` on ``torch.profiler``.

``POST /profile?duration_ms=`` on the caption server starts a capture of
a *running* process, for when the thing to look at is happening now.
The safety contract is the JAX package's:

* **one capture at a time** — the profiler keeps process-wide state (on
  a card, CUPTI's activity buffers), so the latch refuses a second start
  (serve maps the refusal to HTTP 409) instead of corrupting the first;
* **hard duration cap** (:data:`HARD_CAP_MS`) — requests clamp, silently;
* **degrade-don't-raise** — a profiler that fails to start releases the
  latch and reports the reason; a capture never takes the server down.

A capture records CPU activity and, when ``device`` is a card, CUDA
activity, and lands in ``<base_dir>/profiles/<stamp>/trace.json`` (a
Chrome trace from ``export_chrome_trace``; Perfetto loads it).  The
profiler session is thread-bound (it is stopped on the thread that
started it), so each capture runs on its own thread, which starts the
profiler, waits out the window (or ``stop_now``) and stops and exports
it.  Device activity is the card's, whichever thread launched it; CPU
operators are recorded on the capture thread alone, so the batcher's
host work shows in the serve spans, not here.  The train phase's
``SIGUSR2`` trigger is not ported.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Optional, Tuple

# no live window may exceed one minute
HARD_CAP_MS = 60_000.0
MIN_MS = 1.0

DEFAULT_WINDOW_MS = 2000.0

TRACE_FILE = "trace.json"


class ProfileLatch:
    """Single-capture-at-a-time gate over ``torch.profiler`` live traces.
    ``device`` is the engine's device: a CUDA device adds device
    activity to the capture."""

    def __init__(self, base_dir: str, device=None) -> None:
        self.base_dir = base_dir
        self.device = device
        self._lock = threading.Lock()
        self._active_dir: Optional[str] = None
        self._stop: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None
        self.captures = 0  # completed-or-started count, for stats

    @property
    def busy(self) -> bool:
        with self._lock:
            return self._active_dir is not None

    def _activities(self):
        from torch.profiler import ProfilerActivity

        acts = [ProfilerActivity.CPU]
        if self.device is not None and getattr(self.device, "type", str(self.device)) == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return acts

    def start(self, duration_ms: Optional[float] = None) -> Tuple[bool, str]:
        """Begin a bounded capture; returns ``(ok, path_or_reason)``.

        ``(False, reason)`` when a capture is already running (the 409
        path) or the profiler failed to start (degraded, latch released).
        The capture stops itself after the (clamped) duration."""
        if duration_ms is None:
            duration_ms = DEFAULT_WINDOW_MS
        duration_ms = min(max(duration_ms, MIN_MS), HARD_CAP_MS)
        stamp = time.strftime("%Y%m%d-%H%M%S") + f"-{int(time.time() * 1e3) % 1000:03d}"
        out_dir = os.path.join(self.base_dir, "profiles", stamp)
        with self._lock:
            if self._active_dir is not None:
                return False, "capture already in progress"
            self._active_dir = out_dir  # reserve before the slow start
        started = threading.Event()
        stop = threading.Event()
        box = {}
        thread = threading.Thread(
            target=self._capture, args=(out_dir, duration_ms / 1e3, started, stop, box),
            name="sat-torch-profile", daemon=True,
        )
        thread.start()
        started.wait()
        if "error" in box:  # degrade: the latch is released, report why
            reason = f"profiler start failed: {box['error']}"
            print(f"sat_tpu_torch: {reason}", file=sys.stderr, flush=True)
            return False, reason
        with self._lock:
            self._stop, self._thread = stop, thread
            self.captures += 1
        return True, out_dir

    def _capture(self, out_dir: str, seconds: float, started, stop, box) -> None:
        prof = None
        try:
            try:
                os.makedirs(out_dir, exist_ok=True)
                from torch.profiler import profile

                prof = profile(activities=self._activities())
                prof.__enter__()
            except Exception as e:
                box["error"] = e
                prof = None
            finally:
                started.set()
            if prof is None:
                return
            stop.wait(timeout=seconds)
            try:
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(os.path.join(out_dir, TRACE_FILE))
            except Exception as e:
                print(f"sat_tpu_torch: profiler stop failed: {e}", file=sys.stderr, flush=True)
        finally:
            with self._lock:
                self._active_dir = None
                self._stop = self._thread = None

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until the running capture (if any) is written."""
        with self._lock:
            thread = self._thread
        if thread is not None:
            thread.join(timeout=timeout)

    def stop_now(self) -> None:
        """End an active capture early (shutdown path); no-op when idle."""
        with self._lock:
            stop, thread = self._stop, self._thread
        if stop is not None:
            stop.set()
        if thread is not None:
            thread.join(timeout=60.0)
