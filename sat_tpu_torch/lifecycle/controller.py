"""Lifecycle controller: the reload → canary → promote/rollback machine.

The port's copy of ``sat_tpu.lifecycle.controller``.

One controller per serve process owns the whole lifecycle plane::

    IDLE ──new LAST_GOOD──▶ LOADING ──▶ WARMING ──▶ CANARY
      ▲                        │            │          │
      │     (reject→ledger)────┴────────────┘     window elapsed /
      │                                           SLO burn / operator
      ├────────── ROLLING_BACK ◀──────────────────────┤
      └────────── PROMOTING ◀─────────────────────────┘

* LOADING: host-side candidate load (``lifecycle.loader``) — integrity,
  vocab fingerprint, quantize-once, full-coverage device placement.
* WARMING: ``engine.install_candidate`` (tree/shape/dtype gate against
  the warmed executables' avals) + ``batcher.lifecycle_control
  ("arm_canary")`` (continuous mode clones the warmed slot pool — zero
  new compiles; batch mode needs nothing).  Any raise on this path is a
  **rejection**: the step lands in the lineage ledger exactly once and
  the reloader never re-canaries it.
* CANARY: a per-cycle SLO engine (phase ``canary``, windows clipped to
  the canary window) ticks over canary-slot traffic; a shadow worker
  duplicates a sample of incumbent requests onto the candidate and
  feeds the caption-divergence gauge.  Exits on: SLO burn → rollback;
  window elapsed → promote (``promote_policy=auto``) or hold for the
  operator (``manual``); POST /promote / /rollback → as told.
* PROMOTING: the batcher flips the active slot at its admission
  boundary (in-flight work finishes under the params it started with);
  the measured no-admission gap is ``lifecycle/swap_blackout_ms``.
* ROLLING_BACK: canary traffic drains, the candidate slot clears, the
  ledger records the step.  The incumbent never stopped serving.

The controller itself is jax-free (loading happens behind the loader's
deferred imports) so the state machine is unit-testable with stub
engines/batchers on hosts with no accelerator.
"""

from __future__ import annotations

import os
import queue
import sys
import threading
import time
from typing import Any, Dict, Optional, Tuple

from ..resilience import lineage
from ..telemetry.slo import SLOEngine, objectives_from_config
from . import canary
from .loader import load_candidate
from .reloader import Reloader

STATES = (
    "IDLE",
    "LOADING",
    "WARMING",
    "CANARY",
    "PROMOTING",
    "ROLLING_BACK",
)
# numeric encoding for the lifecycle/state gauge (promtext has no labels)
STATE_CODES = {name: i for i, name in enumerate(STATES)}


class LifecycleController:
    """Owns the reloader, the canary scorer, and the promote/rollback
    decisions for one serve process."""

    def __init__(
        self,
        config,
        engine,
        batcher,
        tel=None,
        save_dir: Optional[str] = None,
        clock=time.monotonic,
    ) -> None:
        from .. import telemetry

        self.config = config
        self.engine = engine
        self.batcher = batcher
        self.save_dir = save_dir if save_dir is not None else config.save_dir
        self._tel = tel if tel is not None else telemetry.get()
        self._clock = clock
        self._state = "IDLE"
        self._lock = threading.Lock()
        self._stopping = threading.Event()
        self.reloader: Optional[Reloader] = None
        # decision channel: ("promote"|"rollback"|"abort", why) set by
        # the operator endpoints / shutdown; read by the cycle thread
        self._decision: Optional[Tuple[str, str]] = None
        self._cycle_thread: Optional[threading.Thread] = None
        self._cycle_done = threading.Event()
        self._cycle_done.set()
        self._cycle: Optional[Dict[str, Any]] = None
        self._last: Optional[Dict[str, Any]] = None
        self._canary_slo: Optional[SLOEngine] = None
        self._divergence = canary.DivergenceGauge()
        # shadow sampling: deterministic every-nth counter, one worker
        self._shadow_seen = 0
        self._shadow_q: "queue.Queue" = queue.Queue(maxsize=8)
        self._shadow_thread: Optional[threading.Thread] = None

    # -- state -------------------------------------------------------------

    @property
    def state(self) -> str:
        return self._state

    def _set_state(self, state: str) -> None:
        self._state = state
        self._tel.gauge("lifecycle/state", STATE_CODES[state])

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "LifecycleController":
        self._set_state("IDLE")
        if self.config.model_reload > 0:
            self.reloader = Reloader(
                self.save_dir,
                self.config.model_reload,
                self._on_new,
                current_step=lambda: self.engine.step,
                tel=self._tel,
            )
            # the checkpoint loaded at boot must not canary itself
            boot = lineage.last_good_step(self.save_dir)
            if boot is not None and boot == self.engine.step:
                self.reloader.mark_seen(boot)
            self.reloader.start()
        if self._shadow_thread is None:
            self._shadow_thread = threading.Thread(
                target=self._shadow_loop,
                name="sat-lifecycle-shadow",
                daemon=True,
            )
            self._shadow_thread.start()
        return self

    def stop(self) -> None:
        self._stopping.set()
        if self.reloader is not None:
            self.reloader.stop()
            self.reloader = None
        if self._cycle_thread is not None and self._cycle_thread.is_alive():
            self._decision = ("abort", "server shutting down")
            self._cycle_done.wait(timeout=60.0)
        if self._shadow_thread is not None:
            self._shadow_q.put(None)
            self._shadow_thread.join(timeout=10.0)
            self._shadow_thread = None

    # -- cycle entry -------------------------------------------------------

    def _on_new(self, step: int, path: str) -> None:
        self.begin_cycle(step, path)

    def begin_cycle(self, step: int, path: str) -> bool:
        """Start a reload cycle for ``step``; False when one is already
        in flight (the reloader will not see the step again — a pointer
        move during a cycle is caught by the NEXT poll's step compare)."""
        with self._lock:
            if self._state != "IDLE" or self._stopping.is_set():
                self._tel.count("lifecycle/busy_skipped")
                return False
            self._set_state("LOADING")
        self._decision = None
        self._cycle = {
            "step": int(step),
            "path": path,
            "started_unix": time.time(),
        }
        self._cycle_done.clear()
        self._cycle_thread = threading.Thread(
            target=self._run_cycle,
            args=(int(step), path),
            name="sat-lifecycle-cycle",
            daemon=True,
        )
        self._cycle_thread.start()
        return True

    def request_reload(self) -> Tuple[bool, str]:
        """POST /reload: examine LAST_GOOD right now instead of waiting
        for the next poll."""
        step = lineage.last_good_step(self.save_dir)
        if step is None:
            return False, "no LAST_GOOD pointer to reload from"
        if step == self.engine.step:
            return False, f"step {step} is already serving"
        if lineage.is_rejected(self.save_dir, step):
            return False, f"step {step} is in the rejection ledger"
        if self.reloader is not None:
            self.reloader.mark_seen(step)
        ok = self.begin_cycle(
            step, os.path.join(self.save_dir, f"{step}.npz")
        )
        return ok, (
            f"reload of step {step} started"
            if ok
            else "a lifecycle cycle is already in flight"
        )

    # -- operator decisions ------------------------------------------------

    def promote(self) -> Tuple[bool, str]:
        """POST /promote: finish the canary now (any policy)."""
        if self._state != "CANARY":
            return False, f"no canary to promote (state={self._state})"
        self._decision = ("promote", "operator request")
        self._cycle_done.wait(timeout=180.0)
        last = self._last or {}
        if last.get("outcome") == "promoted":
            return True, f"step {last.get('step')} promoted"
        return False, f"promote did not land: {last.get('why', 'unknown')}"

    def rollback(self, reason: str = "operator request") -> Tuple[bool, str]:
        """POST /rollback: reject the candidate now."""
        if self._state != "CANARY":
            return False, f"no canary to roll back (state={self._state})"
        self._decision = ("rollback", reason)
        self._cycle_done.wait(timeout=180.0)
        last = self._last or {}
        if last.get("outcome") == "rolled_back":
            return True, f"step {last.get('step')} rolled back and rejected"
        return False, f"rollback did not land: {last.get('why', 'unknown')}"

    # -- the cycle thread --------------------------------------------------

    def _make_canary_slo(self) -> SLOEngine:
        # windows clipped to the canary window: a qualification that
        # lasts 30 s cannot wait for a 300 s slow window to fill
        fast = min(self.config.slo_window_fast_s, self.config.canary_window_s)
        slow = max(
            fast,
            min(self.config.slo_window_slow_s, self.config.canary_window_s),
        )
        return SLOEngine(
            self._tel,
            objectives_from_config(self.config, "canary"),
            fast_s=fast,
            slow_s=slow,
        )

    def _run_cycle(self, step: int, path: str) -> None:
        try:
            self._run_cycle_inner(step, path)
        finally:
            # ONE exit: whatever path the cycle took (including a load
            # failure), the machine returns to IDLE and waiters wake
            self._canary_slo = None
            self._cycle = None
            if self._state != "IDLE":
                self._set_state("IDLE")
            self._cycle_done.set()

    def _run_cycle_inner(self, step: int, path: str) -> None:
        try:
            cand = load_candidate(self.engine, self.config, path)
            self._set_state("WARMING")
            self.engine.install_candidate(
                cand["variables"],
                cand["decoder_params"],
                cand["step"],
                cand["source"],
            )
            self.batcher.lifecycle_control("arm_canary")
            self._tel.count("lifecycle/reloads")
        except Exception as e:
            # load/guard failures never touched traffic: reject and bail
            self._set_state("ROLLING_BACK")
            self._finish_rollback(step, f"{type(e).__name__}: {e}", ledger=True)
            return
        try:
            self._canary_slo = self._make_canary_slo()
            self._divergence = canary.DivergenceGauge()
            self._tel.gauge("lifecycle/caption_divergence", 0.0)
            started = self._clock()
            self._set_state("CANARY")
            verb, why = self._watch_canary(started)
            if verb == "promote":
                self._set_state("PROMOTING")
                box = self.batcher.lifecycle_control("swap")
                blackout = float(box.get("blackout_ms", 0.0))  # sync-ok: host timing scalar
                self._tel.gauge(
                    "lifecycle/swap_blackout_ms", round(blackout, 3)
                )
                self._tel.count("lifecycle/promotions")
                self._last = {
                    "step": step,
                    "outcome": "promoted",
                    "why": why,
                    "blackout_ms": round(blackout, 3),
                }
                print(
                    f"sat_tpu_torch: lifecycle promoted step {step} ({why}); "
                    f"swap blackout {blackout:.1f}ms",
                    file=sys.stderr,
                    flush=True,
                )
            elif verb == "abort":
                # shutdown mid-canary is not a verdict on the candidate:
                # clear the slot but leave the ledger alone
                self._set_state("ROLLING_BACK")
                self._finish_rollback(step, why, ledger=False)
                return
            else:
                self._set_state("ROLLING_BACK")
                self._finish_rollback(step, why, ledger=True)
                return
        except Exception as e:
            self._set_state("ROLLING_BACK")
            self._finish_rollback(step, f"{type(e).__name__}: {e}", ledger=True)

    def _watch_canary(self, started: float) -> Tuple[str, str]:
        """Tick the canary SLO until a verdict: (verb, why)."""
        window = self.config.canary_window_s
        held = False
        while True:
            if self._decision is not None:
                return self._decision
            if self._stopping.is_set():
                return "abort", "server shutting down"
            slo = self._canary_slo
            if slo is not None and slo.objectives:
                try:
                    slo.tick()
                except Exception:
                    pass
                burning = slo.burning()
                if burning:
                    return (
                        "rollback",
                        "canary slo burning: " + ", ".join(burning),
                    )
            elapsed = self._clock() - started
            if elapsed >= window:
                if self.config.promote_policy == "auto":
                    return "promote", (
                        f"canary window ({window:g}s) elapsed clean"
                    )
                if not held:
                    held = True
                    print(
                        "sat_tpu_torch: lifecycle canary window elapsed; "
                        "promote_policy=manual — holding for POST "
                        "/promote or /rollback",
                        file=sys.stderr,
                        flush=True,
                    )
            time.sleep(0.05)

    def _finish_rollback(self, step: int, why: str, ledger: bool) -> None:
        try:
            self.batcher.lifecycle_control("disarm_canary")
        except Exception as e:
            print(
                f"sat_tpu_torch: lifecycle disarm failed: {e}",
                file=sys.stderr,
                flush=True,
            )
        self.engine.clear_candidate()
        first = False
        if ledger:
            try:
                first = lineage.mark_rejected(self.save_dir, step, why)
            except OSError as e:
                print(
                    f"sat_tpu_torch: lifecycle rejection ledger write failed: {e}",
                    file=sys.stderr,
                    flush=True,
                )
            if first:
                self._tel.count("lifecycle/rejected")
        self._tel.count("lifecycle/rollbacks")
        self._last = {
            "step": step,
            "outcome": "rolled_back" if ledger else "aborted",
            "why": why,
            "rejected": bool(ledger),
        }
        print(
            f"sat_tpu_torch: lifecycle rolled back step {step} ({why})"
            + ("; rejected in ledger" if first else ""),
            file=sys.stderr,
            flush=True,
        )

    # -- request-path hooks (called by the server) -------------------------

    def route(self, request_id: Optional[str]) -> str:
        """Which param slot serves this request.  Only CANARY routes
        anywhere but the incumbent; the hash keeps retries sticky."""
        if self._state != "CANARY":
            return canary.INCUMBENT
        return canary.assign_slot(request_id, self.config.canary_fraction)

    def maybe_shadow(self, image, incumbent_caption: str) -> None:
        """After an incumbent request completes during CANARY: sample it
        onto the candidate for divergence scoring.  Deterministic
        every-nth sampling; the shadow queue is bounded and drops (with
        a counter) rather than backpressuring the request path."""
        if self._state != "CANARY" or self.config.canary_shadow_rate <= 0:
            return
        self._shadow_seen += 1
        n = max(1, int(round(1.0 / self.config.canary_shadow_rate)))
        if self._shadow_seen % n:
            return
        try:
            self._shadow_q.put_nowait((image, incumbent_caption))
        except queue.Full:
            self._tel.count("lifecycle/shadow_dropped")

    def _shadow_loop(self) -> None:
        while True:
            item = self._shadow_q.get()
            if item is None:
                return
            if self._state != "CANARY":
                continue  # stale sample from a finished window
            image, incumbent_caption = item
            try:
                req = self.batcher.submit(image, slot=canary.CANARY)
            except Exception:
                continue  # shed/draining: shadow work is best-effort
            if not req.done.wait(timeout=60.0) or req.error is not None:
                self._tel.count("lifecycle/shadow_errors")
                continue
            try:
                cand_caption = req.result["captions"][0]["caption"]
            except (KeyError, IndexError, TypeError):
                self._tel.count("lifecycle/shadow_errors")
                continue
            value = self._divergence.update(
                canary.caption_divergence(incumbent_caption, cand_caption)
            )
            self._tel.gauge("lifecycle/caption_divergence", round(value, 4))
            self._tel.count("lifecycle/shadow_pairs")

    # -- read side ---------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """The /stats lifecycle block."""
        out: Dict[str, Any] = {
            "state": self._state,
            "serving_step": self.engine.step,
            "candidate_step": self.engine.candidate_step,
            "promote_policy": self.config.promote_policy,
            "canary_fraction": self.config.canary_fraction,
            "canary_window_s": self.config.canary_window_s,
            "reload_poll_s": self.config.model_reload,
        }
        cycle = self._cycle
        if cycle is not None:
            out["cycle"] = dict(cycle)
        slo = self._canary_slo
        if slo is not None:
            out["canary_slo"] = slo.snapshot()
        if self._divergence.samples:
            out["caption_divergence"] = {
                "value": self._divergence.value,
                "samples": self._divergence.samples,
            }
        if self._last is not None:
            out["last_cycle"] = dict(self._last)
        try:
            rejected = sorted(lineage.rejected_steps(self.save_dir))
        except OSError:
            rejected = []
        if rejected:
            out["rejected_steps"] = rejected
        return out
