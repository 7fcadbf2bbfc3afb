"""Admission control and dispatch — the port of ``sat_tpu.serve.batcher``.

Both batchers share one bounded-queue admission contract (429 beyond
``serve_queue_depth``, 503 while draining, 504 for an expired deadline
before any device time):

* :class:`MicroBatcher` (``serve_mode="batch"``): the dispatch thread
  blocks for a first request, holds the batch open up to
  ``serve_max_wait_ms`` or until ``serve_max_batch`` requests, pads to the
  engine's bucket, encodes, runs one beam search, drains and detokenizes.
  Beam search here syncs the host every step, so the device region
  (encode, search, drain) returns with its result done; there is no
  in-flight pipeline to drain.
* :class:`ContinuousBatcher` (``serve_mode="continuous"``): requests are
  seeded into free slots of a :class:`~sat_tpu_torch.serve.slot_pool.PagedSlotPool`
  between fused decode windows, and each slot is harvested the window it
  finishes; detokenization runs on its own thread.

Both bound their device region with the wedge watchdog
(``serve_wedge_timeout_ms``): a batch's encode, search and drain in batch
mode, a fused window and its ``done``/``steps_run`` drain in continuous
mode.  A region the device never finishes fails the requests it holds
with 500 and fires ``on_wedge`` (the server's degrade + re-warm hook)
instead of stranding them.  The JAX package bounds only the drain, since
its dispatch is an asynchronous launch; here a stuck card blocks inside
the search's per-step syncs, so the whole region is bounded.

Counters, gauges and spans go to the telemetry registry (``tel``, the
process-global one unless given) under the JAX package's names
(``serve/…``); :meth:`_BatcherBase.counter_snapshot` is a view of the
``serve/`` counters.  Each request carries its trace (the five
``tracectx.PHASES``) and, with telemetry on, a ``RequestCost`` charged on
already-synced boundaries.

Tenants, the quality plane, lifecycle control, the encode cache and
canary/resident-model pools are later slices of the port.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import telemetry
from ..resilience import faultinject
from ..telemetry.metering import RequestCost
from .engine import BucketOverflow


class _WedgeTimeout(Exception):
    """A device region exceeded serve_wedge_timeout_ms."""


def choose_decode_depth(depths: Tuple[int, ...], queue_depth: int, pending: int) -> int:
    """The fused window's depth for the next tick: with requests waiting
    to be seeded (queued, or held for a free slot) the shallowest depth,
    so they are admitted at the next tick; with none, the deepest, so
    each tick spends one host dispatch on the most device steps."""
    if queue_depth > 0 or pending > 0:
        return depths[0]
    return depths[-1]


class Rejected(Exception):
    """Admission refused; ``status`` is the HTTP code the frontend maps."""

    def __init__(self, status: int, reason: str):
        super().__init__(reason)
        self.status = status
        self.reason = reason


@dataclass
class Request:
    """One admitted caption request; ``done`` fires with either ``result``
    (the engine's per-image dict) or ``error`` (http status, message)."""

    image: np.ndarray
    t_submit_ns: int = 0
    deadline_unix: Optional[float] = None
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[Dict[str, Any]] = None
    error: Optional[Tuple[int, str]] = None
    bucket: Optional[int] = None
    # request-scoped tracing (telemetry.tracectx): when the gather loop
    # popped this request, and (continuous) when its slot was seeded
    t_gather_ns: Optional[int] = None
    t_admit_ns: Optional[int] = None
    trace: Optional[Any] = None
    # device-cost accumulator (telemetry.metering), None with telemetry off
    cost: Optional[RequestCost] = None

    def mark(self, phase: str, t0_ns: int, dur_ns: int) -> None:
        if self.trace is not None:
            self.trace.mark(phase, t0_ns, dur_ns)

    def fail(self, status: int, reason: str) -> None:
        self.error = (status, reason)
        self.done.set()


class _BatcherBase:
    """Bounded-queue admission, the wedge watchdog and lifecycle shared by
    both dispatch disciplines; subclasses implement ``_loop``."""

    _thread_name = "sat-torch-serve-batcher"

    def __init__(
        self,
        engine,
        queue_depth: Optional[int] = None,
        tel=None,
        on_wedge: Optional[Callable[[], None]] = None,
        wedge_timeout_ms: Optional[float] = None,
    ) -> None:
        config = engine.config
        self.engine = engine
        depth = int(queue_depth if queue_depth is not None else config.serve_queue_depth)
        self._q: "queue.Queue[Request]" = queue.Queue(maxsize=depth)
        self._tel = tel if tel is not None else telemetry.get()
        # > 0 bounds each device region; 0 leaves it unbounded
        wedge_ms = wedge_timeout_ms if wedge_timeout_ms is not None else config.serve_wedge_timeout_ms
        self.wedge_timeout_s = float(wedge_ms) / 1e3
        self.on_wedge = on_wedge
        # armed only by SAT_FI_WEDGE_SERVE_BATCH / SAT_FI_SLOW_SERVE_MS;
        # captured once so the fire-once bookkeeping persists
        self._plan = faultinject.FaultPlan.from_env()
        self._draining = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- admission (called from HTTP worker threads) -----------------------

    def submit(
        self, image: np.ndarray, deadline_unix: Optional[float] = None, trace: Optional[Any] = None
    ) -> Request:
        """Admit one preprocessed image; Rejected(503) while draining,
        Rejected(429) when the queue is full."""
        if self._draining.is_set():
            self._tel.count("serve/rejected_draining")
            raise Rejected(503, "server is draining; not accepting work")
        req = Request(
            image=image, t_submit_ns=time.perf_counter_ns(), deadline_unix=deadline_unix,
            trace=trace, cost=RequestCost() if self._tel.enabled else None,
        )
        try:
            self._q.put_nowait(req)
        except queue.Full:
            self._tel.count("serve/shed")
            raise Rejected(429, f"queue full ({self._q.maxsize} waiting); shed") from None
        self._tel.count("serve/submitted")
        self._tel.gauge("serve/queue_depth", self._q.qsize())
        return req

    def queue_depth(self) -> int:
        return self._q.qsize()

    def counter_snapshot(self) -> Dict[str, float]:
        """The registry's ``serve/`` counters, prefix dropped."""
        return {k[6:]: v for k, v in self._tel.counters().items() if k.startswith("serve/")}

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, name=self._thread_name, daemon=True)
            self._thread.start()
        return self

    def drain(self, timeout: Optional[float] = 60.0) -> None:
        """Graceful stop: new submits get 503, everything admitted is
        completed, then the dispatch thread exits."""
        self._draining.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    # -- wedge watchdog ----------------------------------------------------

    def _bounded(self, region: Callable[[], Any]):
        """Run ``region`` in a helper thread bounded by
        ``wedge_timeout_s``; raises :class:`_WedgeTimeout` when it does
        not finish.  The helper is a daemon on the engine's device, in
        inference mode (both are thread-local); a region the card never
        finishes parks it for good, which is the state the timeout
        reports instead of sharing."""
        box: Dict[str, Any] = {}
        done = threading.Event()
        device = self.engine.device

        def _run():
            try:
                if device.type == "cuda" and device.index is not None:
                    torch.cuda.set_device(device)
                with torch.inference_mode():
                    box["result"] = region()
            except BaseException as e:
                box["error"] = e
            finally:
                done.set()

        threading.Thread(target=_run, name="sat-torch-serve-drain", daemon=True).start()
        if not done.wait(timeout=self.wedge_timeout_s):
            raise _WedgeTimeout()
        if "error" in box:
            raise box["error"]
        return box["result"]

    def _run_region(self, region: Callable[[], Any]):
        return self._bounded(region) if self.wedge_timeout_s > 0 else region()

    def _fire_on_wedge(self) -> None:
        if self.on_wedge is not None:
            try:
                self.on_wedge()
            except Exception:
                pass  # degrading health must never kill the batcher


class MicroBatcher(_BatcherBase):
    """Whole-batch dispatch over the engine's bucket ladder."""

    def __init__(
        self,
        engine,
        max_batch: Optional[int] = None,
        max_wait_ms: Optional[float] = None,
        queue_depth: Optional[int] = None,
        tel=None,
        on_wedge: Optional[Callable[[], None]] = None,
        wedge_timeout_ms: Optional[float] = None,
    ) -> None:
        super().__init__(engine, queue_depth, tel, on_wedge, wedge_timeout_ms)
        config = engine.config
        self.max_batch = int(max_batch if max_batch is not None else config.serve_max_batch)
        wait_ms = max_wait_ms if max_wait_ms is not None else config.serve_max_wait_ms
        self.max_wait_s = wait_ms / 1e3
        self._batch_index = 0  # 1-based, counted at dispatch

    # -- dispatch loop -----------------------------------------------------

    def _gather(self) -> Optional[List[Request]]:
        """Block for a first request, then hold the batch open.  None when
        draining with an empty queue."""
        while True:
            try:
                first = self._q.get(timeout=0.05)
                break
            except queue.Empty:
                if self._draining.is_set():
                    return None
        first.t_gather_ns = time.perf_counter_ns()
        batch = [first]
        flush_at = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            wait = flush_at - time.monotonic()
            if wait <= 0:
                break
            try:
                rider = self._q.get(timeout=wait)
            except queue.Empty:
                break
            rider.t_gather_ns = time.perf_counter_ns()
            batch.append(rider)
        return batch

    def _admit(self, batch: List[Request]) -> List[Request]:
        """Queue-wait accounting and deadline triage at the dispatch
        boundary: expired requests fail fast (504) without device time."""
        now_ns = time.perf_counter_ns()
        now_unix = time.time()
        live = []
        for r in batch:
            self._tel.record("serve/queue_wait", r.t_submit_ns, now_ns - r.t_submit_ns)
            t_gather = r.t_gather_ns if r.t_gather_ns is not None else now_ns
            r.mark("queue_wait", r.t_submit_ns, t_gather - r.t_submit_ns)
            r.mark("batch_form", t_gather, now_ns - t_gather)
            if r.deadline_unix is not None and now_unix > r.deadline_unix:
                self._tel.count("serve/expired")
                r.fail(504, "deadline expired while queued")
            else:
                live.append(r)
        return live

    def _device_region(self, batch: np.ndarray, live: List[Request], index: int):
        """Encode, search and drain one padded batch: the region the
        watchdog bounds.  Returns (host arrays, t_encoded, t_searched,
        t_drained)."""
        engine = self.engine
        contexts = engine.encode_batch(batch, costs=[r.cost for r in live])
        t_enc = time.perf_counter_ns()
        out = engine.search(contexts)
        t_search = time.perf_counter_ns()
        if self._plan.maybe_wedge_serve(index):
            # injected stuck batch: park like a drain the card never
            # answers (interruptible only by process exit)
            time.sleep(3600.0)
        self._plan.maybe_slow_serve()
        arrays = engine.drain_output(out, len(live))
        return arrays, t_enc, t_search, time.perf_counter_ns()

    def _run(self, live: List[Request]) -> None:
        try:
            batch, bucket = self.engine.pad_batch([r.image for r in live])
        except BucketOverflow as e:
            # a burst past the largest bucket is backpressure, not a fault
            self._tel.count("serve/shed_bucket_overflow")
            for r in live:
                r.fail(429, f"{e}; retry after the current batch drains")
            return
        self._batch_index += 1
        index = self._batch_index
        t0 = time.perf_counter_ns()
        try:
            arrays, t_enc, t1, t2 = self._run_region(lambda: self._device_region(batch, live, index))
        except _WedgeTimeout:
            # the batch is gone; its requesters get a fast 500 and the
            # server's hook degrades health and re-warms the engine
            self._tel.count("serve/wedged_batches")
            for r in live:
                if not r.done.is_set():
                    r.fail(
                        500,
                        f"in-flight batch wedged past {self.wedge_timeout_s * 1e3:g}ms; "
                        "results discarded",
                    )
            self._fire_on_wedge()
            return
        except Exception as e:  # keep serving; fail only this batch
            self._tel.count("serve/dispatch_errors")
            for r in live:
                r.fail(500, f"dispatch failed: {e}")
            return
        self._tel.record("serve/dispatch", t0, t1 - t0)
        self._tel.count("serve/batches")
        self._tel.count(f"serve/bucket_{bucket}")
        self._tel.count("serve/padded_rows", bucket - len(live))
        try:
            results = self.engine.detok_rows(arrays, len(live))
        except Exception as e:
            self._tel.count("serve/detok_errors")
            for r in live:
                r.fail(500, f"decode failed: {e}")
            return
        t3 = time.perf_counter_ns()
        # drain + detok, the JAX package's serve/detok span
        self._tel.record("serve/detok", t1, t3 - t1)
        if self._tel.enabled:
            # decode attribution: the search and its drain are the
            # batch's decode device window (the encode span, timed inside
            # the engine, ends at t_enc); each live request is charged an
            # equal share, and the window feeds metering.BUSY_SPANS
            self._tel.record("serve/decode_window", t_enc, t2 - t_enc)
            share = (t2 - t_enc) // len(live)
            for r in live:
                if r.cost is not None:
                    r.cost.add_decode(share)
                    r.cost.set_occupancy(t2 - t0)
        for r, result in zip(live, results):
            r.bucket = bucket
            r.mark("dispatch", t0, t1 - t0)
            r.mark("drain", t1, t2 - t1)
            r.mark("detok", t2, t3 - t2)
            r.result = result
            r.done.set()
            self._tel.count("serve/completed")

    def _loop(self) -> None:
        while True:
            batch = self._gather()
            self._tel.gauge("serve/queue_depth", self._q.qsize())
            if batch is None:
                break
            live = self._admit(batch)
            if live:
                self._run(live)


class ContinuousBatcher(_BatcherBase):
    """Step-level continuous batching over a paged slot pool.

    Each tick of the loop:

    1. **admit**: pop what is queued, up to the pool's free slots, fail
       expired deadlines with 504, and seed the rest (``pool.admit``);
    2. **step**: one fused window of K decode steps over the pool, K
       chosen by queue pressure (:func:`choose_decode_depth`), enqueued
       with no host sync; draining its ``done`` flags and ``steps_run``
       is the window's one sync, bounded by the wedge watchdog;
    3. **harvest**: merge and drain the finished slots, free them, and
       hand the rows to the detokenizer thread, so string work never
       holds up the next window.

    A request that arrives during a window waits for that window, not
    for a whole batch; a caption that seals early frees its slot."""

    _thread_name = "sat-torch-serve-continuous"

    def __init__(
        self,
        engine,
        pool=None,
        queue_depth: Optional[int] = None,
        tel=None,
        on_wedge: Optional[Callable[[], None]] = None,
        wedge_timeout_ms: Optional[float] = None,
    ) -> None:
        super().__init__(engine, queue_depth, tel, on_wedge, wedge_timeout_ms)
        if pool is None:
            from .slot_pool import PagedSlotPool

            pool = PagedSlotPool(engine, tel=self._tel)
        self.pool = pool
        self._step_index = 0  # 1-based; SAT_FI_WEDGE_SERVE_BATCH=n wedges window n
        self._detok_q: "queue.Queue" = queue.Queue()
        self._detok_thread: Optional[threading.Thread] = None
        # re-warms run ON the loop thread: the pool has one owner
        self._rewarm_q: "queue.Queue[threading.Event]" = queue.Queue()
        self._held: List[Request] = []

    def start(self) -> "ContinuousBatcher":
        if self.pool._carry is None:
            self.pool.warmup()
        if self._detok_thread is None:
            self._detok_thread = threading.Thread(
                target=self._detok_loop, name="sat-torch-serve-detok", daemon=True
            )
            self._detok_thread.start()
        return super().start()

    # -- the step loop -----------------------------------------------------

    def _take(self) -> List[Request]:
        """The held requests plus whatever is queued now, up to the free
        slots."""
        reqs, self._held = self._held, []
        while len(reqs) < self.pool.free_count():
            try:
                reqs.append(self._q.get_nowait())
            except queue.Empty:
                break
        return reqs

    def _admit(self, reqs: List[Request]) -> None:
        """Deadline triage, then seed into free slots, marking the
        per-request admission phases."""
        now_ns = time.perf_counter_ns()
        now_unix = time.time()
        items = []
        for r in reqs:
            r.t_gather_ns = now_ns
            self._tel.record("serve/queue_wait", r.t_submit_ns, now_ns - r.t_submit_ns)
            r.mark("queue_wait", r.t_submit_ns, now_ns - r.t_submit_ns)
            if r.deadline_unix is not None and now_unix > r.deadline_unix:
                self._tel.count("serve/expired")
                r.fail(504, "deadline expired while queued")
            else:
                items.append((r.image, r))
        if not items:
            return
        t0 = time.perf_counter_ns()
        n = self.pool.admit(items)
        t1 = time.perf_counter_ns()
        self._tel.count("serve/admitted", n)
        for _, r in items[:n]:
            r.bucket = self.pool.width  # the page width is this path's "bucket"
            r.t_admit_ns = t1
            r.mark("admit", t0, t1 - t0)
            # submit → seeded: the continuous path's admission latency
            self._tel.record("serve/admission_wait", r.t_submit_ns, t1 - r.t_submit_ns)
        for _, r in items[n:]:  # never reached: _take pops at most free_count()
            r.fail(500, "slot pool admission overflow")
        self._tel.gauge("serve/queue_depth", self._q.qsize())

    def _step(self, index: int) -> np.ndarray:
        """One fused window and its drain: the region the watchdog
        bounds.  Returns the host [S] done flags."""
        if self._plan.maybe_wedge_serve(index):
            # injected stuck window: park like a drain the card never
            # answers (interruptible only by process exit)
            time.sleep(3600.0)
        self._plan.maybe_slow_serve()
        pool = self.pool
        k = choose_decode_depth(pool.decode_depths, self._q.qsize(), len(self._held))
        live = pool.inflight_payloads() if self._tel.enabled else None
        t0 = time.perf_counter_ns()
        done_dev, steps_dev = pool.multi_step(k)
        done = done_dev.cpu().numpy()
        steps = int(steps_dev)
        t1 = time.perf_counter_ns()
        self._tel.record("serve/step", t0, t1 - t0)
        if live:
            # decode attribution: every live slot riding this window is
            # charged an equal share of it
            share = (t1 - t0) // len(live)
            for r in live:
                if r.cost is not None:
                    r.cost.add_decode(share)
        # the chosen-K lane as its own span, and the window's raw step
        # count (not ns; < k when the pool sealed mid-window)
        self._tel.record(f"serve/dispatch_k{k}", t0, t1 - t0)
        self._tel.record("serve/steps_per_dispatch", 0, steps)
        self._tel.count("serve/steps", steps)
        self._tel.count("serve/dispatches")
        self._tel.count(f"serve/dispatch_k{k}")
        return done

    def _fail_inflight(self, status: int, reason: str) -> None:
        for r in self.pool.inflight_payloads() + self._held:
            if not r.done.is_set():
                r.fail(status, reason)
        self._held = []

    def _handle_wedge(self) -> None:
        # the batch path's counter: one wedge signal across modes
        self._tel.count("serve/wedged_batches")
        self._fail_inflight(
            500, f"in-flight decode step wedged past {self.wedge_timeout_s * 1e3:g}ms; slots discarded"
        )
        try:
            self.pool.reset()
        except Exception:
            pass  # a reset the card will not take is the wedge itself
        self._fire_on_wedge()

    def _harvest(self, done: np.ndarray) -> None:
        t0 = time.perf_counter_ns()
        payloads, words, lengths, scores, steps = self.pool.harvest(done)
        t1 = time.perf_counter_ns()
        for i, r in enumerate(payloads):
            r.mark("drain", t0, t1 - t0)
            if r.t_admit_ns is not None:
                r.mark("decode", r.t_admit_ns, t1 - r.t_admit_ns)
                if r.cost is not None:
                    # occupancy: seeded → harvested, how long the slot was held
                    r.cost.set_occupancy(t1 - r.t_admit_ns)
            if r.cost is not None:
                r.cost.decode_steps += int(steps[i])
            # raw per-request loop-iteration count (not ns)
            self._tel.record("serve/decode_steps", 0, int(steps[i]))
        self._detok_q.put((payloads, words, lengths, scores, t1))

    def _detok_loop(self) -> None:
        while True:
            item = self._detok_q.get()
            if item is None:
                return
            payloads, words, lengths, scores, t1 = item
            # harvest → dequeue is detok-thread queueing, its own span, so
            # serve/detok measures string work alone
            td = time.perf_counter_ns()
            self._tel.record("serve/detok_queue", t1, td - t1)
            try:
                results = self.engine.detok_rows((words, lengths, scores), len(payloads))
            except Exception as e:
                self._tel.count("serve/detok_errors")
                for r in payloads:
                    if not r.done.is_set():
                        r.fail(500, f"detokenize failed: {e}")
                continue
            t2 = time.perf_counter_ns()
            self._tel.record("serve/detok", td, t2 - td)
            for r, result in zip(payloads, results):
                r.mark("detok_queue", t1, td - t1)
                r.mark("detok", td, t2 - td)
                r.result = result
                r.done.set()
                self._tel.count("serve/completed")

    def _maybe_rewarm(self) -> None:
        try:
            ev = self._rewarm_q.get_nowait()
        except queue.Empty:
            return
        # anything bound was admitted during the degraded window; the
        # warmup rebuilds an empty carry, so hand them a retryable 503
        self._fail_inflight(503, "server re-warming after wedge; retry")
        try:
            self.pool.warmup()
        finally:
            ev.set()

    def _loop(self) -> None:
        while True:
            self._maybe_rewarm()
            if self.pool.occupancy() == 0 and not self._held:
                # idle: park for the first arrival, polling the drain flag
                try:
                    self._held.append(self._q.get(timeout=0.05))
                except queue.Empty:
                    if self._draining.is_set():
                        break
                    continue
            reqs = self._take()
            try:
                if reqs:
                    self._admit(reqs)
                if self.pool.occupancy() == 0:
                    continue  # everything taken had expired
                self._step_index += 1
                index = self._step_index
                done = self._run_region(lambda: self._step(index))
            except _WedgeTimeout:
                self._handle_wedge()
                continue
            except Exception as e:  # keep serving; fail only in-flight work
                self._tel.count("serve/dispatch_errors")
                for r in reqs:
                    if not r.done.is_set():
                        r.fail(500, f"decode step failed: {e}")
                self._fail_inflight(500, f"decode step failed: {e}")
                self.pool.reset()
                continue
            if done.any():
                self._harvest(done)
        # drained: queue and pool empty; flush the detokenizer
        self._detok_q.put(None)
        if self._detok_thread is not None:
            self._detok_thread.join(timeout=30.0)
            self._detok_thread = None

    def rewarm(self) -> None:
        """The server's wedge-recovery hook: re-run the pool warmup and
        rebuild an empty carry, proving the card answers before health
        recovers.  Runs on the loop thread when it is alive: the pool has
        one owner, and a warmup racing admission would clobber freshly
        seeded slots."""
        if self._thread is None or not self._thread.is_alive():
            self.pool.warmup()
            return
        ev = threading.Event()
        self._rewarm_q.put(ev)
        if not ev.wait(timeout=120.0):
            raise RuntimeError("slot-pool re-warm timed out")
