"""Admission control and dispatch — the port of ``sat_tpu.serve.batcher``.

Both batchers share one bounded-queue admission contract (429 beyond
``serve_queue_depth``, 503 while draining, 504 for an expired deadline
before any device time):

* :class:`MicroBatcher` (``serve_mode="batch"``): the dispatch thread
  blocks for a first request, holds the batch open up to
  ``serve_max_wait_ms`` or until ``serve_max_batch`` requests, pads to the
  engine's bucket, dispatches one beam search, drains and detokenizes.
  Beam search here syncs the host every step, so a dispatch returns with
  its result done; there is no in-flight pipeline to drain.
* :class:`ContinuousBatcher` (``serve_mode="continuous"``): requests are
  seeded into free slots of a :class:`~sat_tpu_torch.serve.slot_pool.PagedSlotPool`
  between fused decode windows, and each slot is harvested the window it
  finishes; detokenization runs on its own thread.

Tenants, the quality plane, lifecycle control, canary and resident-model
pools and the wedge watchdog are later slices of the port.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .engine import BucketOverflow


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
    deadline_unix: Optional[float] = None
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[Dict[str, Any]] = None
    error: Optional[Tuple[int, str]] = None
    bucket: Optional[int] = None

    def fail(self, status: int, reason: str) -> None:
        self.error = (status, reason)
        self.done.set()


class _BatcherBase:
    """Bounded-queue admission, counters and lifecycle shared by both
    dispatch disciplines; subclasses implement ``_loop``."""

    _thread_name = "sat-torch-serve-batcher"

    def __init__(self, engine, queue_depth: Optional[int] = None) -> None:
        self.engine = engine
        depth = int(queue_depth if queue_depth is not None else engine.config.serve_queue_depth)
        self._q: "queue.Queue[Request]" = queue.Queue(maxsize=depth)
        self._draining = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {}

    def _count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    # -- admission (called from HTTP worker threads) -----------------------

    def submit(self, image: np.ndarray, deadline_unix: Optional[float] = None) -> Request:
        """Admit one preprocessed image; Rejected(503) while draining,
        Rejected(429) when the queue is full."""
        if self._draining.is_set():
            self._count("rejected_draining")
            raise Rejected(503, "server is draining; not accepting work")
        req = Request(image=image, deadline_unix=deadline_unix)
        try:
            self._q.put_nowait(req)
        except queue.Full:
            self._count("shed")
            raise Rejected(429, f"queue full ({self._q.maxsize} waiting); shed") from None
        self._count("submitted")
        return req

    def queue_depth(self) -> int:
        return self._q.qsize()

    def counter_snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.counters)

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

    def _expire(self, reqs: List[Request]) -> List[Request]:
        """Deadline triage: expired requests fail with 504, no device time."""
        now = time.time()
        live = []
        for r in reqs:
            if r.deadline_unix is not None and now > r.deadline_unix:
                self._count("expired")
                r.fail(504, "deadline expired while queued")
            else:
                live.append(r)
        return live


class MicroBatcher(_BatcherBase):
    """Whole-batch dispatch over the engine's bucket ladder."""

    def __init__(
        self,
        engine,
        max_batch: Optional[int] = None,
        max_wait_ms: Optional[float] = None,
        queue_depth: Optional[int] = None,
    ) -> None:
        super().__init__(engine, queue_depth)
        config = engine.config
        self.max_batch = int(max_batch if max_batch is not None else config.serve_max_batch)
        wait_ms = max_wait_ms if max_wait_ms is not None else config.serve_max_wait_ms
        self.max_wait_s = wait_ms / 1e3

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
        batch = [first]
        flush_at = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            wait = flush_at - time.monotonic()
            if wait <= 0:
                break
            try:
                batch.append(self._q.get(timeout=wait))
            except queue.Empty:
                break
        return batch

    def _run(self, live: List[Request]) -> None:
        try:
            batch, bucket = self.engine.pad_batch([r.image for r in live])
            out = self.engine.dispatch(batch)
            results = self.engine.decode_output(out, len(live))
        except BucketOverflow as e:
            self._count("shed_bucket_overflow")
            for r in live:
                r.fail(429, f"{e}; retry after the current batch drains")
            return
        except Exception as e:  # keep serving; fail only this batch
            self._count("dispatch_errors")
            for r in live:
                r.fail(500, f"dispatch failed: {e}")
            return
        self._count("batches")
        self._count(f"bucket_{bucket}")
        self._count("padded_rows", bucket - len(live))
        for r, result in zip(live, results):
            r.bucket = bucket
            r.result = result
            r.done.set()
        self._count("completed", len(live))

    def _loop(self) -> None:
        while True:
            batch = self._gather()
            if batch is None:
                break
            live = self._expire(batch)
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
       is the window's one sync;
    3. **harvest**: merge and drain the finished slots, free them, and
       hand the rows to the detokenizer thread, so string work never
       holds up the next window.

    A request that arrives during a window waits for that window, not
    for a whole batch; a caption that seals early frees its slot."""

    _thread_name = "sat-torch-serve-continuous"

    def __init__(self, engine, pool=None, queue_depth: Optional[int] = None) -> None:
        super().__init__(engine, queue_depth)
        if pool is None:
            from .slot_pool import PagedSlotPool

            pool = PagedSlotPool(engine)
        self.pool = pool
        self._detok_q: "queue.Queue" = queue.Queue()
        self._detok_thread: Optional[threading.Thread] = None

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

    def _take(self, held: List[Request]) -> List[Request]:
        """``held`` plus whatever is queued now, up to the free slots, less
        the expired."""
        reqs = held
        while len(reqs) < self.pool.free_count():
            try:
                reqs.append(self._q.get_nowait())
            except queue.Empty:
                break
        return self._expire(reqs)

    def _admit(self, reqs: List[Request]) -> None:
        n = self.pool.admit([(r.image, r) for r in reqs])
        self._count("admitted", n)
        for r in reqs[:n]:
            r.bucket = self.pool.width  # the page width is this path's "bucket"
        for r in reqs[n:]:  # never reached: _take pops at most free_count()
            r.fail(500, "slot pool admission overflow")

    def _step(self) -> np.ndarray:
        """One fused window; returns the host [S] done flags."""
        k = choose_decode_depth(self.pool.decode_depths, self._q.qsize(), 0)
        done_dev, steps_dev = self.pool.multi_step(k)
        done = done_dev.cpu().numpy()
        steps = int(steps_dev)
        self._count("dispatches")
        self._count(f"dispatch_k{k}")
        self._count("steps", steps)
        return done

    def _harvest(self, done: np.ndarray) -> None:
        payloads, words, lengths, scores, _ = self.pool.harvest(done)
        self._detok_q.put((payloads, words, lengths, scores))

    def _detok_loop(self) -> None:
        while True:
            item = self._detok_q.get()
            if item is None:
                return
            payloads, words, lengths, scores = item
            try:
                results = self.engine.detok_rows((words, lengths, scores), len(payloads))
            except Exception as e:
                self._count("detok_errors")
                for r in payloads:
                    r.fail(500, f"detokenize failed: {e}")
                continue
            self._count("completed", len(payloads))
            for r, result in zip(payloads, results):
                r.result = result
                r.done.set()

    def _loop(self) -> None:
        while True:
            held: List[Request] = []
            if self.pool.occupancy() == 0:
                # idle: park for the first arrival, polling the drain flag
                try:
                    held.append(self._q.get(timeout=0.05))
                except queue.Empty:
                    if self._draining.is_set():
                        break
                    continue
            reqs = self._take(held)
            try:
                if reqs:
                    self._admit(reqs)
                if self.pool.occupancy() == 0:
                    continue  # everything taken had expired
                done = self._step()
                if done.any():
                    self._harvest(done)
            except Exception as e:  # keep serving; fail only in-flight work
                self._count("dispatch_errors")
                for r in self.pool.inflight_payloads() + reqs:
                    if not r.done.is_set():
                        r.fail(500, f"decode step failed: {e}")
                self.pool.reset()
        # drained: queue and pool empty; flush the detokenizer
        self._detok_q.put(None)
        if self._detok_thread is not None:
            self._detok_thread.join(timeout=30.0)
            self._detok_thread = None
