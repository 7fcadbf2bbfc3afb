"""Admission control and whole-batch dispatch — the port of
``sat_tpu.serve.batcher``'s ``MicroBatcher`` (``serve_mode="batch"``).

Requests wait in a bounded queue (429 beyond ``serve_queue_depth``, 503
while draining).  The dispatch thread blocks for a first request, holds
the batch open up to ``serve_max_wait_ms`` or until ``serve_max_batch``
requests, fails expired deadlines with 504 before any device time, pads
to the engine's bucket, dispatches one beam search, drains and
detokenizes.  Beam search here syncs the host every step, so a dispatch
returns with its result done; there is no in-flight pipeline to drain.
Tenants, the quality plane, lifecycle control and the wedge watchdog are
later slices of the port.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .engine import BucketOverflow


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


class MicroBatcher:
    def __init__(
        self,
        engine,
        max_batch: Optional[int] = None,
        max_wait_ms: Optional[float] = None,
        queue_depth: Optional[int] = None,
    ) -> None:
        config = engine.config
        self.engine = engine
        self.max_batch = int(max_batch if max_batch is not None else config.serve_max_batch)
        wait_ms = max_wait_ms if max_wait_ms is not None else config.serve_max_wait_ms
        self.max_wait_s = wait_ms / 1e3
        depth = int(queue_depth if queue_depth is not None else config.serve_queue_depth)
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

    def start(self) -> "MicroBatcher":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="sat-torch-serve-batcher", daemon=True
            )
            self._thread.start()
        return self

    def drain(self, timeout: Optional[float] = 60.0) -> None:
        """Graceful stop: new submits get 503, everything admitted is
        completed, then the dispatch thread exits."""
        self._draining.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

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

    def _admit(self, batch: List[Request]) -> List[Request]:
        """Deadline triage: expired requests fail with 504, no device time."""
        now = time.time()
        live = []
        for r in batch:
            if r.deadline_unix is not None and now > r.deadline_unix:
                self._count("expired")
                r.fail(504, "deadline expired while queued")
            else:
                live.append(r)
        return live

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
            live = self._admit(batch)
            if live:
                self._run(live)
