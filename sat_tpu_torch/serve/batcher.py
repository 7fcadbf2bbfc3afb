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

Admission goes through a :class:`~sat_tpu_torch.serve.scheduler.DeficitRoundRobin`
queue: one FIFO lane without tenants, a lane a tenant with them, whose
full lane sheds only that tenant (``Rejected.scope == "tenant"``).  A
request names its param slot (incumbent, the lifecycle's canary, or a
resident model): batch mode dispatches one group per (slot, payload
kind) — images and pre-encoded handoff grids enter the device by
different paths — and continuous mode keeps one slot pool per slot, the
canary's and the residents' cloned from the warmed one.  Lifecycle
commands (``arm_canary``, ``swap``, ``disarm_canary``) run on the loop
thread between dispatches.  With the quality plane on
(``serve_quality``), each finished request's signals go to the
``QualityMonitor`` after its reply, and outliers to the exemplar
recorder.
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
from .scheduler import DeficitRoundRobin


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
    """Admission refused; ``status`` is the HTTP code the frontend maps,
    ``scope`` whose capacity ran out: "tenant" (that tenant's queue lane)
    or "global" (the service)."""

    def __init__(self, status: int, reason: str, scope: str = "global"):
        super().__init__(reason)
        self.status = status
        self.reason = reason
        self.scope = scope


@dataclass
class Request:
    """One admitted caption request; ``done`` fires with either ``result``
    (the engine's per-image dict) or ``error`` (http status, message)."""

    # the preprocessed image row; None for a decode-tier request that
    # arrived as a pre-encoded context grid (``context`` set instead)
    image: Optional[np.ndarray]
    t_submit_ns: int = 0
    deadline_unix: Optional[float] = None
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[Dict[str, Any]] = None
    error: Optional[Tuple[int, str]] = None
    bucket: Optional[int] = None
    # the engine param slot that serves it ("incumbent", "canary" or a
    # resident alias) and the tenant whose lane it queued in
    slot: str = "incumbent"
    tenant: str = "default"
    # request-scoped tracing (telemetry.tracectx): when the gather loop
    # popped this request, and (continuous) when its slot was seeded
    t_gather_ns: Optional[int] = None
    t_admit_ns: Optional[int] = None
    trace: Optional[Any] = None
    # device-cost accumulator (telemetry.metering), None with telemetry off
    cost: Optional[RequestCost] = None
    # the POSTed bytes, kept only with the quality plane on (exemplars)
    raw: Optional[bytes] = None
    # the content key of the preprocessed row, stamped by the server with
    # the encode cache on
    key: Optional[int] = None
    # a pre-encoded [N, D] grid (the tier handoff): dispatch skips the
    # encode and the cache
    context: Optional[np.ndarray] = None
    # where its image was encoded, for an exemplar's replay: the serve
    # mode, the encode's width and this row's index in it (and its pool
    # slot in continuous mode); None when the row came from the encode
    # cache or a handoff grid
    geometry: Optional[Dict[str, Any]] = None

    def mark(self, phase: str, t0_ns: int, dur_ns: int) -> None:
        if self.trace is not None:
            self.trace.mark(phase, t0_ns, dur_ns)

    def fail(self, status: int, reason: str) -> None:
        self.error = (status, reason)
        self.done.set()


class _BatcherBase:
    """Bounded-queue admission, the wedge watchdog, lifecycle control and
    the quality hooks shared by both dispatch disciplines; subclasses
    implement ``_loop`` and ``_apply_control``."""

    _thread_name = "sat-torch-serve-batcher"

    def __init__(
        self,
        engine,
        queue_depth: Optional[int] = None,
        tel=None,
        on_wedge: Optional[Callable[[], None]] = None,
        wedge_timeout_ms: Optional[float] = None,
        weights: Optional[Dict[str, float]] = None,
        quality=None,
        exemplars=None,
    ) -> None:
        config = engine.config
        self.engine = engine
        depth = int(queue_depth if queue_depth is not None else config.serve_queue_depth)
        # one FIFO lane without a weights table; a lane a tenant with one
        self._q = DeficitRoundRobin(maxsize=depth, weights=weights)
        self._tel = tel if tel is not None else telemetry.get()
        # > 0 bounds each device region; 0 leaves it unbounded
        wedge_ms = wedge_timeout_ms if wedge_timeout_ms is not None else config.serve_wedge_timeout_ms
        self.wedge_timeout_s = float(wedge_ms) / 1e3
        self.on_wedge = on_wedge
        # armed only by SAT_FI_WEDGE_SERVE_BATCH / SAT_FI_SLOW_SERVE_MS;
        # captured once so the fire-once bookkeeping persists
        self._plan = faultinject.FaultPlan.from_env()
        # the quality plane: a QualityMonitor and an ExemplarRecorder, both
        # None with serve_quality off
        self._quality = quality
        self._exemplars = exemplars
        self._draining = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # lifecycle commands run on the loop thread at the admission
        # boundary, so no dispatch straddles a param-slot flip
        self._control_q: "queue.Queue[Tuple[str, Dict[str, Any], threading.Event]]" = queue.Queue()

    # -- admission (called from HTTP worker threads) -----------------------

    def submit(
        self,
        image: Optional[np.ndarray],
        deadline_unix: Optional[float] = None,
        trace: Optional[Any] = None,
        slot: str = "incumbent",
        tenant: str = "default",
        raw: Optional[bytes] = None,
        key: Optional[int] = None,
        context: Optional[np.ndarray] = None,
    ) -> Request:
        """Admit one preprocessed image, or on a decode tier a pre-encoded
        ``context`` grid; Rejected(503) while draining, Rejected(429) when
        the tenant's lane is full (tenant-scoped with several lanes)."""
        if self._draining.is_set():
            self._tel.count("serve/rejected_draining")
            raise Rejected(503, "server is draining; not accepting work")
        req = Request(
            image=image, t_submit_ns=time.perf_counter_ns(), deadline_unix=deadline_unix,
            trace=trace, slot=slot, tenant=tenant,
            cost=RequestCost() if self._tel.enabled else None,
            raw=raw if self._exemplars is not None else None, key=key, context=context,
        )
        try:
            self._q.put_nowait(req)
        except queue.Full:
            self._tel.count("serve/shed")
            if self._q.multi:
                self._tel.count(f"serve/tenant_{tenant}_shed")
                raise Rejected(
                    429, f"tenant {tenant!r} queue full ({self._q.maxsize} waiting); shed", scope="tenant"
                ) from None
            raise Rejected(429, f"queue full ({self._q.maxsize} waiting); shed") from None
        self._tel.count("serve/submitted")
        self._tel.gauge("serve/queue_depth", self._q.qsize())
        return req

    def queue_depth(self) -> int:
        return self._q.qsize()

    def tenant_depths(self) -> Dict[str, int]:
        """Queued depth a tenant (the /stats tenants block)."""
        return self._q.depths()

    def tenant_admitted(self) -> Dict[str, int]:
        """Cumulative scheduler admissions a tenant."""
        return self._q.admitted()

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

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

    # -- lifecycle control -------------------------------------------------

    def lifecycle_control(self, action: str, timeout: float = 120.0) -> Dict[str, Any]:
        """Run a lifecycle action (``arm_canary``, ``swap``,
        ``disarm_canary``) on the loop thread between dispatches, inline
        when the loop is not running.  Returns the action's result dict;
        raises on an action-level failure."""
        box: Dict[str, Any] = {}
        if self._thread is None or not self._thread.is_alive():
            self._apply_control(action, box)
        else:
            ev = threading.Event()
            self._control_q.put((action, box, ev))
            if not ev.wait(timeout=timeout):
                raise RuntimeError(f"lifecycle {action!r} timed out")
        if "error" in box:
            raise RuntimeError(box["error"])
        return box

    def _maybe_control(self) -> None:
        while True:
            try:
                action, box, ev = self._control_q.get_nowait()
            except queue.Empty:
                return
            try:
                self._apply_control(action, box)
            except Exception as e:  # report to the caller, keep serving
                box["error"] = f"lifecycle {action!r} failed: {e}"
            finally:
                ev.set()

    def _apply_control(self, action: str, box: Dict[str, Any]) -> None:  # pragma: no cover
        raise NotImplementedError

    # -- quality plane -----------------------------------------------------

    def _apply_quality_skew(self, scores: np.ndarray) -> np.ndarray:
        """``SAT_FI_QUALITY_SKEW``: lower the drained top-beam log scores
        by the armed amount (the caption tokens stay bitwise the same);
        read a drain, so it can be armed against a live server."""
        skew = faultinject.consume_quality_skew()
        if skew and scores.size:
            scores = scores.copy()
            scores[:, 0] -= skew
        return scores

    def _observe_quality(self, payloads, words, lengths, scores, alphas, results) -> None:
        """Each finished request's quality signals, host arithmetic on
        arrays already drained; outliers go to the exemplar recorder.  A
        failure is counted and swallowed: observability never fails a
        request."""
        if self._quality is None:
            return
        from ..telemetry.quality import extract_signals

        vocab_size = len(self.engine.vocabulary.words)
        eos_id = self.engine.eos_id
        try:
            for i, r in enumerate(payloads):
                sig = extract_signals(
                    words[i], lengths[i], scores[i], vocab_size=vocab_size, eos_id=eos_id,
                    alphas=None if alphas is None else alphas[i],
                )
                reasons = self._quality.observe(sig, tenant=r.tenant)
                if reasons and self._exemplars is not None:
                    captions = results[i]["captions"] if results else []
                    self._exemplars.record(
                        reasons=reasons,
                        request_id=getattr(r.trace, "trace_id", ""),
                        tenant=r.tenant,
                        caption=captions[0]["caption"] if captions else "",
                        beams=captions,
                        signals=sig,
                        image_bytes=r.raw,
                        alphas=None if alphas is None else alphas[i],
                        extra={"slot": r.slot, "bucket": r.bucket, "geometry": r.geometry},
                    )
        except Exception:
            self._tel.count("serve/quality_errors")

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
    """Whole-batch dispatch over the engine's bucket ladder, one dispatch
    a (param slot, payload kind) group of a gathered batch."""

    def __init__(
        self,
        engine,
        max_batch: Optional[int] = None,
        max_wait_ms: Optional[float] = None,
        queue_depth: Optional[int] = None,
        tel=None,
        on_wedge: Optional[Callable[[], None]] = None,
        wedge_timeout_ms: Optional[float] = None,
        weights: Optional[Dict[str, float]] = None,
        quality=None,
        exemplars=None,
    ) -> None:
        super().__init__(engine, queue_depth, tel, on_wedge, wedge_timeout_ms, weights, quality, exemplars)
        config = engine.config
        self.max_batch = int(max_batch if max_batch is not None else config.serve_max_batch)
        wait_ms = max_wait_ms if max_wait_ms is not None else config.serve_max_wait_ms
        self.max_wait_s = wait_ms / 1e3
        self._batch_index = 0  # 1-based, counted at dispatch

    # -- dispatch loop -----------------------------------------------------

    def _gather(self) -> Optional[List[Request]]:
        """Block for a first request, then hold the batch open.  None when
        draining with an empty queue; [] when woken for a lifecycle
        command."""
        while True:
            try:
                first = self._q.get(timeout=0.05)
                break
            except queue.Empty:
                if self._draining.is_set():
                    return None
                if not self._control_q.empty():
                    return []
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

    def _contexts(self, live: List[Request], slot: str) -> torch.Tensor:
        """The group's contexts on the device: its handoff grids (a
        decode-tier group), or its images encoded under ``slot``'s params,
        through the encode cache when every request carries a key."""
        engine = self.engine
        if live[0].context is not None:
            return engine.context_batch([r.context for r in live])
        batch, _ = engine.pad_batch([r.image for r in live])
        keys = [r.key for r in live]
        if engine.encode_cache is None or any(k is None for k in keys):
            keys = None  # cache off, or requests submitted without a key
        return engine.encode_batch(batch, [r.cost for r in live], slot, keys)

    def _device_region(self, live: List[Request], slot: str, index: int):
        """Encode (or stack), search and drain one group: the region the
        watchdog bounds.  Returns (host arrays, t_encoded, t_searched,
        t_drained)."""
        engine = self.engine
        contexts = self._contexts(live, slot)
        t_enc = time.perf_counter_ns()
        out = engine.search(contexts, slot)
        t_search = time.perf_counter_ns()
        if self._plan.maybe_wedge_serve(index):
            # injected stuck batch: park like a drain the card never
            # answers (interruptible only by process exit)
            time.sleep(3600.0)
        self._plan.maybe_slow_serve()
        self._plan.maybe_slow_canary(slot)
        arrays = engine.drain_output(out, len(live))
        return arrays, t_enc, t_search, time.perf_counter_ns()

    def _run(self, live: List[Request], slot: str = "incumbent") -> None:
        try:
            bucket = self.engine.pick_bucket(len(live))
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
            arrays, t_enc, t1, t2 = self._run_region(lambda: self._device_region(live, slot, index))
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
        words, lengths, scores, alphas = arrays
        try:
            scores = self._apply_quality_skew(scores)
            results = self.engine.detok_rows((words, lengths, scores), len(live))
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
        encoded = live[0].context is None and (
            self.engine.encode_cache is None or any(r.key is None for r in live))
        for i, (r, result) in enumerate(zip(live, results)):
            r.bucket = bucket
            if encoded:
                r.geometry = {"mode": "batch", "encode_width": bucket, "encode_row": i}
            r.mark("dispatch", t0, t1 - t0)
            r.mark("drain", t1, t2 - t1)
            r.mark("detok", t2, t3 - t2)
            r.result = result
            r.done.set()
            self._tel.count("serve/completed")
        # after the replies: requesters never wait on signal extraction
        self._observe_quality(live, words, lengths, scores, alphas, results)

    def _apply_control(self, action: str, box: Dict[str, Any]) -> None:
        """Batch mode: a batch resolves its slot's params when it runs, and
        commands run between batches, so the swap is a pointer flip with
        nothing to drain; arm and disarm need no device state (the canary
        slot is resolved a dispatch)."""
        if action in ("arm_canary", "disarm_canary"):
            box["ok"] = True
        elif action == "swap":
            t0 = time.monotonic()
            box["step"] = self.engine.promote_candidate()
            box["blackout_ms"] = (time.monotonic() - t0) * 1e3
        else:
            raise ValueError(f"unknown lifecycle action {action!r}")

    def _loop(self) -> None:
        while True:
            self._maybe_control()
            batch = self._gather()
            self._tel.gauge("serve/queue_depth", self._q.qsize())
            if batch is None:
                break
            live = self._admit(batch)
            # one dispatch a (param slot, payload kind): each dispatch runs
            # one param set, and images and grids enter the device by
            # different paths
            groups: Dict[Tuple[str, bool], List[Request]] = {}
            for r in live:
                groups.setdefault((r.slot, r.context is not None), []).append(r)
            for gkey in sorted(groups):
                self._run(groups[gkey], gkey[0])


class ContinuousBatcher(_BatcherBase):
    """Step-level continuous batching over paged slot pools.

    Each tick of the loop:

    1. **admit**: route the held and queued requests, in the scheduler's
       deficit order, to their param slot's pool, up to each pool's free
       slots; fail expired deadlines with 504 and seed the rest
       (``pool.admit``);
    2. **step**: one fused window of K decode steps over every occupied
       pool, K chosen by queue pressure (:func:`choose_decode_depth`),
       enqueued with no host sync; draining its ``done`` flags and
       ``steps_run`` is the window's one sync, bounded by the wedge
       watchdog;
    3. **harvest**: merge and drain the finished slots, free them, and
       hand the rows to the detokenizer thread, so string work never
       holds up the next window.

    The main pool runs the incumbent; the lifecycle's canary pool and one
    pool a resident model are ``clone_warmed`` from it on this thread.
    A request whose pool is full waits in ``_pending``, never dropped."""

    _thread_name = "sat-torch-serve-continuous"

    def __init__(
        self,
        engine,
        pool=None,
        queue_depth: Optional[int] = None,
        tel=None,
        on_wedge: Optional[Callable[[], None]] = None,
        wedge_timeout_ms: Optional[float] = None,
        weights: Optional[Dict[str, float]] = None,
        quality=None,
        exemplars=None,
    ) -> None:
        super().__init__(engine, queue_depth, tel, on_wedge, wedge_timeout_ms, weights, quality, exemplars)
        if pool is None:
            from .slot_pool import PagedSlotPool

            pool = PagedSlotPool(engine, tel=self._tel)
        self.pool = pool
        self._step_index = 0  # 1-based; SAT_FI_WEDGE_SERVE_BATCH=n wedges window n
        self._detok_q: "queue.Queue" = queue.Queue()
        self._detok_thread: Optional[threading.Thread] = None
        # re-warms run ON the loop thread: the pools have one owner
        self._rewarm_q: "queue.Queue[threading.Event]" = queue.Queue()
        # the canary pool exists during a canary window; the residents'
        # pools are cloned at their first request
        self._canary_pool = None
        self._model_pools: Dict[str, Any] = {}
        self._pending: List[Request] = []

    def _pools(self) -> List[Any]:
        pools = [self.pool]
        if self._canary_pool is not None:
            pools.append(self._canary_pool)
        pools.extend(self._model_pools.values())
        return pools

    def _occupancy_total(self) -> int:
        return sum(p.occupancy() for p in self._pools())

    def start(self) -> "ContinuousBatcher":
        if self.pool._carry is None:
            self.pool.warmup()
        if self._detok_thread is None:
            self._detok_thread = threading.Thread(
                target=self._detok_loop, name="sat-torch-serve-detok", daemon=True
            )
            self._detok_thread.start()
        return super().start()

    # -- admission into slots ----------------------------------------------

    def _pop_queued(self, cap: int) -> List[Request]:
        out: List[Request] = []
        while len(out) < cap:
            try:
                out.append(self._q.get_nowait())
            except queue.Empty:
                break
        return out

    def _admit(self, reqs: List[Request], pool=None) -> None:
        """Deadline triage, then seed into free slots of ``pool`` (the main
        pool by default), marking the per-request admission phases.
        Callers never pass more than the pool's ``free_count()``."""
        pool = pool if pool is not None else self.pool
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
        n = pool.admit(items)
        t1 = time.perf_counter_ns()
        self._tel.count("serve/admitted", n)
        for (_, r), placed in zip(items[:n], pool.admitted):
            r.bucket = pool.width  # the page width is this path's "bucket"
            if placed is not None:
                lane, row, slot = placed
                r.geometry = {"mode": "continuous", "encode_width": lane, "encode_row": row, "pool_slot": slot}
            r.t_admit_ns = t1
            r.mark("admit", t0, t1 - t0)
            # submit → seeded: the continuous path's admission latency
            self._tel.record("serve/admission_wait", r.t_submit_ns, t1 - r.t_submit_ns)
        for _, r in items[n:]:  # never reached: callers pass at most free_count()
            r.fail(500, "slot pool admission overflow")
        self._tel.gauge("serve/queue_depth", self._q.qsize())

    def _route_admissions(self) -> List[Request]:
        """Route the held and queued requests to their slot's pool, up to
        each pool's free slots; the rest stay in ``_pending`` for the next
        tick.  A resident's first request clones its pool here (on the
        loop thread) and waits one tick.  Returns every request it took."""
        pools = {"incumbent": self.pool}
        if self._canary_pool is not None:
            pools["canary"] = self._canary_pool
        pools.update(self._model_pools)
        free = {k: p.free_count() for k, p in pools.items()}
        headroom = sum(free.values()) - len(self._pending)
        reqs = self._pending
        if headroom > 0:
            reqs = reqs + self._pop_queued(headroom)
        self._pending = []
        groups: Dict[str, List[Request]] = {k: [] for k in pools}
        for r in reqs:
            slot = r.slot
            if slot not in pools:
                if self.engine.has_resident(slot):
                    pool = self.pool.clone_warmed(slot)
                    self._model_pools[slot] = pool
                    pools[slot] = pool
                    free[slot] = 0
                    groups[slot] = []
                else:
                    slot = "incumbent"
            if len(groups[slot]) < free[slot]:
                groups[slot].append(r)
            else:
                self._pending.append(r)
        for slot, group in groups.items():
            if group:
                self._admit(group, pools[slot])
        return reqs

    # -- the step loop -----------------------------------------------------

    def _step_pools(self, index: int) -> List[Tuple[Any, np.ndarray]]:
        """One fused window and its drain over every occupied pool: the
        region the watchdog bounds.  Returns ``[(pool, host done flags)]``."""
        if self._plan.maybe_wedge_serve(index):
            # injected stuck window: park like a drain the card never
            # answers (interruptible only by process exit)
            time.sleep(3600.0)
        self._plan.maybe_slow_serve()
        k = choose_decode_depth(self.pool.decode_depths, self._q.qsize(), len(self._pending))
        out = []
        for pool in self._pools():
            if pool.occupancy() == 0:
                continue
            self._plan.maybe_slow_canary(pool.param_slot)
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
            out.append((pool, done))
        return out

    def _fail_inflight(self, status: int, reason: str) -> None:
        for pool in self._pools():
            for r in pool.inflight_payloads():
                if not r.done.is_set():
                    r.fail(status, reason)
        for r in self._pending:
            if not r.done.is_set():
                r.fail(status, reason)
        self._pending = []

    def _reset_pools(self) -> None:
        for pool in self._pools():
            try:
                pool.reset()
            except Exception:
                pass  # a reset the card will not take is the wedge itself

    def _handle_wedge(self) -> None:
        # the batch path's counter: one wedge signal across modes
        self._tel.count("serve/wedged_batches")
        self._fail_inflight(
            500, f"in-flight decode step wedged past {self.wedge_timeout_s * 1e3:g}ms; slots discarded"
        )
        self._reset_pools()
        self._fire_on_wedge()

    def _harvest(self, done: np.ndarray, pool=None) -> None:
        pool = pool if pool is not None else self.pool
        t0 = time.perf_counter_ns()
        payloads, words, lengths, scores, steps, alphas = pool.harvest(done)
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
        self._detok_q.put((payloads, words, lengths, scores, alphas, t1))

    def _detok_loop(self) -> None:
        while True:
            item = self._detok_q.get()
            if item is None:
                return
            payloads, words, lengths, scores, alphas, t1 = item
            scores = self._apply_quality_skew(scores)
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
            # after the replies, on this thread: the step loop never pays
            # for signal extraction or exemplar I/O
            self._observe_quality(payloads, words, lengths, scores, alphas, results)

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
            # every other pool starts again from an empty carry too
            if self._canary_pool is not None:
                self._canary_pool = self.pool.clone_warmed("canary")
            for slot in list(self._model_pools):
                self._model_pools[slot] = self.pool.clone_warmed(slot)
        finally:
            ev.set()

    def _loop(self) -> None:
        while True:
            self._maybe_rewarm()
            self._maybe_control()
            if self._occupancy_total() == 0 and not self._pending:
                # idle: park for the first arrival, polling the drain flag
                try:
                    self._pending.append(self._q.get(timeout=0.05))
                except queue.Empty:
                    if self._draining.is_set():
                        break
                    continue
            reqs: List[Request] = []
            try:
                reqs = self._route_admissions()
                if self._occupancy_total() == 0:
                    continue  # everything taken had expired
                self._step_index += 1
                index = self._step_index
                dones = self._run_region(lambda: self._step_pools(index))
            except _WedgeTimeout:
                self._handle_wedge()
                continue
            except Exception as e:  # keep serving; fail only in-flight work
                self._tel.count("serve/dispatch_errors")
                for r in reqs:  # taken but not yet bound to a slot
                    if not r.done.is_set():
                        r.fail(500, f"decode step failed: {e}")
                self._fail_inflight(500, f"decode step failed: {e}")
                self._reset_pools()
                continue
            for pool, done in dones:
                if done.any():
                    self._harvest(done, pool)
        # drained: queue and pools empty; flush the detokenizer
        self._detok_q.put(None)
        if self._detok_thread is not None:
            self._detok_thread.join(timeout=30.0)
            self._detok_thread = None

    # -- lifecycle control (on the loop thread) ----------------------------

    def _drain_step_bound(self, stop) -> bool:
        """Step and harvest until ``stop()`` holds, bounded by the caption
        length's step budget so a done flag that never fires cannot hold
        the loop.  Returns whether the drain completed."""
        limit = 2 * self.pool.max_len + 8
        for _ in range(limit):
            if stop():
                return True
            self._step_index += 1
            index = self._step_index
            for pool, done in self._run_region(lambda: self._step_pools(index)):
                if done.any():
                    self._harvest(done, pool)
        return stop()

    def _apply_control(self, action: str, box: Dict[str, Any]) -> None:
        """Continuous mode: the carry is stepped with whatever params its
        pool's slot resolves to now, so a swap first waits out the captions
        in flight (they finish under the params they started with); that
        wait, with nothing new admitted, is the swap's blackout."""
        if action == "arm_canary":
            if self._canary_pool is None:
                self._canary_pool = self.pool.clone_warmed("canary")
            box["ok"] = True
        elif action == "swap":
            t0 = time.monotonic()
            if not self._drain_step_bound(lambda: self._occupancy_total() == 0):
                self._fail_inflight(500, "lifecycle swap drain exceeded its step bound")
            box["step"] = self.engine.promote_candidate()
            self._canary_pool = None
            box["blackout_ms"] = (time.monotonic() - t0) * 1e3
        elif action == "disarm_canary":
            pool = self._canary_pool
            if pool is not None:
                # rollback: canary captions in flight finish normally, then
                # the pool is dropped
                if not self._drain_step_bound(lambda: pool.occupancy() == 0):
                    for r in pool.inflight_payloads():
                        if not r.done.is_set():
                            r.fail(503, "canary retired mid-decode; retry")
                    pool.reset()
                self._canary_pool = None
            box["ok"] = True
        else:
            raise ValueError(f"unknown lifecycle action {action!r}")

    def rewarm(self) -> None:
        """The server's wedge-recovery hook: re-run the pool warmup and
        rebuild empty carries, proving the card answers before health
        recovers.  Runs on the loop thread when it is alive: the pools
        have one owner, and a warmup racing admission would clobber
        freshly seeded slots."""
        if self._thread is None or not self._thread.is_alive():
            self.pool.warmup()
            return
        ev = threading.Event()
        self._rewarm_q.put(ev)
        if not ev.wait(timeout=120.0):
            raise RuntimeError("slot-pool re-warm timed out")
