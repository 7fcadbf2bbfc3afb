"""Deterministic fault injection — the port's copy of
``sat_tpu.resilience.faultinject``, same ``SAT_FI_*`` knobs.

Runs fail in a handful of stereotyped ways — preemption mid step, a NaN
gradient poisoning the state, a torn or bit-rotted checkpoint or data
shard, a flaky network filesystem, a rotted JPEG — and every recovery
path must be provable without waiting for the fleet to misbehave.  This
module is the switchboard: each failure mode has ONE injection point,
armed by an ``SAT_FI_*`` environment variable, firing deterministically
at a configured step (or call count) and exactly once.

All knobs are **inert by default**: with no ``SAT_FI_*`` variables set,
every hook is a handful of host-side compares.

Hooks wired in the port so far: ``consume_decode_fault`` in
``ImageLoader.load_raw``, ``consume_caption_fault`` in the
``PrefetchLoader``, ``maybe_corrupt_shard_row`` in
``data.shards.resolve_shard_cache``, ``consume_io_fault`` in
``resilience.retry.retry_io``, ``maybe_kill`` / ``maybe_wedge`` /
``maybe_slow`` in the bulk runner (its clock counts decode steps) and in
the train loop (with ``maybe_poison`` after each step), and
``maybe_corrupt_checkpoint`` in the checkpoint writer; the serve
batchers' ``maybe_wedge_serve`` / ``maybe_slow_serve`` /
``maybe_slow_canary`` at the result drain, and
``consume_quality_skew`` at the detok boundary.

Knobs::

    SAT_FI_DIE_AT_STEP=k       raise SimulatedPreemption before step k is
                               dispatched (abrupt preemption; periodic
                               checkpoints written so far are the only
                               survivors)
    SAT_FI_SIGTERM_AT_STEP=k   deliver a real SIGTERM to this process
                               before step k (drives the *graceful*
                               preemption path end-to-end)
    SAT_FI_NAN_AT_STEP=k       poison the k-th completed step: params and
                               metrics become NaN, as a diverged gradient
                               would leave them
    SAT_FI_CORRUPT_CKPT_STEP=k flip a byte in ``<k>.npz`` right after it
                               is written (bit-rot between write and
                               verify; the post-write verify must catch
                               it and LAST_GOOD must not advance)
    SAT_FI_IO_FAILURES=n[:sub] the first n ``retry_io`` attempts whose
                               description contains ``sub`` (all, when no
                               ``sub``) raise a retryable InjectedIOError
    SAT_FI_WEDGE_AT_STEP=k     wedge the train loop before step k is
                               dispatched: the thread parks in a sleep
                               loop, making no progress, exactly like a
                               silently hung device dispatch (the
                               watchdog is expected to detect and abort)
    SAT_FI_SLOW_STEP_MS=m      add m milliseconds of host-side stall to
                               every step (a degraded-but-alive device;
                               the watchdog must NOT fire)
    SAT_FI_SLOW_STEP_SCALE=k   stall at least k times the median of this
                               process's own steps so far (the time
                               between two steps less the stall), m ms
                               or more, so a slowed rank stays k+1 times
                               its peers' step however loaded the host is
                               (the port's own knob; the JAX package has
                               none)
    SAT_FI_WEDGE_SERVE_BATCH=n wedge the n-th (1-based) dispatched serve
                               batch at the result drain: its requests
                               must fail 500, /healthz must degrade to
                               503, and the engine re-warms
    SAT_FI_SLOW_SERVE_MS=m     add m milliseconds of host-side stall to
                               every serve batch's result drain (a
                               degraded-but-alive serving device; the
                               latency SLO must start burning while the
                               wedge watchdog stays quiet)
    SAT_FI_CANARY_SLOW_MS=m    like SLOW_SERVE_MS but only for batches
                               dispatched against the CANARY param slot
                               (a bad candidate checkpoint whose decode
                               path stalls; the canary SLO must burn and
                               the lifecycle controller must roll back
                               while the incumbent stays fast)
    SAT_FI_CORRUPT_SHARD_ROW=k overwrite the first bytes of row k of
                               shard-00000.npy when the shard cache is
                               resolved (bit rot in a data shard; the
                               crc sidecar must detect it and the
                               live-decode fallback must recover).
                               Idempotent constant write, so re-firing
                               across loaders/restarts is harmless
    SAT_FI_BAD_IMAGE_EVERY=n   the live decode of any image whose
                               basename hashes into bucket 0 of n
                               raises (a truncated/rotted JPEG
                               population; quarantine must contain it).
                               Keyed on the file NAME, not call order,
                               so firing is deterministic under the
                               decode thread pool
    SAT_FI_BAD_CAPTION_AT=k    poison the k-th tokenized caption row
                               (its word_idxs/masks zeroed) so the
                               caption-anomaly detector must quarantine
                               it
    SAT_FI_QUALITY_SKEW=c      depress every drained top-beam log score
                               by c/100 at the serve-path detok boundary
                               (harvest-side scoring only — caption
                               TOKENS are untouched, so replay stays
                               bitwise).  Beam margins and normalized
                               log-probs shift together, exactly like a
                               quietly degraded checkpoint: the quality
                               drift lane must burn while /healthz stays
                               ok.  Re-read from the environment per
                               drain so a chaos scenario can arm it
                               mid-run
"""

from __future__ import annotations

import errno
import os
import signal
import statistics
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

ENV_PREFIX = "SAT_FI_"


class SimulatedPreemption(RuntimeError):
    """Injected die-at-step-k: the run is 'preempted' mid-loop.  Callers
    treat it like the process vanishing — resume must come from the
    checkpoints already on disk."""


class InjectedIOError(OSError):
    """Injected transient IO failure (classified retryable by
    ``resilience.retry``: errno EIO)."""

    def __init__(self, desc: str, remaining: int):
        super().__init__(errno.EIO, f"injected transient IO error ({desc}; {remaining} more armed)")


def _env_float(env: Dict[str, str], key: str) -> Optional[float]:
    raw = env.get(ENV_PREFIX + key)
    if raw is None or raw == "":
        return None
    try:
        return float(raw)
    except ValueError as e:
        raise ValueError(f"{ENV_PREFIX}{key}={raw!r}: expected a number") from e


def _env_int(env: Dict[str, str], key: str) -> Optional[int]:
    raw = env.get(ENV_PREFIX + key)
    if raw is None or raw == "":
        return None
    try:
        return int(raw)
    except ValueError as e:
        raise ValueError(f"{ENV_PREFIX}{key}={raw!r}: expected an integer") from e


@dataclass
class FaultPlan:
    """One training run's armed faults.  Step-keyed faults fire at most
    once; a plan with nothing armed is ``inert`` and every hook is a
    no-op compare."""

    die_at_step: Optional[int] = None
    sigterm_at_step: Optional[int] = None
    nan_at_step: Optional[int] = None
    corrupt_ckpt_step: Optional[int] = None
    wedge_at_step: Optional[int] = None
    slow_step_ms: Optional[int] = None
    wedge_serve_batch: Optional[int] = None
    slow_serve_ms: Optional[int] = None
    canary_slow_ms: Optional[int] = None
    corrupt_shard_row: Optional[int] = None
    bad_image_every: Optional[int] = None
    bad_caption_at: Optional[int] = None
    _fired: Dict[str, bool] = field(default_factory=dict)
    # the port's own knob (SAT_FI_SLOW_STEP_SCALE), not the JAX package's,
    # and maybe_slow's clock while it is set: (time of its last call, the
    # stall it then slept), and the intervals between calls less those
    # stalls
    slow_step_scale: Optional[float] = None
    _slow_mark: Optional[Tuple[float, float]] = None
    _own_steps: List[float] = field(default_factory=list)

    @classmethod
    def from_env(cls, env: Optional[Dict[str, str]] = None) -> "FaultPlan":
        env = os.environ if env is None else env
        return cls(
            die_at_step=_env_int(env, "DIE_AT_STEP"),
            sigterm_at_step=_env_int(env, "SIGTERM_AT_STEP"),
            nan_at_step=_env_int(env, "NAN_AT_STEP"),
            corrupt_ckpt_step=_env_int(env, "CORRUPT_CKPT_STEP"),
            wedge_at_step=_env_int(env, "WEDGE_AT_STEP"),
            slow_step_ms=_env_int(env, "SLOW_STEP_MS"),
            wedge_serve_batch=_env_int(env, "WEDGE_SERVE_BATCH"),
            slow_serve_ms=_env_int(env, "SLOW_SERVE_MS"),
            canary_slow_ms=_env_int(env, "CANARY_SLOW_MS"),
            corrupt_shard_row=_env_int(env, "CORRUPT_SHARD_ROW"),
            bad_image_every=_env_int(env, "BAD_IMAGE_EVERY"),
            bad_caption_at=_env_int(env, "BAD_CAPTION_AT"),
            slow_step_scale=_env_float(env, "SLOW_STEP_SCALE"),
        )

    @property
    def inert(self) -> bool:
        return (
            self.die_at_step is None
            and self.sigterm_at_step is None
            and self.nan_at_step is None
            and self.corrupt_ckpt_step is None
            and self.wedge_at_step is None
            and self.slow_step_ms is None
            and self.slow_step_scale is None
            and self.wedge_serve_batch is None
            and self.slow_serve_ms is None
            and self.canary_slow_ms is None
            and self.corrupt_shard_row is None
            and self.bad_image_every is None
            and self.bad_caption_at is None
        )

    def _once(self, key: str) -> bool:
        if self._fired.get(key):
            return False
        self._fired[key] = True
        return True

    # -- step-keyed hooks --------------------------------------------------

    def maybe_kill(self, step: int) -> None:
        """Before dispatching ``step``: simulated preemption (abrupt raise)
        or a real self-SIGTERM (exercises the graceful-stop handler)."""
        if self.die_at_step is not None and step >= self.die_at_step and self._once("die"):
            raise SimulatedPreemption(f"injected preemption before step {step}")
        if (
            self.sigterm_at_step is not None
            and step >= self.sigterm_at_step
            and self._once("sigterm")
        ):
            os.kill(os.getpid(), signal.SIGTERM)

    def maybe_poison(self, step_done: int, state: Any, metrics: Any) -> Tuple[Any, Any]:
        """After the step that made the counter read ``step_done``: poison
        params and metrics with NaN, as a diverged gradient update would.
        ``state`` is a ``train.step.TrainState`` (nested dicts of tensors),
        ``metrics`` a dict of tensors; costs nothing unless armed AND
        firing."""
        if self.nan_at_step is None or step_done != self.nan_at_step or not self._once("nan"):
            return state, metrics

        def poison(tree):
            if isinstance(tree, dict):
                return {k: poison(v) for k, v in tree.items()}
            # a fresh leaf that trains like the one it replaces
            return (tree.detach() * float("nan")).requires_grad_(tree.requires_grad)

        return state._replace(params=poison(state.params)), poison(dict(metrics))

    def maybe_wedge(self, step: int) -> None:
        """Before dispatching ``step``: park the calling thread forever
        (well, for an hour — long past any watchdog deadline), exactly
        like a silently hung device dispatch.  The process makes no
        progress until the watchdog aborts it."""
        if self.wedge_at_step is None or step < self.wedge_at_step or not self._once("wedge"):
            return
        deadline = time.monotonic() + 3600.0
        while time.monotonic() < deadline:  # interruptible only by abort
            time.sleep(0.05)

    def maybe_slow(self, step: int) -> None:
        """Before dispatching ``step``: stall ``slow_step_ms`` of host
        time, or ``slow_step_scale`` times the median of this process's
        own steps so far where that is longer.  Degraded-but-alive;
        per-phase progress keeps ticking and the watchdog must stay
        quiet."""
        if self.slow_step_ms is None and self.slow_step_scale is None:
            return
        stall = (self.slow_step_ms or 0) / 1e3
        if self.slow_step_scale:
            now = time.perf_counter()
            if self._slow_mark is not None:
                last, slept = self._slow_mark
                self._own_steps.append(now - last - slept)
            # the first interval holds the loop's start (loader, first
            # call): not a step, so not a sample
            if len(self._own_steps) > 1:
                stall = max(stall, self.slow_step_scale * statistics.median(self._own_steps[1:]))
            self._slow_mark = (now, stall)
        time.sleep(stall)

    def maybe_slow_serve(self) -> None:
        """At every serve result drain: stall ``slow_serve_ms`` of host
        time.  Degraded-but-alive serving — request latency inflates (the
        latency SLO's test signal) but batches still complete."""
        if self.slow_serve_ms is None:
            return
        time.sleep(self.slow_serve_ms / 1e3)

    def maybe_slow_canary(self, slot: str) -> None:
        """At the serve result drain, when the drained batch ran against
        the canary param slot: stall ``canary_slow_ms`` of host time.
        The incumbent slot is untouched, so the canary SLO burns while
        the serve SLO stays green — the rollback trigger."""
        if self.canary_slow_ms is None or slot != "canary":
            return
        time.sleep(self.canary_slow_ms / 1e3)

    def maybe_wedge_serve(self, batch_index: int) -> bool:
        """At the serve result drain, for the ``batch_index``-th (1-based)
        dispatched batch: report True exactly once so the batcher can
        simulate a wedged in-flight batch without real device state."""
        return (
            self.wedge_serve_batch is not None
            and batch_index == self.wedge_serve_batch
            and self._once("wedge_serve")
        )

    def maybe_corrupt_checkpoint(self, path: str, step: int) -> None:
        """After ``<step>.npz`` landed: flip one byte mid-file (bit rot /
        torn replication).  The post-write verify is expected to catch it."""
        if (
            self.corrupt_ckpt_step is None
            or step != self.corrupt_ckpt_step
            or not self._once("corrupt")
        ):
            return
        corrupt_byte(path)

    def maybe_corrupt_shard_row(self, cache_dir: str) -> None:
        """When the shard cache is resolved: overwrite the first bytes
        of row ``corrupt_shard_row`` of the first shard with a constant
        (NOT a flip — a toggle would self-heal on the second loader's
        resolve).  The crc sidecar, written at build time, goes stale
        against exactly that row."""
        if self.corrupt_shard_row is None:
            return
        path = os.path.join(cache_dir, "shard-00000.npy")
        if not os.path.exists(path):
            return
        import numpy as np

        mm = np.load(path, mmap_mode="r+")
        row = min(self.corrupt_shard_row, len(mm) - 1)
        flat = mm.reshape(len(mm), -1)
        flat[row, :4] = 0xA5
        mm.flush()
        del mm


def corrupt_byte(path: str, offset: Optional[int] = None) -> None:
    """Flip one byte of ``path`` in place (test helper + injection body).
    Defaults to the middle of the file — inside some array's compressed
    payload, past the zip local headers."""
    size = os.path.getsize(path)
    if size == 0:
        return
    pos = size // 2 if offset is None else offset
    with open(path, "r+b") as f:
        f.seek(pos)
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([b[0] ^ 0xFF]))


# -- transient-IO injection (consumed by resilience.retry) -----------------

# Keyed on the raw env value so re-arming with a new spec resets the
# budget; cleared the moment the variable disappears.
_io_state: Dict[str, Any] = {"spec": None, "remaining": 0, "match": ""}


def consume_io_fault(desc: str) -> None:
    """Called by ``retry_io`` before every attempt.  Inert (one dict get)
    unless ``SAT_FI_IO_FAILURES`` is set."""
    spec = os.environ.get(ENV_PREFIX + "IO_FAILURES")
    if not spec:
        _io_state["spec"] = None
        return
    if _io_state["spec"] != spec:
        count, _, match = spec.partition(":")
        _io_state.update(spec=spec, remaining=int(count), match=match)
    if _io_state["remaining"] > 0 and _io_state["match"] in desc:
        _io_state["remaining"] -= 1
        raise InjectedIOError(desc, _io_state["remaining"])


# -- bad-record injection (consumed by the data plane) ----------------------

# Caption faults are counted in the (single) tokenizing producer thread,
# so a plain counter is deterministic; keyed on the raw spec like
# _io_state so re-arming resets it.
_caption_state: Dict[str, Any] = {"spec": None, "count": 0}


def consume_decode_fault(image_file: str) -> None:
    """Called by ``ImageLoader.load_raw`` per image.  Inert (one env get)
    unless ``SAT_FI_BAD_IMAGE_EVERY`` is set; then raises for the stable
    1/n of images whose *basename* hashes into bucket 0 — call-order
    independent (the decode pool is unordered) and identical across
    runs/tmpdirs over the same file names."""
    spec = os.environ.get(ENV_PREFIX + "BAD_IMAGE_EVERY")
    if not spec:
        return
    import zlib

    n = max(1, int(spec))
    if zlib.crc32(os.path.basename(image_file).encode("utf-8")) % n == 0:
        raise ValueError(
            f"injected decode failure (SAT_FI_BAD_IMAGE_EVERY={n}): "
            f"{image_file}"
        )


def consume_quality_skew() -> float:
    """Called by the serve batchers at every detok boundary.  Inert (one
    env get) unless ``SAT_FI_QUALITY_SKEW`` is set; then returns the log
    score depression (``c / 100``) the drained top beam must absorb.
    Env-read per call — NOT captured into the batcher's FaultPlan — so
    the chaos campaign can flip drift on under live load."""
    spec = os.environ.get(ENV_PREFIX + "QUALITY_SKEW")
    if not spec:
        return 0.0
    return int(spec) / 100.0


def consume_caption_fault() -> bool:
    """Called per tokenized caption row.  True exactly once, when the
    running row count passes ``SAT_FI_BAD_CAPTION_AT`` — the caller
    zeroes that row so the anomaly detector has something to catch."""
    spec = os.environ.get(ENV_PREFIX + "BAD_CAPTION_AT")
    if not spec:
        _caption_state["spec"] = None
        return False
    if _caption_state["spec"] != spec:
        _caption_state.update(spec=spec, count=0)
    _caption_state["count"] += 1
    return _caption_state["count"] == int(spec)


def reset_io_faults() -> None:
    """Forget injection bookkeeping (test isolation)."""
    _io_state.update(spec=None, remaining=0, match="")
    _caption_state.update(spec=None, count=0)
