"""Weighted deficit-round-robin admission scheduler.

The port's copy of ``sat_tpu.serve.scheduler``.

Replaces the batcher's single FIFO ``queue.Queue`` with per-tenant
sub-queues drained in deficit order (docs/SERVING.md "Multi-tenant
serving"): each tenant carries a deficit counter replenished by
``quantum x weight`` every rotation visit, and a request pops only when
its tenant holds a whole unit of deficit.  Pops are what grant
slot-pool admission and encode-lane seats, so a flooding tenant can
only consume its weighted share of decode steps while others have work
queued — and the rotation is naturally **work-conserving**: with a
single non-empty sub-queue the rotation degenerates to that queue and
it drains at full speed (deficit replenishes every visit, nothing is
held back for an idle tenant).

Deficit does **not** bank across idle periods: when a sub-queue
empties, its deficit resets to 0 and the tenant leaves the rotation.
A tenant returning from idle starts from the same deficit as everyone
else — fairness is over *contended* intervals, not lifetime totals.

**Starvation-freedom**: every tenant in the rotation gains
``quantum x weight > 0`` per full rotation, so any positive-weight
tenant accumulates a unit of deficit in at most ``ceil(1/weight)``
rotations regardless of how adversarially other tenants arrive (pinned
by tests/test_tenants.py).

The queue-compatible surface (``put_nowait`` raising ``queue.Full``,
``get``/``get_nowait`` raising ``queue.Empty``, ``qsize``, ``maxsize``)
keeps both batchers' control flow unchanged, and a single-tenant
scheduler pops in exact FIFO order — the degenerate case is
bit-identical to the ``queue.Queue`` it replaced (the no-``--tenants``
parity guarantee).  ``maxsize`` bounds each tenant's sub-queue
independently: a full sub-queue is a *tenant-scoped* overload (the
frontend sheds it with ``X-Shed-Scope: tenant``) and cannot crowd out
another tenant's admission — with one tenant this is exactly the old
global bound.

Items only need a ``tenant`` attribute (missing → the default lane).
jax-free by contract (gated by tests/test_device_diag.py).
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from typing import Deque, Dict, List, Optional

DEFAULT_TENANT = "default"


class DeficitRoundRobin:
    """Per-tenant FIFO sub-queues drained in weighted deficit order.

    ``weights`` maps tenant name → scheduling weight; tenants absent
    from the map (including the default lane) run at weight 1.0.
    ``maxsize`` bounds each sub-queue (0 = unbounded), matching
    ``queue.Queue`` semantics for the single-tenant case."""

    def __init__(
        self,
        maxsize: int = 0,
        weights: Optional[Dict[str, float]] = None,
        quantum: float = 1.0,
        default: str = DEFAULT_TENANT,
    ) -> None:
        self.maxsize = int(maxsize)
        self.quantum = float(quantum)  # sync-ok: host config scalar
        self.default = default
        self._weights = dict(weights or {})
        for name, w in self._weights.items():
            if w <= 0:
                raise ValueError(
                    f"scheduler weight for {name!r} must be > 0 (got {w})"
                )
        # more than one declared weight lane => tenant-scoped sub-queue
        # bounds (the frontend picks the shed scope off this flag)
        self.multi = len(self._weights) > 1
        self._queues: Dict[str, Deque] = {}
        self._deficit: Dict[str, float] = {}
        # rotation over tenants with queued work; head is the tenant
        # currently spending its deficit
        self._rotation: Deque[str] = deque()
        self._size = 0
        # cumulative pops per tenant: each pop is one granted admission
        # (a decode seat), so this is the scheduler-side input to the
        # per-tenant metering rollup
        self._admitted: Dict[str, int] = {}
        self._cond = threading.Condition()

    def weight(self, tenant: str) -> float:
        return self._weights.get(tenant, 1.0)

    # -- producer side (HTTP worker threads) -------------------------------

    def put_nowait(self, item) -> None:
        """Enqueue onto the item's tenant lane; raises ``queue.Full``
        when that lane is at ``maxsize`` (a tenant-scoped bound — one
        tenant's backlog never consumes another's queue space)."""
        tenant = getattr(item, "tenant", None) or self.default
        with self._cond:
            q = self._queues.get(tenant)
            if q is None:
                q = self._queues[tenant] = deque()
                self._deficit.setdefault(tenant, 0.0)
            if self.maxsize > 0 and len(q) >= self.maxsize:
                raise queue.Full
            if not q:
                self._rotation.append(tenant)
            q.append(item)
            self._size += 1
            self._cond.notify()

    # -- consumer side (the batcher loop thread) ---------------------------

    def _pop_locked(self):
        """One DRR pop.  The head tenant spends deficit while it has a
        whole unit; otherwise it replenishes (quantum x weight) and
        rotates to the tail.  Terminates because every full rotation
        strictly raises some tenant's deficit."""
        while True:
            tenant = self._rotation[0]
            q = self._queues[tenant]
            if self._deficit[tenant] >= 1.0:
                item = q.popleft()
                self._size -= 1
                self._deficit[tenant] -= 1.0
                self._admitted[tenant] = self._admitted.get(tenant, 0) + 1
                if not q:
                    # leaving the rotation resets the deficit: no
                    # banking across idle periods
                    self._rotation.popleft()
                    self._deficit[tenant] = 0.0
                return item
            self._deficit[tenant] += self.quantum * self.weight(tenant)
            self._rotation.rotate(-1)

    def get(self, timeout: Optional[float] = None):
        """Blocking pop in deficit order; raises ``queue.Empty`` on
        timeout (mirrors ``queue.Queue.get``)."""
        with self._cond:
            if self._size == 0 and not self._cond.wait_for(
                lambda: self._size > 0, timeout=timeout
            ):
                raise queue.Empty
            return self._pop_locked()

    def get_nowait(self):
        with self._cond:
            if self._size == 0:
                raise queue.Empty
            return self._pop_locked()

    # -- read side ---------------------------------------------------------

    def qsize(self) -> int:
        with self._cond:
            return self._size

    def depths(self) -> Dict[str, int]:
        """Per-tenant queued depth (the /stats + heartbeat feed)."""
        with self._cond:
            return {t: len(q) for t, q in self._queues.items() if q}

    def admitted(self) -> Dict[str, int]:
        """Cumulative per-tenant admissions (pops) since boot — the
        scheduler's contribution to the tenants-cost rollup: queue-side
        counts to reconcile against the ledger's completed counts."""
        with self._cond:
            return dict(self._admitted)

    def drain_all(self) -> List:
        """Pop everything in deficit order (shutdown paths)."""
        out = []
        with self._cond:
            while self._size > 0:
                out.append(self._pop_locked())
        return out
