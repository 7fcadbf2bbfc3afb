"""Device-resident, content-addressed LRU of encoder feature grids — the
port of ``sat_tpu.serve.encode_cache``.

The conv encoder is the largest serve-path cost and a pure function of
the preprocessed image, yet every duplicate image pays it again.  This
module keeps a fixed-geometry ring of ``[rows, N, D]`` context grids on
the engine's device, keyed by ``(image key, param fingerprint)``, with
host-side LRU bookkeeping:

* **gather** ``store.index_select(0, idx) -> [w, N, D]`` feeds the
  search the exact bits a fresh encode produced (rows are written once
  and read verbatim, so a hit's captions are bitwise its miss's);
* **insert** ``store.index_copy_(0, idx, ctx)`` writes a miss lane's
  freshly encoded rows into their ring rows in place (pad rows land in
  a scratch row nobody reads as a real row).

Both run on the caller's thread in the device's current stream, the
same stream as the search that reads the rows, so a gather enqueued
after an insert sees its rows.  PyTorch compiles nothing, so the JAX
package's per-width AOT warm of gather and insert becomes recording the
widths the server dispatches at (``warm``), which ``/stats`` shows as
``warm_widths``.

Single-flight coalescing falls out of the planning discipline: one
batcher/pool thread owns all plans, a plan dedupes repeated keys within
its chunk (one encode, N seeds), and the host map is updated at plan
time, so N concurrent requests for one image trigger exactly one encode
however they land across chunks.

Capacity comes from ``--encode_cache_mb``; ``--encode_cache off`` never
constructs this class, so serving takes the pre-cache path unchanged.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch


class CachePlan(object):
    """One chunk's resolved lookup: a ring row per request, plus the
    unique misses that must be encoded (first occurrence wins; repeats
    within the chunk are coalesced onto the same row)."""

    __slots__ = ("rows", "miss_keys", "miss_rows", "miss_pos", "hits",
                 "coalesced")

    def __init__(self) -> None:
        self.rows: List[int] = []       # ring row per chunk item
        self.miss_keys: List[Hashable] = []  # unique keys to encode
        self.miss_rows: List[int] = []  # ring row per unique miss
        self.miss_pos: List[int] = []   # chunk position of each first miss
        self.hits = 0
        self.coalesced = 0

    @property
    def n_miss(self) -> int:
        return len(self.miss_keys)


class EncodeCache(object):
    """Fixed-geometry device ring + host LRU map + gather/insert.

    Device geometry is decided once at warmup (``ensure_store``) from
    the context-row aval and the MB budget, and never changes; the host
    map is guarded by a small lock because ``/stats`` scrapes read it
    from HTTP threads while the single batcher thread plans against it.
    """

    def __init__(self, capacity_mb: int, tel=None) -> None:
        self.capacity_mb = int(capacity_mb)
        self._tel = tel
        self._lock = threading.Lock()
        self._store: Optional[torch.Tensor] = None  # [rows+1, N, D]; row `rows` = scratch
        self.rows = 0               # usable ring rows (excludes scratch)
        self.row_shape: Optional[Tuple[int, ...]] = None
        self.row_dtype = None
        self.row_bytes = 0
        self._map: "OrderedDict[Hashable, int]" = OrderedDict()
        self._free: List[int] = []
        self._widths: set = set()
        # lifetime counters (the /stats cache block; tel counters mirror
        # them so /metrics exports ride promtext for free)
        self.hits = 0
        self.misses = 0
        self.coalesced = 0
        self.evictions = 0
        self.inserts = 0
        self.flushes = 0

    # -- warmup (called from engine/pool warmup, before ready) -------------

    def ensure_store(
        self, row_shape: Sequence[int], row_dtype, min_rows: int, device=None
    ) -> None:
        """Allocate the ring once: ``capacity_mb`` worth of rows, floored
        at ``min_rows + 1`` so one dispatch-width chunk of distinct
        misses can always be planned without evicting a row the same
        plan just pinned.  Idempotent for a matching row aval (the
        re-warm path); a different aval means different params geometry
        and raises — the cache must be rebuilt, not silently reshaped."""
        row_shape = tuple(int(d) for d in row_shape)
        if self._store is not None:
            if row_shape != self.row_shape or np.dtype(row_dtype) != np.dtype(
                self.row_dtype
            ):
                raise ValueError(
                    f"encode cache store is {self.row_shape}/{self.row_dtype} "
                    f"but warmup now wants {row_shape}/{row_dtype}"
                )
            return
        self.row_shape = row_shape
        self.row_dtype = np.dtype(row_dtype)
        self.row_bytes = int(
            np.prod(row_shape, dtype=np.int64) * self.row_dtype.itemsize
        )
        budget_rows = int(self.capacity_mb * 1e6) // max(1, self.row_bytes)
        self.rows = max(int(min_rows) + 1, budget_rows)
        self._store = torch.zeros(
            (self.rows + 1,) + row_shape,
            dtype=getattr(torch, self.row_dtype.name),
            device=device,
        )
        self._free = list(range(self.rows))
        if self._tel is not None:
            self._tel.gauge("serve/cache_rows", self.rows)
            self._tel.gauge(
                "serve/cache_capacity_bytes", self.rows * self.row_bytes
            )

    def warm(self, widths: Sequence[int]) -> None:
        """Record every dispatch width the server gathers and inserts at
        (called after ``ensure_store``; eager PyTorch has nothing to
        compile, the widths feed ``/stats``)."""
        if self._store is None:
            raise RuntimeError("EncodeCache.warm before ensure_store")
        self._widths.update(int(w) for w in widths)

    @property
    def warm_widths(self) -> Tuple[int, ...]:
        return tuple(sorted(self._widths))

    # -- planning (single batcher/pool thread) -----------------------------

    def plan(self, keys: Sequence[Hashable]) -> CachePlan:
        """Resolve one chunk of content keys to ring rows, assigning LRU
        rows to the unique misses (the single-flight dedup: a key
        repeated within the chunk coalesces onto its first row).  The
        map is updated NOW — before the encode lands — because one
        thread owns all plans, so a later chunk referencing the same
        key must hit, not re-encode.  Callers that fail the dispatch
        must ``drop`` the planned miss keys."""
        plan = CachePlan()
        with self._lock:
            pinned = set()
            seen_miss: Dict[Hashable, int] = {}
            for i, key in enumerate(keys):
                row = self._map.get(key)
                if row is not None and key not in seen_miss:
                    self._map.move_to_end(key)
                    plan.hits += 1
                    plan.rows.append(row)
                    pinned.add(row)
                    continue
                if key in seen_miss:
                    plan.coalesced += 1
                    plan.rows.append(plan.miss_rows[seen_miss[key]])
                    continue
                row = self._alloc_row(pinned)
                seen_miss[key] = len(plan.miss_keys)
                plan.miss_keys.append(key)
                plan.miss_rows.append(row)
                plan.miss_pos.append(i)
                self._map[key] = row
                self._map.move_to_end(key)
                pinned.add(row)
                plan.rows.append(row)
            self.hits += plan.hits
            self.misses += plan.n_miss
            self.coalesced += plan.coalesced
        if self._tel is not None:
            if plan.hits:
                self._tel.count("serve/cache_hits", plan.hits)
            if plan.n_miss:
                self._tel.count("serve/cache_misses", plan.n_miss)
            if plan.coalesced:
                self._tel.count("serve/cache_coalesced", plan.coalesced)
        return plan

    def _alloc_row(self, pinned) -> int:
        """A free row, else evict the least-recently-used entry whose row
        is not pinned by the current plan (``ensure_store`` floors the
        ring at one row past the widest chunk, so one always exists)."""
        if self._free:
            return self._free.pop()
        for key, row in self._map.items():  # oldest first
            if row not in pinned:
                del self._map[key]
                self.evictions += 1
                if self._tel is not None:
                    self._tel.count("serve/cache_evictions")
                return row
        raise RuntimeError(
            "encode cache has no evictable row (ring smaller than one "
            "dispatch chunk — ensure_store floor violated)"
        )

    def drop(self, keys: Sequence[Hashable]) -> None:
        """Un-plan miss keys whose encode/insert failed: their rows hold
        garbage, so the entries must not serve hits."""
        with self._lock:
            for key in keys:
                row = self._map.pop(key, None)
                if row is not None:
                    self._free.append(row)

    # -- device programs ---------------------------------------------------

    def _index(self, width: int, rows: Sequence[int]) -> torch.Tensor:
        """``rows`` padded to ``width`` with the scratch row, on the ring's
        device (copied without waiting for the device)."""
        idx = np.full((int(width),), self.rows, np.int64)
        idx[: len(rows)] = rows
        t = torch.from_numpy(idx)
        if self._store.is_cuda:
            t = t.pin_memory()
        return t.to(self._store.device, non_blocking=True)

    @torch.inference_mode()
    def insert(self, width: int, lane_ctx: torch.Tensor, rows: Sequence[int]) -> None:
        """Write a freshly encoded ``[width, N, D]`` lane into the ring at
        ``rows`` in place (pad lane rows land in the scratch row)."""
        self._store.index_copy_(0, self._index(width, rows), lane_ctx.to(self._store.dtype))
        self.inserts += len(rows)

    @torch.inference_mode()
    def gather(self, width: int, rows: Sequence[int]) -> torch.Tensor:
        """``[width, N, D]`` of ring rows (pad positions read the scratch
        row; beam search is row-independent, so they never perturb real
        rows, like the zero-padded rows of an encode lane)."""
        return self._store.index_select(0, self._index(width, rows))

    # -- invalidation (lifecycle/quant coherence) --------------------------

    def flush(self) -> None:
        """Forget every entry (model promote/rollback): keys carry the
        param fingerprint so stale entries could never hit anyway, but
        flushing returns their rows to the free list immediately instead
        of waiting out LRU churn.  Device rows become unreferenced
        garbage — no device work."""
        with self._lock:
            self._map.clear()
            self._free = list(range(self.rows))
            self.flushes += 1
        if self._tel is not None:
            self._tel.count("serve/cache_flushes")

    # -- observability -----------------------------------------------------

    @property
    def lookups(self) -> int:
        return self.hits + self.misses + self.coalesced

    def hit_ratio(self) -> float:
        """Fraction of lookups that skipped the encode lane — coalesced
        requests rode another request's single-flight encode, so they
        count as hits (matching what the would-hit sketch observes)."""
        n = self.lookups
        return (self.hits + self.coalesced) / n if n else 0.0

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            entries = len(self._map)
        return {
            "entries": entries,
            "rows": self.rows,
            "bytes": entries * self.row_bytes,
            "capacity_bytes": self.rows * self.row_bytes,
            "hits": self.hits,
            "misses": self.misses,
            "coalesced": self.coalesced,
            "evictions": self.evictions,
            "inserts": self.inserts,
            "flushes": self.flushes,
            "hit_ratio": round(self.hit_ratio(), 4),
            "warm_widths": list(self.warm_widths),
        }
