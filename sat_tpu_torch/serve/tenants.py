"""Tenant registry: per-tenant identity, quota, weight and SLO targets.

The port's copy of ``sat_tpu.serve.tenants``.

The multi-tenant plane (docs/SERVING.md "Multi-tenant serving") hangs
off one small, jax-free table: a tenant key (the ``X-Tenant`` request
header; bare requests map to the registry's default tenant) resolves to

* a **resident model** — the alias of a device-resident param set
  (loaded once at boot through the lifecycle loader and aval-validated
  against the incumbent, so every resident shares the warmed AOT
  executables; ``X-Model`` overrides per request);
* a **token-bucket admission quota** (``rps`` + ``burst``) enforced at
  the HTTP edge — a dry bucket sheds with a *tenant-scoped* 429 whose
  ``Retry-After`` is the bucket's own refill time, before the request
  costs any preprocessing or queue space;
* a **scheduling weight** feeding the deficit-round-robin admission
  scheduler (serve/scheduler.py) — decode seats are granted in deficit
  order, so a flooding tenant only consumes its share;
* optional per-tenant **SLO targets** (p99 / error ratio) that grow
  their own burn-rate lanes in telemetry/slo.py.

Two spec formats behind ``--tenants``:

* a JSON file path::

      {"default": "free",
       "models": {"tuned": "runs/tuned/models/900.npz"},
       "tenants": [
         {"name": "free", "weight": 1, "rps": 10, "burst": 20},
         {"name": "pro",  "weight": 4, "rps": 100, "model": "tuned",
          "slo_p99_ms": 250}]}

* an inline ``name:weight:rps:burst`` comma-list (no models/SLOs)::

      --tenants "free:1:10:20,pro:4:100:200"

The empty spec ("" — the default) is the degenerate single-tenant
registry: one unlimited default tenant, weight 1, no resident models —
zero behavior change vs. pre-tenant serving (pinned by the parity test
in tests/test_tenants.py).

jax-free by contract: the fleet router imports this module for edge
quota enforcement (gated by tests/test_device_diag.py).
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

DEFAULT_TENANT = "default"

# tenant names ride telemetry counter names, gauge names and slot keys:
# keep them to a conservative identifier charset so promtext label
# escaping and the heartbeat's prefix-stripping never see surprises
_NAME_OK = set(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_-"
)


def _check_name(name: str, what: str = "tenant") -> str:
    if not name or not set(name) <= _NAME_OK:
        raise ValueError(
            f"{what} name {name!r}: must be non-empty [A-Za-z0-9_-]"
        )
    return name


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's declared shape.  ``rps=0`` means unlimited (no
    bucket); ``burst=0`` with a finite rate degrades to a capacity of
    ``max(1, rps)`` tokens — a tenant with *any* admission rate can
    always send at least one request (pinned by the burst==0 edge-case
    test).  ``model=""`` serves the incumbent checkpoint."""

    name: str
    weight: float = 1.0
    rps: float = 0.0
    burst: float = 0.0
    model: str = ""
    slo_p99_ms: float = 0.0
    slo_error_ratio: float = 0.0

    def __post_init__(self) -> None:
        _check_name(self.name)
        if self.weight <= 0:
            raise ValueError(
                f"tenant {self.name!r}: weight={self.weight} must be > 0"
            )
        for knob in ("rps", "burst", "slo_p99_ms", "slo_error_ratio"):
            if getattr(self, knob) < 0:
                raise ValueError(
                    f"tenant {self.name!r}: {knob}={getattr(self, knob)} "
                    "must be >= 0"
                )

    @property
    def capacity(self) -> float:
        """Bucket capacity: the declared burst, else one second of rate
        (never below 1 token when a rate is set at all)."""
        if self.burst > 0:
            return float(self.burst)  # sync-ok: host config scalar
        return max(1.0, float(self.rps))  # sync-ok: host config scalar

    @property
    def limited(self) -> bool:
        return self.rps > 0


class TokenBucket:
    """Thread-safe token bucket: ``capacity`` tokens, refilled at
    ``rate`` tokens/s.  ``rate <= 0`` disables limiting entirely.
    ``clock`` is injectable for deterministic refill tests."""

    def __init__(
        self,
        rate: float,
        capacity: float,
        clock=time.monotonic,
    ) -> None:
        self.rate = float(rate)  # sync-ok: host config scalar
        self.capacity = float(capacity)  # sync-ok: host config scalar
        self._clock = clock
        self._tokens = self.capacity
        self._t_last = clock()
        self._lock = threading.Lock()

    def _refill_locked(self) -> None:
        now = self._clock()
        dt = now - self._t_last
        self._t_last = now
        if dt > 0:
            self._tokens = min(self.capacity, self._tokens + dt * self.rate)

    def try_take(self, n: float = 1.0) -> bool:
        """Take ``n`` tokens if available; False when the bucket is dry
        (the caller sheds with a tenant-scoped 429)."""
        if self.rate <= 0:
            return True
        with self._lock:
            self._refill_locked()
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def tokens(self) -> float:
        if self.rate <= 0:
            return float("inf")  # sync-ok: host-side sentinel, no device value
        with self._lock:
            self._refill_locked()
            return self._tokens

    def retry_after_s(self) -> float:
        """Seconds until the next whole token exists — the per-tenant
        Retry-After hint.  0 when unlimited or already holding a token
        (the frontend's never-0s clamp applies on top)."""
        if self.rate <= 0:
            return 0.0
        with self._lock:
            self._refill_locked()
            if self._tokens >= 1.0:
                return 0.0
            return (1.0 - self._tokens) / self.rate


class TenantRegistry:
    """The parsed ``--tenants`` table plus live per-tenant buckets.

    ``multi`` is False only for the degenerate empty spec — the
    single-tenant fast path that must stay bitwise-identical to
    pre-tenant serving (no buckets, no per-tenant counters, no extra
    SLO lanes)."""

    def __init__(
        self,
        specs: List[TenantSpec],
        default: str = DEFAULT_TENANT,
        models: Optional[Dict[str, str]] = None,
        source: str = "",
        clock=time.monotonic,
    ) -> None:
        if not specs:
            specs = [TenantSpec(name=DEFAULT_TENANT)]
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"tenants: duplicate tenant names in {names}")
        self._specs: Dict[str, TenantSpec] = {s.name: s for s in specs}
        if default not in self._specs:
            raise ValueError(
                f"tenants: default tenant {default!r} is not declared "
                f"(have {sorted(self._specs)})"
            )
        self.default = default
        self.models: Dict[str, str] = dict(models or {})
        for alias, path in self.models.items():
            _check_name(alias, what="model")
            if not path or not isinstance(path, str):
                raise ValueError(
                    f"tenants: model {alias!r} needs a checkpoint path"
                )
        for s in specs:
            if s.model and s.model not in self.models:
                raise ValueError(
                    f"tenant {s.name!r}: model {s.model!r} is not in the "
                    f"registry's models map (have {sorted(self.models)})"
                )
        self.source = source
        self._buckets: Dict[str, TokenBucket] = {
            s.name: TokenBucket(s.rps, s.capacity, clock=clock)
            for s in specs
            if s.limited
        }
        # single default tenant, unlimited, no models: the degenerate
        # registry with zero behavior change
        self.multi = not (
            len(specs) == 1
            and specs[0].name == DEFAULT_TENANT
            and not specs[0].limited
            and not self.models
        )

    # -- parsing -----------------------------------------------------------

    @classmethod
    def parse(cls, spec: str, clock=time.monotonic) -> "TenantRegistry":
        """``Config.tenants`` → registry.  "" is the degenerate
        single-tenant table; a path to an existing file parses as JSON;
        anything else parses as the inline ``name:weight:rps:burst``
        comma-list (first entry is the default tenant)."""
        spec = (spec or "").strip()
        if not spec:
            return cls([], clock=clock)
        if os.path.isfile(spec):
            try:
                with open(spec) as f:
                    doc = json.load(f)
            except (OSError, ValueError) as e:
                raise ValueError(f"tenants file {spec!r}: {e}") from None
            return cls._from_doc(doc, source=spec, clock=clock)
        return cls._from_inline(spec, clock=clock)

    @classmethod
    def _from_doc(
        cls, doc: Dict, source: str = "", clock=time.monotonic
    ) -> "TenantRegistry":
        if not isinstance(doc, dict) or "tenants" not in doc:
            raise ValueError(
                f"tenants file {source or '<doc>'}: expected an object "
                'with a "tenants" list'
            )
        allowed = {
            "name", "weight", "rps", "burst", "model",
            "slo_p99_ms", "slo_error_ratio",
        }
        specs = []
        for entry in doc["tenants"]:
            if not isinstance(entry, dict) or "name" not in entry:
                raise ValueError(
                    f"tenants file {source}: each tenant needs a name "
                    f"(got {entry!r})"
                )
            unknown = set(entry) - allowed
            if unknown:
                raise ValueError(
                    f"tenant {entry.get('name')!r}: unknown keys "
                    f"{sorted(unknown)} (allowed: {sorted(allowed)})"
                )
            specs.append(TenantSpec(**entry))
        default = doc.get("default", specs[0].name if specs else DEFAULT_TENANT)
        return cls(
            specs,
            default=default,
            models=doc.get("models"),
            source=source,
            clock=clock,
        )

    @classmethod
    def _from_inline(cls, spec: str, clock=time.monotonic) -> "TenantRegistry":
        specs = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            fields = part.split(":")
            if len(fields) > 4:
                raise ValueError(
                    f"tenants entry {part!r}: expected "
                    "name[:weight[:rps[:burst]]]"
                )
            name = fields[0]
            try:
                weight = float(fields[1]) if len(fields) > 1 else 1.0  # sync-ok: host config scalar
                rps = float(fields[2]) if len(fields) > 2 else 0.0  # sync-ok: host config scalar
                burst = float(fields[3]) if len(fields) > 3 else 0.0  # sync-ok: host config scalar
            except ValueError:
                raise ValueError(
                    f"tenants entry {part!r}: weight/rps/burst must be "
                    "numbers"
                ) from None
            specs.append(
                TenantSpec(name=name, weight=weight, rps=rps, burst=burst)
            )
        if not specs:
            raise ValueError(f"tenants spec {spec!r}: no tenants parsed")
        return cls(specs, default=specs[0].name, clock=clock)

    # -- resolution (HTTP worker threads) ----------------------------------

    def resolve(self, header: Optional[str]) -> TenantSpec:
        """``X-Tenant`` header value → spec.  Bare requests and unknown
        tenants map to the default tenant — an unknown key is a client
        mistake, not a free ride around the default tenant's quota."""
        if header:
            spec = self._specs.get(header.strip())
            if spec is not None:
                return spec
        return self._specs[self.default]

    def known(self, header: Optional[str]) -> bool:
        return bool(header) and header.strip() in self._specs

    def try_admit(self, name: str) -> bool:
        """Take one token from ``name``'s bucket; True when admitted
        (unlimited tenants always admit)."""
        bucket = self._buckets.get(name)
        return True if bucket is None else bucket.try_take()

    def retry_after_s(self, name: str) -> float:
        bucket = self._buckets.get(name)
        return 0.0 if bucket is None else bucket.retry_after_s()

    def tokens(self, name: str) -> Optional[float]:
        """Current token balance (None for unlimited tenants) — a
        /stats + heartbeat gauge feed, not an admission path."""
        bucket = self._buckets.get(name)
        return None if bucket is None else bucket.tokens()

    def use_clock(self, clock) -> None:
        """Rebind every bucket's refill clock (test hook).  Registries
        built inside a booted server own their buckets, so timing tests
        freeze refill *after* boot by swapping in an injectable clock —
        each bucket re-anchors its last-refill time on the new clock so
        no retroactive refill is credited at the swap."""
        for bucket in self._buckets.values():
            with bucket._lock:
                bucket._clock = clock
                bucket._t_last = clock()

    # -- read side ---------------------------------------------------------

    def specs(self) -> List[TenantSpec]:
        return list(self._specs.values())

    def names(self) -> List[str]:
        return list(self._specs)

    def get(self, name: str) -> Optional[TenantSpec]:
        return self._specs.get(name)

    def weights(self) -> Dict[str, float]:
        """Tenant → scheduling weight, the DRR scheduler's table."""
        return {s.name: s.weight for s in self._specs.values()}

    def slo_lanes(
        self, default_p99_ms: float = 0.0, default_error_ratio: float = 0.0
    ) -> List[Tuple[str, float, float]]:
        """Per-tenant SLO lane targets ``(name, p99_ms, error_ratio)``
        for ``telemetry.slo.objectives_from_config``: a tenant's own
        target wins, else it inherits the serve-phase default.  Empty
        for the degenerate single-tenant registry — no extra lanes, no
        behavior change."""
        if not self.multi:
            return []
        out = []
        for s in self._specs.values():
            p99 = s.slo_p99_ms if s.slo_p99_ms > 0 else default_p99_ms
            err = (
                s.slo_error_ratio
                if s.slo_error_ratio > 0
                else default_error_ratio
            )
            out.append((s.name, p99, err))
        return out

    def describe(self) -> Dict[str, Dict]:
        """Static per-tenant shape for /stats (quota/weight/model —
        live counters ride telemetry)."""
        return {
            s.name: {
                "weight": s.weight,
                "rps": s.rps,
                "burst": s.capacity if s.limited else 0.0,
                "model": s.model,
            }
            for s in self._specs.values()
        }
