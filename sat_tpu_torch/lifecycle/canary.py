"""Canary routing + caption-divergence scoring — pure host functions.

The port's copy of ``sat_tpu.lifecycle.canary``.

Routing is a **deterministic hash** of the X-Request-Id: a retry of the
same request (same id, per the tracing contract) always lands on the
same param slot, so a client retrying into the canary window can't
flap between two models mid-conversation, and tests can pick ids that
provably land on either side of the fraction.  No RNG, no state.

Divergence is a token-level Jaccard distance between the incumbent's
and the candidate's captions for the SAME image (shadow-sampled by the
controller): 0 = identical token sets, 1 = disjoint.  It is the cheap
"did the model change what it says" signal that p99/error-rate SLOs
cannot see — a candidate can be fast, error-free, and caption every
image as "a a a a".  The implementation lives in
:mod:`sat_tpu_torch.telemetry.quality` (one quality module serves both the
canary gate and the steady-state drift plane); this module re-exports
``caption_divergence`` / ``DivergenceGauge`` for its existing callers.
Jax-free: the lifecycle control plane imports this module in the
router and in jax-free tooling.
"""

from __future__ import annotations

import hashlib
from typing import Optional

from ..telemetry.quality import DivergenceGauge, caption_divergence

__all__ = [
    "INCUMBENT",
    "CANARY",
    "request_weight",
    "assign_slot",
    "caption_divergence",
    "DivergenceGauge",
]

INCUMBENT = "incumbent"
CANARY = "canary"

# 8 hex digits of the sha256 -> a uniform draw in [0, 1) with 2^32 grain
_HASH_DENOM = float(1 << 32)  # sync-ok: host constant, no device value


def request_weight(request_id: str) -> float:
    """The request's deterministic position in [0, 1): requests below
    ``canary_fraction`` route to the candidate."""
    digest = hashlib.sha256(request_id.encode("utf-8")).hexdigest()
    return int(digest[:8], 16) / _HASH_DENOM


def assign_slot(request_id: Optional[str], fraction: float) -> str:
    """Which param slot serves ``request_id`` at this canary fraction.
    Sticky: the same id maps to the same slot for any fixed fraction,
    and a slot assigned at fraction f stays canary at any fraction > f
    (the hash is a fixed position, the fraction a moving threshold)."""
    if not request_id or fraction <= 0:
        return INCUMBENT
    if fraction >= 1:
        return CANARY
    return CANARY if request_weight(request_id) < fraction else INCUMBENT
