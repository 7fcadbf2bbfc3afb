"""Online caption-quality signals + streaming drift detection.

The port's copy of ``sat_tpu.telemetry.quality``.

The model-quality observability plane (docs/OBSERVABILITY.md "Caption
quality"): everything here runs HOST-SIDE at the serve/bulk detok
boundary on arrays the drain already synced — the quality plane adds
zero device transfers, and the sync lint covers this module to keep it
that way.

Three layers, all jax-free (the telemetry-core import gate pins that):

* **signal extraction** — per-request scalars from the drained beam
  arrays: beam log-prob margin (top1 - top2), length-normalized
  log-prob, caption length, distinct-token ratio, repeated-bigram
  rate, unk/OOV rate, eos-truncation flag, and — when the engine was
  warmed with ``return_alphas`` — the online versions of the paper's
  attention diagnostics: coverage deviation (the unscaled
  doubly-stochastic penalty of Xu et al. eq. 14, the same formula as
  ``telemetry/device.py``'s training tap) and mean attention entropy.
* **streaming drift** — one :class:`FixedBinSketch` per signal
  (O(1)/request rotating window), a frozen reference distribution
  (captured from the first window of traffic, or loaded/exported as
  ``quality_reference.json``), and per-signal PSI drift scores
  published as ``quality/*`` gauges.
* **shared "quality" definitions** — the lifecycle canary's
  caption-divergence scoring lives here too (``lifecycle/canary.py``
  re-exports it), so the canary gate and steady-state drift share one
  definition of caption quality.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

REFERENCE_SCHEMA_VERSION = 1

# a current-window bin whose REFERENCE probability is below this is a
# "drift contributor": the request landed where the reference says
# traffic essentially never lands (exemplar trigger)
RARE_REFERENCE_PROB = 1e-3

# -- per-request signal extraction ------------------------------------------

# (name, lo, hi) — the static fixed-bin sketch ranges.  Static on
# purpose: a reference exported by one process must bin identically in
# another, so the edges are part of the schema, not the data.
SIGNALS: Tuple[Tuple[str, float, float], ...] = (
    ("margin", 0.0, 10.0),
    ("norm_logprob", -10.0, 0.0),
    ("caption_len", 0.0, 64.0),
    ("distinct_ratio", 0.0, 1.0),
    ("repeat_bigram", 0.0, 1.0),
    ("unk_rate", 0.0, 1.0),
    ("eos_trunc", 0.0, 1.0),
    ("coverage_dev", 0.0, 4.0),
    ("attn_entropy", 0.0, 8.0),
)

SIGNAL_NAMES: Tuple[str, ...] = tuple(name for name, _, _ in SIGNALS)


def host_coverage_deviation(alphas: np.ndarray, steps: int) -> float:
    """mean_i (1 - Σ_{t<steps} α_ti)² for ONE caption's [T, N] attention
    maps — the host twin of ``telemetry/device.py``'s
    ``alpha_coverage_deviation`` (identical for B=1 with a
    first-``steps`` mask; pinned by tests/test_quality.py)."""
    steps = max(0, min(int(steps), alphas.shape[0]))
    a = np.asarray(alphas[:steps], np.float32)  # sync-ok: host numpy, already drained
    coverage = a.sum(axis=0)  # [N]
    d = 1.0 - coverage
    return float(np.mean(d * d))  # sync-ok: host numpy, already drained


def host_attention_entropy(alphas: np.ndarray, steps: int) -> float:
    """Mean per-word attention entropy over the first ``steps`` rows of
    ONE caption's [T, N] maps — the host twin of ``device.py``'s
    ``attention_entropy`` (same clip floor)."""
    steps = max(0, min(int(steps), alphas.shape[0]))
    if steps == 0:
        return 0.0
    a = np.asarray(alphas[:steps], np.float32)  # sync-ok: host numpy, already drained
    h = -np.sum(a * np.log(np.clip(a, 1e-10, 1.0)), axis=-1)  # [steps]
    return float(np.mean(h))  # sync-ok: host numpy, already drained


def extract_signals(
    words: np.ndarray,
    lengths: np.ndarray,
    scores: np.ndarray,
    *,
    vocab_size: int,
    eos_id: int,
    alphas: Optional[np.ndarray] = None,
) -> Dict[str, float]:
    """ONE request's quality signals from its drained beam arrays.

    ``words`` [K, T] int ids, ``lengths`` [K], ``scores`` [K] summed
    log-probs — exactly the per-row slices the detok loop already holds
    (beam 0 is the ranked-best hypothesis).  ``alphas`` [K, T, N] adds
    the attention diagnostics when the engine drained them.  Pure host
    arithmetic; deterministic, so the bulk plane can stamp these into
    bitwise-reproducible shard rows.
    """
    K = int(words.shape[0])
    length = max(1, int(lengths[0]))
    ids = [int(w) for w in words[0, :length]]
    top1 = float(scores[0])  # sync-ok: host numpy, already drained
    margin = top1 - float(scores[1]) if K >= 2 else 0.0  # sync-ok: host numpy, already drained
    oov = sum(1 for i in ids if i <= 0 or i >= vocab_size)
    distinct = len(set(ids)) / length
    if length >= 2:
        bigrams = list(zip(ids, ids[1:]))
        repeat = 1.0 - len(set(bigrams)) / len(bigrams)
    else:
        repeat = 0.0
    sig = {
        "margin": margin,
        "norm_logprob": top1 / length,
        "caption_len": float(length),  # sync-ok: host scalar, no device value
        "distinct_ratio": distinct,
        "repeat_bigram": repeat,
        "unk_rate": oov / length,
        "eos_trunc": 0.0 if int(eos_id) in ids else 1.0,
    }
    if alphas is not None:
        sig["coverage_dev"] = host_coverage_deviation(alphas[0], length)
        sig["attn_entropy"] = host_attention_entropy(alphas[0], length)
    return sig


# -- canary divergence (shared definition; lifecycle/canary re-exports) -----


def caption_divergence(incumbent: str, candidate: str) -> float:
    """Token Jaccard distance between two captions in [0, 1] — the
    lifecycle canary's "did the model change what it says" score."""
    a = set(incumbent.split())
    b = set(candidate.split())
    if not a and not b:
        return 0.0
    union = a | b
    if not union:
        return 0.0
    return 1.0 - len(a & b) / len(union)


class DivergenceGauge:
    """EWMA of shadow-pair divergences; one float of state, no locks
    needed beyond the GIL (single shadow worker updates it)."""

    def __init__(self, alpha: float = 0.3) -> None:
        self.alpha = float(alpha)  # sync-ok: host config scalar
        self.value: Optional[float] = None
        self.samples = 0

    def update(self, divergence: float) -> float:
        d = min(1.0, max(0.0, float(divergence)))  # sync-ok: host scalar
        self.value = (
            d
            if self.value is None
            else self.alpha * d + (1 - self.alpha) * self.value
        )
        self.samples += 1
        return self.value


# -- streaming sketches + PSI -----------------------------------------------


class FixedBinSketch:
    """Fixed-bin histogram over a rotating window — O(1) per update.

    The window is a deque of (bin, value); an update appends one entry,
    bumps its bin count, and evicts exactly one stale entry once the
    window is full (the ``capacity.py`` rotation discipline — cost never
    grows with traffic).  Bin edges are static (part of the reference
    schema), uniform over [lo, hi] with both tails clamped into the
    terminal bins.
    """

    __slots__ = ("lo", "hi", "bins", "window", "counts", "_entries", "_sum")

    def __init__(
        self, lo: float, hi: float, bins: int = 16, window: int = 256
    ) -> None:
        if not hi > lo:
            raise ValueError(f"FixedBinSketch: hi {hi} must be > lo {lo}")
        self.lo = float(lo)  # sync-ok: host scalar, no device value
        self.hi = float(hi)  # sync-ok: host scalar, no device value
        self.bins = int(bins)
        self.window = max(1, int(window))
        self.counts = [0] * self.bins
        self._entries: deque = deque()
        self._sum = 0.0

    def bin_of(self, x: float) -> int:
        frac = (float(x) - self.lo) / (self.hi - self.lo)  # sync-ok: host scalar, no device value
        return min(self.bins - 1, max(0, int(frac * self.bins)))

    def update(self, x: float) -> None:
        b = self.bin_of(x)
        self._entries.append((b, float(x)))  # sync-ok: host scalar, no device value
        self.counts[b] += 1
        self._sum += float(x)  # sync-ok: host scalar, no device value
        if len(self._entries) > self.window:
            old_b, old_x = self._entries.popleft()
            self.counts[old_b] -= 1
            self._sum -= old_x

    @property
    def total(self) -> int:
        return len(self._entries)

    def mean(self) -> float:
        n = len(self._entries)
        return self._sum / n if n else 0.0

    def probs(self) -> List[float]:
        n = len(self._entries)
        if not n:
            return [0.0] * self.bins
        return [c / n for c in self.counts]


def psi(
    current: Sequence[float], reference: Sequence[float], eps: float = 1e-4
) -> float:
    """Population Stability Index between two binned distributions:
    Σ (p - q)·ln(p/q) with epsilon smoothing.  0 for identical windows;
    the classic operating points are ~0.1 (investigate) and ~0.25
    (population shifted).  Either side empty → 0 (no evidence yet)."""
    p = [max(float(v), 0.0) for v in current]  # sync-ok: host scalar, no device value
    q = [max(float(v), 0.0) for v in reference]  # sync-ok: host scalar, no device value
    if sum(p) <= 0 or sum(q) <= 0:
        return 0.0
    p = [max(v, eps) for v in p]
    q = [max(v, eps) for v in q]
    ps, qs = sum(p), sum(q)
    p = [v / ps for v in p]
    q = [v / qs for v in q]
    return float(sum((a - b) * math.log(a / b) for a, b in zip(p, q)))  # sync-ok: host scalar, no device value


# -- frozen reference -------------------------------------------------------


class QualityReference:
    """The frozen per-signal distributions drift is scored against.

    Round-trips through ``quality_reference.json`` so one process's
    steady-state traffic can gate another's (export via GET
    /quality_reference, load via --quality_reference).
    """

    def __init__(
        self,
        probs: Dict[str, List[float]],
        counts: Optional[Dict[str, int]] = None,
        fingerprint: Optional[Dict] = None,
    ) -> None:
        self.probs = {k: list(v) for k, v in probs.items()}
        self.counts = dict(counts or {})
        self.fingerprint = dict(fingerprint or {})

    @classmethod
    def from_sketches(
        cls,
        sketches: Dict[str, FixedBinSketch],
        fingerprint: Optional[Dict] = None,
    ) -> "QualityReference":
        return cls(
            probs={k: s.probs() for k, s in sketches.items()},
            counts={k: s.total for k, s in sketches.items()},
            fingerprint=fingerprint,
        )

    def to_payload(self) -> Dict:
        return {
            "schema_version": REFERENCE_SCHEMA_VERSION,
            "signals": {
                name: {
                    "lo": lo,
                    "hi": hi,
                    "probs": [round(p, 8) for p in self.probs.get(name, [])],
                    "count": self.counts.get(name, 0),
                }
                for name, lo, hi in SIGNALS
                if name in self.probs
            },
            "fingerprint": self.fingerprint,
        }

    @classmethod
    def from_payload(cls, payload: Dict) -> "QualityReference":
        version = payload.get("schema_version")
        if version != REFERENCE_SCHEMA_VERSION:
            raise ValueError(
                f"quality reference schema {version!r} != "
                f"{REFERENCE_SCHEMA_VERSION}"
            )
        signals = payload.get("signals", {})
        return cls(
            probs={k: list(v.get("probs", [])) for k, v in signals.items()},
            counts={k: int(v.get("count", 0)) for k, v in signals.items()},
            fingerprint=payload.get("fingerprint") or {},
        )

    def save(self, path: str) -> None:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.to_payload(), f, sort_keys=True, indent=1)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "QualityReference":
        with open(path) as f:
            return cls.from_payload(json.load(f))


# -- the streaming monitor --------------------------------------------------


class QualityMonitor:
    """Per-request quality accounting: rotating sketches (global + a
    per-tenant cut), PSI drift vs the frozen reference, and the outlier
    verdicts that arm the exemplar flight recorder.

    ``observe`` is the per-request hot-path entry (detok thread):
    O(signals) sketch updates and threshold checks.  PSI recomputation
    and gauge publication are rate-limited to ``publish_interval_s`` so
    a traffic burst pays sketch-update cost only.  Thread-safe: serve
    detok and lifecycle shadow workers may observe concurrently.
    """

    def __init__(
        self,
        *,
        window: int = 256,
        bins: int = 16,
        reference: Optional[QualityReference] = None,
        margin_min: float = 0.0,
        unk_max: float = 1.0,
        publish_interval_s: float = 0.25,
        tel=None,
        clock=time.monotonic,
    ) -> None:
        from . import get as _get_tel

        self.window = int(window)
        self.bins = int(bins)
        self.margin_min = float(margin_min)  # sync-ok: host scalar, no device value
        self.unk_max = float(unk_max)  # sync-ok: host scalar, no device value
        self.publish_interval_s = float(publish_interval_s)  # sync-ok: host scalar, no device value
        self._tel = tel if tel is not None else _get_tel()
        self._clock = clock
        self._lock = threading.Lock()
        self._sketches = self._fresh_sketches()
        self._tenant_sketches: Dict[str, Dict[str, FixedBinSketch]] = {}
        self.reference = reference
        self.reference_source = "file" if reference is not None else ""
        self.requests = 0
        self.outliers = 0
        self._t_published = -math.inf
        self._psi: Dict[str, float] = {}
        self._tenant_psi_max: Dict[str, float] = {}

    def _fresh_sketches(self) -> Dict[str, FixedBinSketch]:
        return {
            name: FixedBinSketch(lo, hi, self.bins, self.window)
            for name, lo, hi in SIGNALS
        }

    # -- hot path ----------------------------------------------------------

    def observe(
        self, signals: Dict[str, float], tenant: str = ""
    ) -> List[str]:
        """Fold one request's signals in; returns the outlier reasons
        (empty = unremarkable) the caller feeds the exemplar recorder."""
        reasons: List[str] = []
        with self._lock:
            self.requests += 1
            for name, value in signals.items():
                sketch = self._sketches.get(name)
                if sketch is not None:
                    sketch.update(value)
            if tenant:
                lanes = self._tenant_sketches.get(tenant)
                if lanes is None:
                    lanes = self._fresh_sketches()
                    self._tenant_sketches[tenant] = lanes
                for name, value in signals.items():
                    if name in lanes:
                        lanes[name].update(value)
            if (
                self.reference is None
                and self._sketches["margin"].total >= self.window
            ):
                # warmup freeze: the first full window IS the reference
                self.reference = QualityReference.from_sketches(
                    self._sketches
                )
                self.reference_source = "warmup"
            margin = signals.get("margin")
            if self.margin_min > 0 and margin is not None:
                if margin < self.margin_min:
                    reasons.append("low_margin")
            unk = signals.get("unk_rate")
            if self.unk_max < 1 and unk is not None and unk > self.unk_max:
                reasons.append("high_unk")
            if signals.get("eos_trunc", 0.0) >= 1.0:
                reasons.append("eos_trunc")
            if self.reference is not None:
                # drift contribution: the request landed in a bin the
                # frozen reference says traffic essentially never hits
                for name in ("margin", "norm_logprob", "coverage_dev"):
                    value = signals.get(name)
                    ref = self.reference.probs.get(name)
                    if value is None or not ref:
                        continue
                    b = self._sketches[name].bin_of(value)
                    if ref[b] < RARE_REFERENCE_PROB:
                        reasons.append(f"drift_{name}")
            if reasons:
                self.outliers += 1
        self.maybe_publish()
        return reasons

    # -- drift scoring + publication ---------------------------------------

    def drift_scores(self) -> Dict[str, float]:
        """Per-signal PSI vs the frozen reference ({} until frozen)."""
        with self._lock:
            if self.reference is None:
                return {}
            out = {}
            for name, sketch in self._sketches.items():
                ref = self.reference.probs.get(name)
                if not ref or not sketch.total:
                    continue
                out[name] = psi(sketch.probs(), ref)
            return out

    def maybe_publish(self, force: bool = False) -> None:
        """Rate-limited gauge refresh (scrape paths call with force)."""
        now = self._clock()
        if not force and now - self._t_published < self.publish_interval_s:
            return
        self._t_published = now
        scores = self.drift_scores()
        with self._lock:
            self._psi = scores
            tel = self._tel
            for name, value in scores.items():
                tel.gauge(f"quality/{name}_psi", round(value, 4))
            tel.gauge(
                "quality/psi_max",
                round(max(scores.values()), 4) if scores else 0.0,
            )
            tel.gauge(
                "quality/unk_rate",
                round(self._sketches["unk_rate"].mean(), 4),
            )
            tel.gauge(
                "quality/margin_mean",
                round(self._sketches["margin"].mean(), 4),
            )
            tel.gauge("quality/requests", self.requests)
            tel.gauge("quality/outliers", self.outliers)
            tel.gauge(
                "quality/reference_frozen",
                1 if self.reference is not None else 0,
            )
            self._tenant_psi_max = {}
            if self.reference is not None:
                for tenant, lanes in self._tenant_sketches.items():
                    worst = 0.0
                    for name, sketch in lanes.items():
                        ref = self.reference.probs.get(name)
                        if ref and sketch.total:
                            worst = max(worst, psi(sketch.probs(), ref))
                    self._tenant_psi_max[tenant] = worst
                    tel.gauge(
                        f"quality/tenant_{tenant}_psi_max", round(worst, 4)
                    )

    # -- surfaces ----------------------------------------------------------

    def reference_payload(self) -> Optional[Dict]:
        with self._lock:
            if self.reference is None:
                return None
            return self.reference.to_payload()

    def snapshot(self) -> Dict:
        """The /stats ``quality`` block (and the router's fan-in unit):
        plain floats/ints only, so the fleet merge can sum or max them
        with dict arithmetic."""
        with self._lock:
            return {
                "requests": self.requests,
                "outliers": self.outliers,
                "reference": self.reference_source,
                "psi": {k: round(v, 4) for k, v in self._psi.items()},
                "psi_max": round(max(self._psi.values()), 4)
                if self._psi
                else 0.0,
                "unk_rate": round(self._sketches["unk_rate"].mean(), 4),
                "margin_mean": round(self._sketches["margin"].mean(), 4),
                "tenants": {
                    t: {
                        "psi_max": round(v, 4),
                        "requests": self._tenant_sketches[t]["margin"].total,
                    }
                    for t, v in sorted(self._tenant_psi_max.items())
                },
            }
