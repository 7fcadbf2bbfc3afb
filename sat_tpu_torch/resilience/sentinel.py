"""Anomaly sentinel: NaN/Inf + loss-spike detection at log boundaries — the
port's copy of ``sat_tpu.resilience.sentinel``.

The train loop's one deliberate host sync is the ``log_every`` metrics
fetch (``runtime.train``); the sentinel inspects THOSE host-side floats
and nothing else, so arming it adds **zero device syncs** to the hot
path.  The trade-off is
detection latency: a poison step is noticed at the next log boundary,
which is why recovery is lineage-based (roll back to ``LAST_GOOD``)
rather than "undo one step".

Policies (``Config.anomaly_policy``):

* ``off``      — sentinel disarmed entirely.
* ``warn``     — report the anomaly and keep training; checkpoints keep
                 being written but ``LAST_GOOD`` stops advancing while
                 unhealthy, so the blessed restore point stays clean.
* ``skip``     — additionally suppress checkpoint writes while unhealthy
                 (no disk churn from poisoned state); training continues
                 in case the run self-recovers (it often does after an
                 inf-loss batch under float32).
* ``rollback`` — restore ``LAST_GOOD`` and fast-forward the loader past
                 the poison step (``runtime.train`` drives the actual
                 restore via ``dataset.seek``); bounded at
                 ``MAX_ROLLBACKS`` per run, then degrades to ``warn`` so
                 a persistently-diverging run cannot live-lock.

Decisions are pure-host float compares.
"""

from __future__ import annotations

import math
import sys
from typing import Dict, Optional

from .. import telemetry


# A diverging run that keeps tripping rollback would otherwise loop
# forever restoring the same checkpoint; after this many restores the
# sentinel degrades to `warn` and lets the run fail visibly.
MAX_ROLLBACKS = 3

POLICIES = ("off", "warn", "skip", "rollback")


class AnomalySentinel:
    """Tracks metric health across ``log_every`` boundaries and answers
    the two questions the train loop asks: *should this checkpoint be
    blessed?* (``healthy``) and *should we roll back now?* (``check``
    returning ``"rollback"``)."""

    def __init__(self, policy: str, spike_factor: float = 0.0):
        if policy not in POLICIES:
            raise ValueError(f"anomaly_policy={policy!r}: expected one of {POLICIES}")
        self.policy = policy
        # loss > spike_factor * EMA(loss) counts as an anomaly (0 disables
        # spike detection; NaN/Inf detection is always on when armed)
        self.spike_factor = float(spike_factor)
        self._ema: Optional[float] = None
        self.healthy = True
        self.last_reason = ""
        self.rollbacks = 0
        self.anomalies = 0

    @property
    def armed(self) -> bool:
        return self.policy != "off"

    @property
    def suppress_save(self) -> bool:
        """`skip` policy while unhealthy: don't churn disk with poisoned
        checkpoints.  Other policies keep writing (the LAST_GOOD gate
        already protects the blessed pointer)."""
        return self.policy == "skip" and not self.healthy

    def _classify(self, metrics: Dict[str, float]) -> Optional[str]:
        # name every non-finite metric, not just the first: which ones
        # went bad localizes the fault
        bad = []
        for name, value in metrics.items():
            v = float(value)
            if math.isnan(v) or math.isinf(v):
                bad.append(f"{name}={v}")
        if bad:
            shown = ", ".join(bad[:8])
            if len(bad) > 8:
                shown += f" (+{len(bad) - 8} more)"
            return f"{shown} is not finite"
        loss = metrics.get("loss")
        if loss is not None and self.spike_factor > 0:
            v = float(loss)
            if self._ema is not None and v > self.spike_factor * self._ema:
                return (
                    f"loss={v:.4g} spiked over {self.spike_factor:g}x "
                    f"its running mean {self._ema:.4g}"
                )
            # EMA tracks only sane losses so one spike can't drag the
            # baseline up and mask the next one
            self._ema = v if self._ema is None else 0.9 * self._ema + 0.1 * v
        return None

    def check(self, step: int, metrics: Dict[str, float]) -> str:
        """Inspect host-side metric floats for the step that just logged.
        Returns the action the loop should take: ``"ok"``, ``"warn"``,
        ``"skip"``, or ``"rollback"``."""
        if not self.armed:
            return "ok"
        reason = self._classify(metrics)
        if reason is None:
            if not self.healthy:
                print(
                    f"sat_tpu_torch: metrics healthy again at step {step}",
                    file=sys.stderr,
                    flush=True,
                )
            self.healthy = True
            return "ok"
        self.anomalies += 1
        telemetry.count("sentinel/anomalies")
        self.healthy = False
        self.last_reason = reason
        action = self.policy
        if action == "rollback":
            if self.rollbacks >= MAX_ROLLBACKS:
                print(
                    f"sat_tpu_torch: anomaly at step {step} ({reason}) but rollback "
                    f"budget ({MAX_ROLLBACKS}) exhausted — degrading to warn",
                    file=sys.stderr,
                    flush=True,
                )
                return "warn"
            self.rollbacks += 1
            telemetry.count("sentinel/rollbacks")
        print(
            f"sat_tpu_torch: ANOMALY at step {step}: {reason} (policy={action})",
            file=sys.stderr,
            flush=True,
        )
        return action

    def note_rolled_back(self) -> None:
        """The loop finished restoring LAST_GOOD: restored state is
        presumed clean until the next log boundary says otherwise."""
        self.healthy = True
