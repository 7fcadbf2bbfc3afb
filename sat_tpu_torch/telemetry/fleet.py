"""The fleet straggler rule — the port's copy of the part of
``sat_tpu.telemetry.fleet`` the serve router needs.

The router's fleet view (``serve/router.py``) names its slow replica
with :func:`straggler_verdict`.  The train-side sidecar plane of the
same module (``FleetPlane``, ``--fleet_telemetry``: per-host
``heartbeat_p<i>.json`` files merged into ``fleet.json``) comes with
parallel training and is not here yet.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def straggler_verdict(named_values: Dict[str, float], factor: float) -> Dict:
    """The fleet straggler rule, as a pure decision both planes share.

    Train side: per-host step-time p95s; serve side: the router's fleet
    view feeds per-replica request p99s.  With >= 2 reporters and a
    positive median, the worst reporter is named a straggler when its
    value STRICTLY exceeds ``median * factor`` — equality is "keeping
    up".  Returns ``{"verdict": bool, ...}`` with ``name``/``value``/
    ``median``/``skew`` when at least one reporter supplied a value."""
    if not named_values:
        return {"verdict": False}
    worst_name = max(named_values, key=lambda k: named_values[k])
    worst = float(named_values[worst_name])
    median = float(np.median(list(named_values.values())))
    return {
        "verdict": (
            len(named_values) >= 2 and median > 0 and worst > median * factor
        ),
        "name": worst_name,
        "value": round(worst, 4),
        "median": round(median, 4),
        "skew": round(worst / median, 4) if median > 0 else 0.0,
    }
