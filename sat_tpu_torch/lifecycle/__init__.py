"""Zero-downtime model lifecycle: hot-swap reloader, canary routing,
SLO-gated promote/rollback.

The port's copy of ``sat_tpu.lifecycle``.

The control plane (reloader, canary hash, controller state machine) is
host code; only the loader touches torch and the device.
"""

from .canary import (
    CANARY,
    INCUMBENT,
    DivergenceGauge,
    assign_slot,
    caption_divergence,
    request_weight,
)
from .controller import STATE_CODES, STATES, LifecycleController
from .loader import load_candidate
from .reloader import Reloader

__all__ = [
    "CANARY",
    "INCUMBENT",
    "DivergenceGauge",
    "LifecycleController",
    "Reloader",
    "STATES",
    "STATE_CODES",
    "assign_slot",
    "caption_divergence",
    "load_candidate",
    "request_weight",
]
