"""sat_tpu_torch.telemetry — the run identity stamped on artifacts, and
the attention exporters (``telemetry.exporters``).

The port's copy of ``sat_tpu.telemetry.run_id``.  Host-side span tracing,
heartbeats and the profiler window are not ported yet.
"""

from __future__ import annotations

import os
import time

# One id per process lifetime: every artifact a run writes carries it, so
# post-hoc joins never depend on file mtimes or directory layout.
RUN_ID = f"{int(time.time()):x}-{os.getpid()}"


def run_id() -> str:
    return RUN_ID
