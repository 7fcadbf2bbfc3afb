"""sat_tpu_torch.telemetry — host-side tracing and run-health metrics, the
port's copy of ``sat_tpu.telemetry``'s host half.

Ring-buffered spans, counters and gauges (``spans``), the pollable
``heartbeat.json`` writer (``heartbeat``), and the serve plane's
operations layer: request tracing (``tracectx``), the Prometheus render
(``promtext``), cost attribution and the metering ledger (``metering``),
the capacity model (``capacity``), SLOs (``slo``), the flight recorder
(``blackbox``), live profiles on torch.profiler (``profwin``), and the
Chrome-trace, JSONL and attention exporters (``exporters``).  The
registry is off (the null object) until a caller enables it;
``--phase serve`` and ``--phase bulk`` always do.  Only ``spans`` is
imported eagerly.
"""

from __future__ import annotations

import os
import time

from .spans import (  # noqa: F401
    NULL_SPAN,
    NULL_TELEMETRY,
    NullTelemetry,
    Telemetry,
    count,
    disable,
    enable,
    enabled,
    gauge,
    get,
    record,
    span,
)

# One id per process lifetime: every artifact a run writes carries it, so
# post-hoc joins never depend on file mtimes or directory layout.
RUN_ID = f"{int(time.time()):x}-{os.getpid()}"

# Version of the artifact contract (heartbeat.json); bump it when a field
# changes meaning, not when fields are added.
SCHEMA_VERSION = 1


def run_id() -> str:
    return RUN_ID


# (rank, world) of a torch.distributed launch; (0, 1) until
# parallel.mesh.initialize_distributed joins one
_IDENTITY = [0, 1]


def process_identity() -> tuple:
    """(process_index, process_count) stamped on multi-host artifacts: this
    rank and the launch's world size, (0, 1) in a single process."""
    return _IDENTITY[0], _IDENTITY[1]


def set_process_identity(index: int, count: int) -> None:
    """Record this process's rank and the world size (the mesh bootstrap
    calls it once)."""
    _IDENTITY[:] = [int(index), int(count)]
