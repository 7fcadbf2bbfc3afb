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

# Version of the artifact contract (heartbeat.json, the tools' report
# rows); bump it when a field changes meaning, not when fields are added.
# ``scripts/check_regression.py`` refuses rows stamped with another major.
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


def bench_stamp() -> dict:
    """Provenance stamp of a report row (the chaos campaign's, as the JAX
    package's ``bench_stamp`` stamps its bench rows): the artifact schema
    version, git SHA, run id, process identity and a device/host
    descriptor, the fields ``scripts/check_regression.py`` needs to decide
    whether two artifacts are comparable.

    Import-light: it never imports torch.  The card's facts (``platform``
    "gpu", ``kind``, ``device_count`` and the ``power_limit`` that
    ``nvidia-smi`` reports) are filled only when the caller has already
    initialized CUDA in this process, as the JAX stamp fills its device
    only after the caller initialized jax."""
    import platform
    import subprocess
    import sys

    sha = None
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short=12", "HEAD"],
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
            capture_output=True,
            text=True,
            timeout=5,
        )
        sha = out.stdout.strip() or None
    except Exception:
        pass
    device = {
        "host": platform.node(),
        "machine": platform.machine(),
        "python": platform.python_version(),
    }
    torch = sys.modules.get("torch")
    if torch is not None:
        try:
            if torch.cuda.is_initialized():
                device.update(
                    platform="gpu",
                    kind=torch.cuda.get_device_name(0),
                    device_count=torch.cuda.device_count(),
                    power_limit=power_limit(),
                )
        except Exception:
            pass
    process_index, process_count = process_identity()
    return {
        "schema_version": SCHEMA_VERSION,
        "git_sha": sha,
        "run_id": RUN_ID,
        "stamp_unix": round(time.time(), 3),
        "process_index": process_index,
        "process_count": process_count,
        "device": device,
    }


def power_limit(index: int = 0):
    """Card ``index``'s power limit as ``nvidia-smi --query-gpu=name,
    power.limit`` prints it ("700.00 W"), or None where nvidia-smi does not
    answer."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    rows = out.stdout.strip().splitlines() if out.returncode == 0 else []
    return rows[index].rsplit(",", 1)[-1].strip() if index < len(rows) else None
