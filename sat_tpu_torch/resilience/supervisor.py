"""Crash-only supervisor: restart a wedged/crashed run from LAST_GOOD —
the port's copy of ``sat_tpu.resilience.supervisor``.

``python -m sat_tpu_torch.cli --supervise ...`` keeps the parent process
**torch-free forever** (the failure it exists to outlive is the device
runtime hanging uninterruptibly in the child; a CUDA context in the
parent would also hold card memory across the child's restarts) and
runs the real work in a child process:

* the child is the identical CLI invocation minus ``--supervise``;
* a nonzero child exit — the watchdog's ``WATCHDOG_EXIT_CODE`` (wedged,
  state on disk is good), a ``SimulatedPreemption``/checkpoint failure
  (rc 1), or a signal death (rc < 0) — triggers a bounded-retry restart
  with the jittered exponential backoff of ``resilience.retry``;
* restarted children get ``--load`` appended (when absent) so they
  resume from the ``LAST_GOOD`` lineage pointer, and
  ``SAT_SUPERVISOR_RESTARTS`` in their environment (the train heartbeat
  that gauges it as ``supervisor/restarts`` is not ported yet);
* ``SAT_FI_*`` fault-injection variables are disarmed for restarted
  children: an injected deterministic fault would otherwise re-fire at
  the same step on every incarnation and live-lock the supervisor;
* SIGTERM/SIGINT to the supervisor forwards to the child and stops the
  restart loop — preemption of the *pair* stays graceful.

The supervisor exits 0 when a child finally succeeds, else with the last
child's exit code once the restart budget is spent.  A child that exits
87 (the quarantine's systemic-corruption ceiling) is never restarted.
"""

from __future__ import annotations

import os
import random
import signal
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

from .faultinject import ENV_PREFIX as _FI_PREFIX
from .quarantine import DATA_CORRUPTION_EXIT_CODE
from .retry import backoff_delay
from .watchdog import WATCHDOG_EXIT_CODE

RESTARTS_ENV = "SAT_SUPERVISOR_RESTARTS"

# Supervisor-side PRNG mirrors retry._jitter_rng: fixed seed for
# deterministic tests, PID decorrelation on a real fleet.
_rng = random.Random(0x5A7D)


def _strip_supervise(argv: List[str]) -> List[str]:
    out = []
    skip = False
    for a in argv:
        if skip:
            skip = False
            continue
        if a == "--supervise":
            continue
        if a == "--max_restarts":
            skip = True
            continue
        if a.startswith("--max_restarts="):
            continue
        out.append(a)
    return out


def _describe(rc: int) -> str:
    # The child writes postmortem_<run_id>/ under its telemetry dir on
    # both abnormal codes when launched with --blackbox; the supervisor
    # is a torch-free parent that never resolves that path, so it names
    # the analyzer instead of the bundle.
    if rc == WATCHDOG_EXIT_CODE:
        return (
            "watchdog abort (wedged run; LAST_GOOD landed); with "
            "--blackbox a postmortem_<run_id>/ bundle is in the telemetry "
            "dir — summarize with scripts/analyze_postmortem.py"
        )
    if rc == DATA_CORRUPTION_EXIT_CODE:
        return (
            "systemic data corruption (quarantine ceiling); with "
            "--blackbox see postmortem_<run_id>/ via "
            "scripts/analyze_postmortem.py"
        )
    if rc < 0:
        try:
            return f"killed by {signal.Signals(-rc).name}"
        except ValueError:
            return f"killed by signal {-rc}"
    return f"exit code {rc}"


def supervise(
    argv: List[str],
    *,
    max_restarts: int = 3,
    backoff_base_s: float = 1.0,
    backoff_max_s: float = 60.0,
    runner: Optional[Callable[[List[str], Dict[str, str]], int]] = None,
    sleep: Callable[[float], None] = time.sleep,
) -> int:
    """Run ``python -m sat_tpu_torch.cli <argv minus --supervise>`` under the
    crash-only restart policy.  ``runner`` overrides the child launch for
    tests (receives the full command + environment, returns an rc)."""
    child_argv = _strip_supervise(list(argv))
    restarts = 0
    stop = {"signaled": None}

    child_proc: Dict[str, Optional[subprocess.Popen]] = {"p": None}

    def _forward(signum, frame):
        stop["signaled"] = signum
        p = child_proc["p"]
        if p is not None and p.poll() is None:
            try:
                p.send_signal(signum)
            except OSError:
                pass

    installed = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            installed[sig] = signal.signal(sig, _forward)
        except ValueError:  # not the main thread (tests)
            pass

    def _launch(cmd: List[str], env: Dict[str, str]) -> int:
        if runner is not None:
            return runner(cmd, env)
        p = subprocess.Popen(cmd, env=env)
        child_proc["p"] = p
        try:
            return p.wait()
        finally:
            child_proc["p"] = None

    try:
        while True:
            this_argv = list(child_argv)
            env = dict(os.environ)
            env[RESTARTS_ENV] = str(restarts)
            if restarts:
                if "--load" not in this_argv:
                    this_argv.append("--load")
                for k in [k for k in env if k.startswith(_FI_PREFIX)]:
                    del env[k]
            cmd = [sys.executable, "-m", "sat_tpu_torch.cli"] + this_argv
            print(
                f"[supervise] launching attempt {restarts + 1} "
                f"(restarts so far: {restarts}): {' '.join(this_argv)}",
                file=sys.stderr,
                flush=True,
            )
            rc = _launch(cmd, env)
            if rc == 0:
                if restarts:
                    print(
                        f"[supervise] run completed after {restarts} "
                        "restart(s)",
                        file=sys.stderr,
                        flush=True,
                    )
                return 0
            if stop["signaled"] is not None:
                print(
                    f"[supervise] child died ({_describe(rc)}) after the "
                    "supervisor was signaled — not restarting",
                    file=sys.stderr,
                    flush=True,
                )
                return rc
            if rc == DATA_CORRUPTION_EXIT_CODE:
                # fatal, never restarted: the rot is in the INPUT data,
                # so a relaunch deterministically re-reads it and trips
                # the same ceiling — crash-only restarts only help when
                # the failure is in the process plane
                print(
                    f"[supervise] child failed ({_describe(rc)}) — not "
                    "restarting; repair the data (--repair_shards) or "
                    "inspect the quarantine ledger",
                    file=sys.stderr,
                    flush=True,
                )
                return rc
            if restarts >= max_restarts:
                print(
                    f"[supervise] child failed ({_describe(rc)}) and the "
                    f"restart budget ({max_restarts}) is spent — giving up",
                    file=sys.stderr,
                    flush=True,
                )
                return rc
            delay = backoff_delay(
                restarts,
                base_delay_s=backoff_base_s,
                max_delay_s=backoff_max_s,
                rng=_rng,
            )
            restarts += 1
            print(
                f"[supervise] child failed ({_describe(rc)}); restarting "
                f"from LAST_GOOD in {delay:.2f}s "
                f"(restart {restarts}/{max_restarts})",
                file=sys.stderr,
                flush=True,
            )
            sleep(delay)
    finally:
        for sig, prev in installed.items():
            signal.signal(sig, prev)
