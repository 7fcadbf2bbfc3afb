"""Replica lifecycle for the serving fleet — the port's copy of
``sat_tpu.serve.replica`` (docs/SERVING.md).

The router (``router.py``) fronts N captioning replicas; this module
owns how those replicas come to exist and die.  Two modes:

* **local spawn** — :class:`LocalFleet` launches N ``--phase serve``
  subprocesses of the port's CLI (``python -m sat_tpu_torch.cli``) over
  a port range, each with its own summary/telemetry directory (so
  per-replica ``access.jsonl`` and heartbeats never interleave), waits
  for every ``/healthz`` to go ready, and can SIGTERM one replica into
  its drain-to-completion sequence (server.py's shutdown path) for
  deploys.
* **pre-started endpoints** — :func:`parse_endpoints` turns a
  ``host:port,host:port`` spec into the same :class:`Endpoint` records
  the router polls; lifecycle stays with whoever started them.

Deliberately torch-free (enforced by tests/test_torch_scaffold.py): the
router process must survive exactly the failures a wedged device
runtime causes, so — like the ``--supervise`` parent — it never imports
the device stack.  Every local replica is its own process with its own
CUDA context on the one card.  Subprocesses inherit the environment, so
a ``SAT_TORCH_DEVICE=cpu`` run spawns CPU replicas.

Replicas that boot together may each find the fused-attention kernel
unbuilt and build it at once.  That is safe: ``ops/build.py`` compiles
to a per-pid temporary and moves it into place with ``os.replace``, so
a loader sees a whole library or none.
"""

from __future__ import annotations

import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional

from ..config import Config


# the tier values a replica may advertise (config.serve_tier): "both"
# runs the full pipeline; "encode" only answers POST /encode; "decode"
# only seeds slots from handed-off grids (plus grid-ingress /caption)
TIERS = ("both", "encode", "decode")


class Endpoint:
    """One replica's address + identity, however it came to exist."""

    __slots__ = ("name", "host", "port", "tier")

    def __init__(
        self, name: str, host: str, port: int, tier: str = "both"
    ) -> None:
        self.name = name
        self.host = host
        self.port = int(port)
        self.tier = tier

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def __repr__(self) -> str:  # log-friendly
        suffix = "" if self.tier == "both" else f"={self.tier}"
        return f"Endpoint({self.name}={self.address}{suffix})"


def parse_endpoints(spec: str) -> List[Endpoint]:
    """``host:port[,host:port=tier,...]`` -> named endpoints (r0, r1, ...).

    The optional ``=tier`` suffix (``encode``/``decode``/``both``)
    declares a disaggregated fleet member's role to the router before
    the first /healthz poll confirms it.  Fail-fast on malformed
    entries: a router silently fronting half the fleet the operator
    asked for is worse than not starting."""
    endpoints: List[Endpoint] = []
    for i, raw in enumerate(s for s in spec.split(",") if s.strip()):
        raw = raw.strip()
        tier = "both"
        if "=" in raw:
            raw, _, tier = raw.rpartition("=")
            if tier not in TIERS:
                raise ValueError(
                    f"--replicas entry {raw!r}={tier!r}: tier must be "
                    f"one of {TIERS}"
                )
        host, sep, port = raw.rpartition(":")
        if not sep or not host:
            raise ValueError(
                f"--replicas entry {raw!r}: expected host:port[=tier]"
            )
        try:
            endpoints.append(Endpoint(f"r{i}", host, int(port), tier=tier))
        except ValueError:
            raise ValueError(
                f"--replicas entry {raw!r}: port must be an integer"
            ) from None
    if not endpoints:
        raise ValueError(f"--replicas {spec!r} names no endpoints")
    return endpoints


def free_port(host: str = "127.0.0.1") -> int:
    """An ephemeral port the OS just handed out.  Best-effort (another
    process can race for it between release and bind) — used by the
    bench/chaos harnesses, not production, where the port range is
    configured."""
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def probe_health(
    endpoint: Endpoint, timeout_s: float = 2.0
) -> Optional[Dict]:
    """One ``GET /healthz``; the parsed payload (with ``_status_code``)
    or None when unreachable/unparseable.  Stdlib http.client so the
    probe shares no state with the router's pooled proxy connections."""
    conn = http.client.HTTPConnection(
        endpoint.host, endpoint.port, timeout=timeout_s
    )
    try:
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        payload = json.loads(resp.read())
        if not isinstance(payload, dict):
            return None
        payload["_status_code"] = resp.status
        return payload
    except (OSError, ValueError):
        return None
    finally:
        conn.close()


class ReplicaProcess:
    """One locally spawned ``--phase serve`` subprocess."""

    def __init__(
        self,
        endpoint: Endpoint,
        popen: subprocess.Popen,
        workdir: str,
        log_path: str,
    ) -> None:
        self.endpoint = endpoint
        self.popen = popen
        self.workdir = workdir
        self.log_path = log_path

    @property
    def alive(self) -> bool:
        return self.popen.poll() is None

    @property
    def returncode(self) -> Optional[int]:
        return self.popen.poll()

    def drain(self) -> None:
        """SIGTERM: the replica runs its drain-to-completion sequence
        (readiness flips, admitted work finishes, listener closes)."""
        if self.alive:
            self.popen.send_signal(signal.SIGTERM)

    def kill(self) -> None:
        """SIGKILL — the chaos path: no drain, sockets die mid-flight."""
        if self.alive:
            self.popen.kill()

    def wait(self, timeout_s: float = 60.0) -> Optional[int]:
        try:
            return self.popen.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            return None


class LocalFleet:
    """Spawn and own N serve replicas of one Config on one machine.

    Each replica gets its own save-adjacent workdir (summary + telemetry
    under ``<root>/replica_<i>/``) and a config JSON recording exactly
    what it ran — the same auditability contract as ``--config`` runs.
    Params load through the shared ``save_dir`` lineage, so every
    replica serves the same LAST_GOOD step."""

    def __init__(
        self,
        config: Config,
        count: int,
        root: str,
        host: str = "127.0.0.1",
        base_port: Optional[int] = None,
        env: Optional[Dict[str, str]] = None,
        tiers: Optional[List[str]] = None,
    ) -> None:
        self.config = config
        self.root = root
        self.host = host
        self.env = env
        # per-index tier assignment for a disaggregated fleet; a
        # respawned replica keeps its index and therefore its tier
        if tiers is not None and len(tiers) != count:
            raise ValueError(
                f"tiers names {len(tiers)} replicas, fleet has {count}"
            )
        self.tiers: List[str] = list(tiers) if tiers else ["both"] * count
        for tier in self.tiers:
            if tier not in TIERS:
                raise ValueError(f"tier {tier!r}: must be one of {TIERS}")
        self.replicas: List[ReplicaProcess] = []
        os.makedirs(root, exist_ok=True)
        ports = (
            [base_port + i for i in range(count)]
            if base_port
            else [free_port(host) for _ in range(count)]
        )
        for i, port in enumerate(ports):
            self.replicas.append(self._spawn(i, port))

    @property
    def endpoints(self) -> List[Endpoint]:
        return [r.endpoint for r in self.replicas]

    def by_name(self, name: str) -> Optional[ReplicaProcess]:
        for r in self.replicas:
            if r.endpoint.name == name:
                return r
        return None

    @staticmethod
    def replica_argv(root: str, index: int) -> List[str]:
        """The command replica ``index`` of a fleet under ``root`` runs:
        the port's CLI on the config its spawn saved.  A replica started
        by hand from this command is the one the fleet would respawn."""
        return [
            sys.executable, "-m", "sat_tpu_torch.cli",
            "--config", os.path.join(root, f"replica_{index}", "serve_config.json"),
        ]

    def _spawn(self, index: int, port: int) -> ReplicaProcess:
        workdir = os.path.join(self.root, f"replica_{index}")
        os.makedirs(workdir, exist_ok=True)
        tier = self.tiers[index]
        cfg = self.config.replace(
            phase="serve",
            serve_host=self.host,
            serve_port=port,
            serve_tier=tier,
            summary_dir=os.path.join(workdir, "summary"),
            telemetry_dir=os.path.join(workdir, "telemetry"),
        )
        cfg_path = os.path.join(workdir, "serve_config.json")
        cfg.save(cfg_path)
        log_path = os.path.join(workdir, "serve.log")
        log = open(log_path, "ab")
        try:
            popen = subprocess.Popen(
                self.replica_argv(self.root, index),
                stdout=log,
                stderr=subprocess.STDOUT,
                env=(
                    {**os.environ, **self.env}
                    if self.env is not None
                    else None
                ),
            )
        finally:
            log.close()  # the child holds its own descriptor
        return ReplicaProcess(
            Endpoint(f"r{index}", self.host, port, tier=tier),
            popen,
            workdir,
            log_path,
        )

    def respawn(self, name: str) -> ReplicaProcess:
        """Relaunch a drained/dead replica on its old port (the deploy
        runbook's 'bring it back' step)."""
        for i, r in enumerate(self.replicas):
            if r.endpoint.name == name:
                if r.alive:
                    raise RuntimeError(f"replica {name} is still running")
                self.replicas[i] = self._spawn(i, r.endpoint.port)
                return self.replicas[i]
        raise KeyError(name)

    def wait_ready(self, timeout_s: float = 300.0) -> None:
        """Block until every replica's /healthz answers 200, or raise
        with the dead replica's log tail — a fleet that half-boots must
        fail loudly, not route around its own deploy."""
        deadline = time.time() + timeout_s
        pending = list(self.replicas)
        while pending:
            for r in list(pending):
                if not r.alive:
                    raise RuntimeError(
                        f"replica {r.endpoint.name} exited rc="
                        f"{r.returncode} during boot\n{self._log_tail(r)}"
                    )
                h = probe_health(r.endpoint)
                if h and h.get("_status_code") == 200 and h.get("ready"):
                    pending.remove(r)
            if pending and time.time() > deadline:
                names = ", ".join(r.endpoint.name for r in pending)
                raise TimeoutError(
                    f"replicas not ready after {timeout_s:.0f}s: {names}\n"
                    + "\n".join(self._log_tail(r) for r in pending)
                )
            if pending:
                time.sleep(0.25)

    @staticmethod
    def _log_tail(r: ReplicaProcess, lines: int = 15) -> str:
        try:
            with open(r.log_path, errors="replace") as f:
                tail = f.readlines()[-lines:]
            return f"--- {r.endpoint.name} log tail ---\n" + "".join(tail)
        except OSError:
            return f"--- {r.endpoint.name} log unreadable ---"

    def stop_all(self, timeout_s: float = 60.0) -> None:
        """Drain every replica (SIGTERM), escalate to SIGKILL on the
        stragglers past the timeout."""
        for r in self.replicas:
            r.drain()
        deadline = time.time() + timeout_s
        for r in self.replicas:
            remaining = max(0.5, deadline - time.time())
            if r.wait(remaining) is None:
                r.kill()
                r.wait(10.0)
