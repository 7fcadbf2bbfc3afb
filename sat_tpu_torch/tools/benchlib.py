"""What the measurement vehicles (``tools/bench_*.py``) share: the device a
vehicle measures, the card's description that rides every row, the
stderr log line, a child's environment and ``--extra-set``.
Import-light: torch comes in only inside the functions that touch a
device."""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Dict, List

_T0 = time.perf_counter()


def make_log(name: str):
    """``log(msg)``: one ``[name +Ns] msg`` line on stderr."""

    def log(msg: str) -> None:
        print(f"[{name} +{time.perf_counter() - _T0:6.1f}s] {msg}", file=sys.stderr, flush=True)

    return log


def bench_device(cpu: bool = False):
    """The device a vehicle measures: the card, unless the caller asks for
    the CPU (``cpu``, or ``SAT_TORCH_DEVICE=cpu``).  With no card and no
    such request the vehicle exits 1 with the reason; it never measures
    the CPU in the card's place."""
    from ..device import resolve_device

    try:
        return resolve_device("cpu" if cpu else None)
    except RuntimeError as e:
        raise SystemExit(f"{e} (or SAT_TORCH_DEVICE=cpu); nothing was measured") from None
    except ValueError as e:
        raise SystemExit(str(e)) from None


def parent_device(cpu: bool = False):
    """:func:`bench_device` for a vehicle whose children do the measuring:
    the same request and refusal, without creating a CUDA context in this
    process (only ``torch.cuda.is_available``), so the children find the
    card as a fresh process would."""
    import torch

    from ..device import DEVICE_ENV

    want = "cpu" if cpu else os.environ.get(DEVICE_ENV) or "cuda"
    if want not in ("cuda", "cpu"):
        raise SystemExit(f"sat_tpu_torch: {DEVICE_ENV}={want!r}: expected 'cuda' or 'cpu'")
    if want == "cuda" and not torch.cuda.is_available():
        raise SystemExit("sat_tpu_torch: no CUDA device is visible; pass --cpu or set "
                         "SAT_TORCH_DEVICE=cpu to run on the CPU; nothing was measured")
    return torch.device("cuda", 0) if want == "cuda" else torch.device("cpu")


def device_kind(dev) -> str:
    """A row's ``device_kind``: the card as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints it ("NVIDIA H100 80GB
    HBM3, 700.00 W"; read without touching the card, so a parent whose
    children measure creates no CUDA context); "cpu" on the CPU."""
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        rows = out.stdout.strip().splitlines() if out.returncode == 0 else []
    except (OSError, subprocess.SubprocessError):
        rows = []
    index = dev.index or 0
    return rows[index].strip() if index < len(rows) else "a CUDA card (nvidia-smi did not answer)"


def child_env(**extra: str) -> Dict[str, str]:
    """The environment of a child process a vehicle starts: the repo on
    its path, the JAX variables and inherited fault knobs dropped; the
    device request (``SAT_TORCH_DEVICE``) passes through."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_", "SAT_FI_"))}
    env["PYTHONPATH"] = repo + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env.update(extra)
    return env


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_sets(config, items: List[str]):
    """``config`` with ``KEY=VALUE`` overrides (``--extra-set``), each value
    parsed as the CLI's ``--set`` parses it."""
    if not items:
        return config
    from ..cli import _parse_override

    return config.replace(**{
        key: _parse_override(config, key, raw) for key, _, raw in (item.partition("=") for item in items)
    })
