"""The harness's core: finding a cell's files by name, the device record,
the import check and the result line.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``.  Its
configuration is the file that ``configs`` names; its traffic is
``capbench/traffic/<traffic>.json``, whose ``driver`` names the module
``capbench/drivers/<driver>.py`` that runs it; its correctness limits are
in ``capbench/workloads/<cell>.json``; each per-layer metric is read by
``capbench/metrics/<metric>.py``.  Adding a cell, a mix or a metric adds
files and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "sat_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]       # the configuration file
    traffic: Dict[str, Any]      # the traffic mix's parameters
    limits: Dict[str, float]     # the correctness limits of this cell
    entry: Dict[str, Any]        # the cell's entry in BENCHMARK.json
    bench: Dict[str, Any]        # the whole BENCHMARK.json


def _json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_benchmark() -> Dict[str, Any]:
    return _json(ROOT / "BENCHMARK.json")


def load_cell(name: str, bench: Optional[Dict[str, Any]] = None) -> Cell:
    bench = bench or load_benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"capbench: no workload {name!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(
        name=name,
        chips=int(entry["chips"]),
        config=_json(ROOT / config["file"]),
        traffic=_json(HERE / "traffic" / f"{entry['traffic']}.json"),
        limits=_json(HERE / "workloads" / f"{name}.json")["limits"],
        entry=entry,
        bench=bench,
    )


def driver(cell: Cell):
    return importlib.import_module(f"capbench.drivers.{cell.traffic['driver']}")


def metric_reader(name: str) -> Callable[[Dict[str, Any]], Optional[float]]:
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"capbench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def end_to_end_names(cell: Cell) -> List[str]:
    return [m["name"] for m in cell.bench["end_to_end"]
            if cell.name in m.get("workloads", [cell.name])]


def per_layer_names(cell: Cell) -> List[str]:
    """The per-layer metrics a traced run of ``cell`` reads: those that list
    it, and those with no list whose end-to-end metric it reports."""
    e2e = set(end_to_end_names(cell))
    return [m["name"] for m in cell.bench["per_layer"]
            if (cell.name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def units(bench: Dict[str, Any]) -> Dict[str, str]:
    return {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}


def program_config(cfg: Dict[str, Any], **overrides):
    """The program's ``Config`` from the configuration file's keys that are
    its fields."""
    from sat_tpu_torch.config import Config

    fields = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in {**cfg, **overrides}.items() if k in fields})


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True,
        ).stdout.strip()
        return float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def device_record(count: int, memory_peak_bytes: int) -> Dict[str, Any]:
    import torch

    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": count,
        "memory_peak_bytes": int(memory_peak_bytes),
        "power_limit_w": power_limit_w(),
    }


def forbidden_loaded() -> List[str]:
    """Loaded modules whose top-level name is one the benchmark may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def checks_ok(checks: Dict[str, Dict[str, float]]) -> bool:
    """Every compared number a finite reading within its limit."""
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())


def report_checks(checks: Dict[str, Dict[str, float]]) -> None:
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict[str, float],
                unit_of: Dict[str, str], device: Dict[str, Any], checks: Dict[str, Dict[str, float]],
                breakdown: Optional[Dict[str, Any]] = None) -> str:
    out: Dict[str, Any] = {
        "correct": bool(correct),
        "attempted": int(attempted),
        "failed": int(failed),
        "metrics": {k: {"value": v, "unit": unit_of[k]} for k, v in metrics.items()},
        "device": device,
    }
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def cache_dirs() -> None:
    """Build and kernel caches in fixed folders of the checkout: the
    program's nvcc builds go to ``sat_tpu_torch/_build`` by its own rule;
    Triton's, should any path use it, to ``capbench/.cache/triton``."""
    os.environ["TRITON_CACHE_DIR"] = str(HERE / ".cache" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(HERE / ".cache" / "torch_extensions")
    os.environ.setdefault("USE_FLAX", "0")
