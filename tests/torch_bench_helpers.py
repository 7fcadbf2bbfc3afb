"""Shared set-up of the tests that hold the port's measurement vehicles
(``sat_tpu_torch/tools/bench_*.py``) against the JAX scripts: the small
model's widths, the metric/unit pairs a JAX script prints (read from its
source), and a vehicle run in its own interpreter on the CPU."""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_runtime.py's small model, float32 (the vehicles' --extra-set)
SMALL = ["image_size=32", "dim_embedding=16", "num_lstm_units=16", "dim_initialize_layer=16",
         "dim_attend_layer=16", "dim_decode_layer=32", "compute_dtype=float32"]


def extra(sets):
    return [x for s in sets for x in ("--extra-set", s)]


def jax_pairs(script: str, **fields):
    """The (metric, unit) pairs ``scripts/<script>`` prints, in source
    order, with ``{args.<field>}`` of an f-string filled from ``fields``."""
    with open(os.path.join(REPO, "scripts", script)) as f:
        src = f.read()
    found = re.findall(
        r'"metric": (f?)"([^"]+)",(?:(?!"metric").)*?"unit": (f?)"([^"]+)"', src, re.DOTALL)

    def fill(text):
        return re.sub(r"\{args\.(\w+)\}", lambda m: str(fields[m.group(1)]), text)

    return [(fill(m), fill(u)) for _, m, _, u in found]


def rows(stdout: str):
    """The JSON rows of a vehicle's stdout: one object a line, or one
    indented array."""
    text = stdout.strip()
    if text.startswith("["):
        return json.loads(text)
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def captured(main, argv):
    """(exit code, stdout, stderr) of ``main(argv)`` in this process; a
    SystemExit's code (argparse's 2) or message (exit 1) comes back too."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else 1
            if isinstance(e.code, str):
                print(e.code, file=err)
    return rc, out.getvalue(), err.getvalue()


def run_tool(name: str, argv, env=None, timeout: int = 400):
    """``python -m sat_tpu_torch.tools.<name> argv`` on the CPU
    (``SAT_TORCH_DEVICE=cpu``, torch on 2 threads)."""
    full = {k: v for k, v in os.environ.items() if not k.startswith(("SAT_", "JAX_", "XLA_"))}
    full.update(PYTHONPATH=REPO, SAT_TORCH_DEVICE="cpu", OMP_NUM_THREADS="2", CUDA_VISIBLE_DEVICES="")
    full.update(env or {})
    return subprocess.run([sys.executable, "-m", f"sat_tpu_torch.tools.{name}", *argv], capture_output=True,
                          text=True, cwd=REPO, env=full, timeout=timeout)


def finite(row) -> bool:
    return isinstance(row["value"], (int, float)) and not isinstance(row["value"], bool) \
        and math.isfinite(row["value"])
