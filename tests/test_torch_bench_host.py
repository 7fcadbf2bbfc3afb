"""The port's host-only measurement vehicles held against the JAX scripts
on the CPU: ``bench_telemetry``, ``bench_obs``, ``bench_fleet``,
``bench_watchdog``, ``bench_integrity``, ``bench_ckpt`` and
``bench_input``, each run beside ``scripts/<name>.py`` at the same small
flags, print the same metrics in the same order with the same units and
every key of the JAX rows, touch no device and load no torch."""

import json
import math
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FLAGS = {
    "bench_telemetry": ["--iters", "2000", "--log-every", "10"],
    "bench_obs": ["--iters", "200"],
    "bench_fleet": ["--iters", "20", "--hosts", "4"],
    "bench_watchdog": ["--iters", "5000"],
    "bench_integrity": ["--iters", "64", "--files", "16"],
    "bench_ckpt": ["--mb", "2", "--iters", "500"],
    "bench_input": ["--batch", "4", "--images", "8", "--image-size", "32", "--src-size", "64",
                    "--sync-batches", "2", "--epochs", "1", "--device-ms", "5"],
}


def _rows(stdout: str):
    """The JSON rows of a vehicle's stdout: one object a line, or one
    indented array."""
    text = stdout.strip()
    if text.startswith("["):
        return json.loads(text)
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def _run(cmd, tmp):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("SAT_", "XLA_"))}
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    return subprocess.run(cmd, capture_output=True, text=True, cwd=REPO, env=env, timeout=240)


@pytest.mark.parametrize("name", sorted(FLAGS))
def test_host_vehicle_rows_match_the_jax_script(name, tmp_path):
    want = _run([sys.executable, os.path.join("scripts", f"{name}.py"), *FLAGS[name],
                 "--workdir", str(tmp_path / "jax")], tmp_path)
    # the tool, then what its import and run loaded
    code = (
        "import sys, runpy\n"
        f"sys.argv = ['{name}'] + {FLAGS[name] + ['--workdir', str(tmp_path / 'port')]!r}\n"
        "try:\n"
        f"    runpy.run_module('sat_tpu_torch.tools.{name}', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('torch', 'jax', 'jaxlib', 'sat_tpu'))\n"
        "print('LOADED', bad, file=sys.stderr)\n"
        "sys.exit(rc)\n"
    )
    got = _run([sys.executable, "-c", code], tmp_path)
    assert want.returncode in (0, 1), want.stderr[-2000:]
    assert got.returncode in (0, 1), got.stderr[-2000:]
    want_rows, got_rows = _rows(want.stdout), _rows(got.stdout)
    assert [(r["metric"], r["unit"]) for r in got_rows] == [(r["metric"], r["unit"]) for r in want_rows]
    for w, g in zip(want_rows, got_rows):
        assert set(w) - set(g) == set(), f"{g['metric']}: keys of the JAX row missing"
        assert isinstance(g["value"], (int, float)) and math.isfinite(g["value"])
        assert g["device_kind"] == "host-only" and g["schema_version"] == 1
        assert "kind" not in g["device"]  # the stamp names no card: none was touched
    assert "LOADED []" in got.stderr
