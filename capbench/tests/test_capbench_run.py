"""The command's behaviour around a run: no card, a bare checkout, the
import check, the trace's reduction and the per-layer readers."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from capbench import bench, trace
from conftest import ROOT

CELLS = [w["name"] for w in bench.load_benchmark()["workloads"]]


def _command(cell, seconds=1, trace_flag=0, seed=2 ** 31 + 17):
    return bench.load_benchmark()["command"] + ["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                                                "--trace", str(trace_flag)]


def test_a_run_without_a_card_exits_nonzero_and_prints_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run(_command(CELLS[0]), cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "{" not in out.stdout and "correct" not in out.stdout
    assert "CUDA card" in out.stderr


def test_a_bare_checkout_cannot_run_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "capbench"), tmp_path / "capbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    code = textwrap.dedent(f"""
        import time, torch
        from capbench import bench
        cell = bench.load_cell({CELLS[0]!r})
        bench.driver(cell).run(cell, 1, 0.1, False, torch.device("cpu"), time.perf_counter())
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and "sat_tpu_torch" in out.stderr
    assert "{" not in out.stdout


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_loads_neither_jax_nor_the_jax_package(cell):
    code = textwrap.dedent(f"""
        import sys, time, torch
        sys.path.insert(0, {os.path.join(ROOT, "capbench", "tests")!r})
        from conftest import tiny_cell
        from capbench import bench
        import capbench.run, capbench.readings
        torch.set_num_threads(2)
        cell = tiny_cell({cell!r})
        bench.driver(cell).run(cell, 3, 0.2, False, torch.device("cpu"), time.perf_counter())
        print(bench.forbidden_loaded())
        print(sorted(m for m in sys.modules if m.split(".")[0] == "sat_tpu_torch")[:1])
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-2] == "[]" and lines[-1] == "['sat_tpu_torch']"


def test_the_import_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "sat_tpu_torch_like", sys)
    assert "sat_tpu" not in bench.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "sat_tpu.models", sys)
    assert "sat_tpu" in bench.forbidden_loaded()


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_the_trace_reduces_to_busy_time_kernels_and_idle_gaps_by_host_op():
    events = [
        _x(trace.SEGMENT, "user_annotation", 0.0, 100.0),
        _x("k1", "kernel", 10.0, 20.0), _x("k2", "kernel", 25.0, 10.0), _x("k1", "kernel", 60.0, 10.0),
        _x("Memcpy HtoD", "gpu_memcpy", 90.0, 20.0),  # runs past the segment: clipped
        _x("aten::topk", "cpu_op", 35.0, 30.0), _x("cudaStreamSynchronize", "cuda_runtime", 40.0, 5.0),
    ]
    out = trace.reduce(events)
    assert out["window_s"] == pytest.approx(100e-6)
    assert out["busy_s"] == pytest.approx((25 + 10 + 10) * 1e-6)
    assert out["launches"] == 3 and out["kernels"]["k1"] == [2, pytest.approx(30e-6)]
    assert out["idle"]["python"] == pytest.approx(10e-6 + 20e-6)        # before k1, after k1 at 70-90
    assert out["idle"]["aten::topk"] == pytest.approx(25e-6)              # 35-60 under topk, not the sync
    assert trace.kernel_time(out, "k1") == (2, pytest.approx(30e-6))
    bd = trace.breakdown(out)
    assert bd["device_ops"][0][0] == "k1" and len(bd["idle_gaps"]) <= 10


def test_a_trace_of_the_card_alone_spans_its_activity():
    out = trace.reduce([_x("k1", "kernel", 10.0, 20.0), _x("k2", "kernel", 40.0, 10.0)])
    assert out["window_s"] == pytest.approx(40e-6) and out["busy_s"] == pytest.approx(30e-6)
    assert trace.reduce([])["busy_s"] == 0.0


def test_readers_return_nothing_where_there_is_nothing_to_read():
    empty = {"window_s": 1.0, "batches": 1, "steps": 0, "batch": 8, "config": {}, "flops": 0}
    for m in bench.load_benchmark()["per_layer"]:
        assert bench.metric_reader(m["name"])(empty) is None, m["name"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_runs_correct_on_a_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for flag in (0, 1):
        out = subprocess.run(_command(cell, seconds=2, trace_flag=flag), cwd=ROOT, capture_output=True, text=True,
                             timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"] and line["device"]["platform"] == "gpu"
        assert list(line)[-1] == "checks"
