"""The port's vehicles that run whole programs, on the CPU at the small
model's widths: ``bench_bulk`` (the ``--phase bulk`` CLI, then its
resume), ``bench_eval_ab`` (fresh and resident arms in their own
processes), ``bench_early_exit`` (a quick train, then ``bench_eval`` with
and without the exit) and ``bench_quality`` (the serve arm with the
quality plane on, then its microbench): each prints the rows of its JAX
script, with the metrics and units read from that script's source, and
exits as it does."""

import json
import os

from tests.torch_bench_helpers import SMALL, extra, finite, jax_pairs, rows, run_tool


def test_bench_bulk_rows_match_the_jax_script(tmp_path):
    proc = run_tool("bench_bulk", ["--images", "6", "--shard-rows", "3", "--workdir", str(tmp_path),
                                   *extra(SMALL)])
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = rows(proc.stdout)
    assert [(r["metric"], r["unit"]) for r in got] == jax_pairs("bench_bulk.py")
    assert all(finite(r) and r["device_kind"] == "cpu" for r in got)
    # no kernel on the CPU, and no build: the decode run compiled nothing
    assert got[0]["kernel_builds"] == 0 and got[0]["fused_attend_masked_launches"] == 0
    assert got[1]["shards_verified"] == 2
    with open(tmp_path / "tally" / "tally_rank0.json") as f:
        assert json.load(f)[0]["rc"] == 0
    assert sorted(os.listdir(tmp_path / "out"))[0].startswith("bulk_manifest")


def test_bench_eval_ab_interleaves_its_arms(tmp_path):
    out = tmp_path / "summary.json"
    proc = run_tool("bench_eval_ab", ["--cpu", "--image-size", "32", "--batch", "2", "--iters", "1",
                                      "--windows", "2", "--steps", "1", "--repeats", "2", "--out", str(out),
                                      *extra(SMALL)])
    assert proc.returncode == 0, proc.stderr[-3000:]
    (summary,) = rows(proc.stdout)
    assert [(summary["metric"], summary["unit"])] == jax_pairs("bench_eval_ab.py", beam=3)
    assert finite(summary) and summary["device_kind"] == "cpu"
    assert [(r["arm"], r["repeat"]) for r in summary["rows"]] == [
        ("fresh", 0), ("resident", 0), ("fresh", 1), ("resident", 1)]
    assert all(len(r["windows_batch_ms"]) == 2 for r in summary["rows"])
    # memory_allocated is a card's reading: none on the CPU
    assert summary["resident_memory_allocated_bytes"] == [None, None]
    with open(out) as f:
        assert json.load(f)["resident_over_fresh"] == summary["resident_over_fresh"]


def test_bench_eval_ab_reports_a_failed_arm(tmp_path):
    """A child that fails becomes the JAX script's structured error row
    and exit 3."""
    proc = run_tool("bench_eval_ab", ["--cpu", "--image-size", "32", "--batch", "2", "--repeats", "1",
                                      "--extra-set", "no_such_field=1"])
    assert proc.returncode == 3
    (err,) = rows(proc.stdout)
    assert err["error"] == "arm_failed" and err["arm"] == "fresh"


def test_bench_early_exit_runs_both_arms(tmp_path):
    env = {"EE_CPU": "1", "EE_IMAGE_SIZE": "32", "EE_STEPS": "3", "EE_BATCH": "2",
           "EE_SETS": " ".join(s for s in SMALL if not s.startswith("image_size"))}
    proc = run_tool("bench_early_exit", [str(tmp_path)], env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = rows(proc.stdout)
    assert [r["metric"] for r in got] == ["eval_images_per_sec"] * 2
    assert [r["early_exit"] for r in got] == [True, False]
    assert all(finite(r) and r["device_kind"] == "cpu" for r in got)
    # the cache keyed on every knob, the backend included
    (run_dir,) = [d for d in os.listdir(tmp_path) if d.startswith("ee_run_32px_3s_cpu_")]
    assert any(f.endswith(".npz") for f in os.listdir(tmp_path / run_dir / "models"))


def test_bench_quality_row_matches_the_jax_script(tmp_path):
    proc = run_tool("bench_quality", ["--requests", "24", "--microbench", "200", "--quality-window", "8",
                                      "--workdir", str(tmp_path), *extra(SMALL + ["beam_size=2"])])
    got = rows(proc.stdout)
    assert [(r["metric"], r["unit"]) for r in got] == jax_pairs("bench_quality.py")
    (row,) = got
    assert finite(row) and row["device_kind"] == "cpu" and row["reference_frozen"]
    assert row["steady_state_compiles"] == 0 and row["requests_ok"] == 24
    # the gate judges the raw overhead: exit 0 under 0.5%, 1 over
    assert proc.returncode == (0 if row["raw_overhead_pct"] <= 0.5 else 1), proc.stderr[-2000:]
