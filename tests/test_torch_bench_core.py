"""The port's measurement core and its kernel and eval vehicles on the CPU:
``utils.benchmarking.make_chained_decode`` held against sat_tpu's on the
same weights and images; ``tools.check_regression`` against
``scripts/check_regression.py`` on the same artifacts (exit codes and the
metrics each names); ``tools.bench_eval``, ``tools.bench_attend`` and
``tools.bench_diag`` printing the JAX scripts' rows; and every vehicle
that measures a device refusing to run without a card unless asked for
the CPU."""

import importlib
import importlib.util
import json
import math
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sat_tpu.utils.benchmarking import make_chained_decode as jax_chained_decode
from sat_tpu_torch.train.checkpoint import compute_params
from sat_tpu_torch.utils.benchmarking import make_chained_decode, time_decode_windows
from tests.torch_bench_helpers import REPO, SMALL, captured, extra, finite, jax_pairs, rows
from tests.torch_port_helpers import configs, port_params, to_torch

torch.set_num_threads(2)



def jax_source(name: str) -> str:
    with open(os.path.join(REPO, "scripts", name)) as f:
        return f.read()


def jax_script(name: str):
    """``scripts/<name>.py`` as a module (its top level imports no jax)."""
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# -- the shared decode core --------------------------------------------------------


@pytest.mark.parametrize("early_exit,valid_size", [(True, None), (False, None), (True, 40)],
                         ids=["early_exit", "full_length", "valid_size"])
def test_chained_decode_matches_jax(early_exit, valid_size):
    """The same seed-made weights (through the npz bridge) and numpy
    images in float32: words identical, log_scores within 1e-5, and the
    chained images equal to ``images + 1e-30 * sum(log_scores)`` within
    1e-6 in both packages."""
    jc, tc = configs(beam_size=3)
    variables, params = port_params(jc, tc, seed=3)
    images = np.random.default_rng(3).normal(size=(3, tc.image_size, tc.image_size, 3)).astype(np.float32)
    want, want_images = jax_chained_decode(jc, eos=1, beam_size=3, valid_size=valid_size,
                                           early_exit=early_exit)(variables, jnp.asarray(images))
    got, got_images = make_chained_decode(tc, eos=1, beam_size=3, valid_size=valid_size,
                                          early_exit=early_exit)(compute_params(params, tc), to_torch(images))
    np.testing.assert_array_equal(got.words.numpy(), np.asarray(want.words))
    np.testing.assert_allclose(got.log_scores.numpy(), np.asarray(want.log_scores), rtol=0, atol=1e-5)
    for chained, scores in ((got_images.numpy(), got.log_scores.numpy()),
                            (np.asarray(want_images), np.asarray(want.log_scores))):
        np.testing.assert_allclose(chained, images + np.float32(1e-30) * scores.sum(), rtol=0, atol=1e-6)
    if valid_size is not None:
        assert int(got.words.max()) < valid_size


def test_time_decode_windows_chains_the_windows():
    """``windows`` timed windows, each a positive mean batch time, and the
    final images the input's chain through every call."""
    jc, tc = configs(beam_size=2)
    _, params = port_params(jc, tc)
    images = to_torch(np.random.default_rng(0).normal(size=(2, tc.image_size, tc.image_size, 3)).astype(np.float32))
    calls = []
    decode = make_chained_decode(tc, eos=1, beam_size=2)

    def counted(p, x):
        calls.append(x)
        return decode(p, x)

    compile_s, windows_ms, final = time_decode_windows(counted, compute_params(params, tc), images, iters=2, windows=3)
    assert compile_s > 0 and len(windows_ms) == 3 and all(ms > 0 for ms in windows_ms)
    assert len(calls) == 1 + 3 * 2
    # each call consumed the previous call's output
    assert calls[0] is images and all(a is not b for a, b in zip(calls, calls[1:]))
    np.testing.assert_allclose(final.numpy(), images.numpy(), rtol=0, atol=1e-6)


# -- the regression gate ------------------------------------------------------------


def _row(metric, value, **kw):
    return {"metric": metric, "value": value, "unit": "x", "vs_baseline": None, **kw}


def _report(flops, temp):
    return {"schema_version": 1, "functions": {
        "decode/beam_search": {"compile_seconds": 1.5, "cost": {"flops": flops, "transcendentals": None},
                               "memory": {"temp_bytes": temp, "argument_bytes": 100, "output_bytes": 10}},
        "decode/encode": {"compile_seconds": 0.5, "cost": {"flops": 2e9}, "memory": None},
    }}


def _write(path, obj, jsonl=False):
    with open(path, "w") as f:
        if jsonl:
            f.write("\n".join(json.dumps(r) for r in obj) + "\n")
        else:
            json.dump(obj, f)
    return str(path)


def _case(name, tmp):
    """The argument list of one case over artifacts written under ``tmp``."""
    prior = _write(tmp / "prior.jsonl", [_row("eval_images_per_sec", 100.0, step_time_ms=10.0),
                                         _row("serve_open_loop_p99_latency_ms", 50.0)], jsonl=True)
    if name == "no_regression":
        cur = _write(tmp / "cur.jsonl", [_row("eval_images_per_sec", 98.0, step_time_ms=10.2),
                                         _row("serve_open_loop_p99_latency_ms", 51.0)], jsonl=True)
        return [prior, cur]
    if name == "regression":
        cur = _write(tmp / "cur.json", [_row("eval_images_per_sec", 50.0, step_time_ms=10.0),
                                        _row("serve_open_loop_p99_latency_ms", 90.0)])
        return ["--baseline", prior, "--current", cur]
    if name == "schema_mismatch":
        cur = _write(tmp / "cur.json", [_row("eval_images_per_sec", 100.0, schema_version=99)])
        return [prior, cur]
    if name == "infra_skip":
        cur = _write(tmp / "cur.json", {"n": 1, "cmd": "bench", "rc": 3, "tail": "",
                                        "parsed": [{"metric": "eval_images_per_sec", "value": None,
                                                    "error": "device_unreachable"}]})
        return [prior, cur]
    if name == "usage_error":
        return ["--baseline", prior]
    if name == "missing_file":
        return [prior, str(tmp / "absent.json")]
    base = _write(tmp / "base_report.json", _report(1e9, 1000))
    if name == "compile_report_ok":
        return ["--compile-baseline", base, "--compile-current", _write(tmp / "cur_report.json", _report(1e9, 1010))]
    assert name == "compile_report_regression"
    return ["--compile-baseline", base, "--compile-current", _write(tmp / "cur_report.json", _report(1.5e9, 5000))]


CASES = {"no_regression": 0, "regression": 2, "schema_mismatch": 3, "infra_skip": 3, "usage_error": 2,
         "missing_file": 1, "compile_report_ok": 0, "compile_report_regression": 2}


def _named(stdout: str):
    """The gate's verdict lines: (function or row tag, metric, verdict)."""
    return sorted(re.findall(r"^(\[[^\]]+\] )?(\w+)\s+best-prior .*: (REGRESSION|ok)$", stdout, re.MULTILINE))


@pytest.mark.parametrize("case", sorted(CASES))
def test_check_regression_matches_the_jax_script(case, tmp_path):
    """The same artifacts through ``scripts/check_regression.py`` and the
    port's tool: the same exit code and the same metrics named, each with
    the same verdict."""
    from sat_tpu_torch.tools import check_regression

    argv = _case(case, tmp_path)
    want = captured(jax_script("check_regression").main, argv)
    got = captured(check_regression.main, argv)
    assert got[0] == want[0] == CASES[case], (got, want)
    assert _named(got[1]) == _named(want[1])
    if CASES[case] == 2 and case != "usage_error":
        assert any(v == "REGRESSION" for _, _, v in _named(got[1]))
    if case == "compile_report_regression":
        assert ("[decode/beam_search] ", "flops", "REGRESSION") in _named(got[1])


# -- device vehicles: rows and refusal ---------------------------------------------

DEVICE_VEHICLES = {
    "bench_eval": [],
    "bench_attend": [],
    "bench_serve": [],
    "bench_bulk": [],
    "bench_eval_ab": [],
    "bench_diag": [],
    "bench_quality": [],
    "bench_early_exit": ["{tmp}/ee"],
}


@pytest.mark.parametrize("name", sorted(DEVICE_VEHICLES))
def test_vehicles_refuse_without_a_card(name, tmp_path, monkeypatch):
    """Without a card and without ``--cpu`` or ``SAT_TORCH_DEVICE=cpu`` a
    vehicle that measures a device exits non-zero with the reason and
    writes nothing: it never measures the CPU in the card's place."""
    module = importlib.import_module(f"sat_tpu_torch.tools.{name}")
    monkeypatch.delenv("SAT_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = captured(module.main, [a.format(tmp=tmp_path) for a in DEVICE_VEHICLES[name]])
    assert rc != 0 and rows(out) == []
    assert "no CUDA device is visible" in err and "SAT_TORCH_DEVICE=cpu" in err
    assert sorted(os.listdir(tmp_path)) == []


def test_bench_eval_rows_are_the_jax_scripts(tmp_path):
    """``--cpu`` at the small widths with the quantized arm: the JAX
    script's two rows (``eval_images_per_sec`` and ``..._int8``), their
    unit, finite values, the CPU named, no kernel launched there."""
    from sat_tpu_torch.tools import bench_eval

    src = jax_source("bench_eval.py")
    rc, out, _ = captured(bench_eval.main, ["--cpu", "--image-size", "32", "--batch", "2", "--iters", "2",
                                            "--encoder-quant", "int8", *extra(SMALL)])
    got = rows(out)
    assert rc == 0 and [r["metric"] for r in got] == ["eval_images_per_sec", "eval_images_per_sec_int8"]
    # the JAX rows share one unit through ``common``
    assert '"metric": "eval_images_per_sec"' in src and '"metric": f"eval_images_per_sec_{args.encoder_quant}"' in src
    assert '"unit": f"images/sec @ beam={args.beam}"' in src
    for r in got:
        assert r["unit"] == "images/sec @ beam=3" and finite(r) and r["device_kind"] == "cpu"
        assert r["fused_attend_launches"] == 0 and r["schema_version"] == 1


def test_bench_eval_params_guard_and_early_exit_flag(tmp_path):
    """``--params`` without ``--vocab`` is a usage error (2); a checkpoint
    of another width covers too few leaves (2); ``--no-early-exit`` rides
    the row."""
    from sat_tpu_torch.tools import bench_eval
    from sat_tpu_torch.config import Config
    from sat_tpu_torch.models.captioner import init_variables
    from sat_tpu_torch.train.checkpoint import params_to_flat

    assert captured(bench_eval.main, ["--cpu", "--params", "x.npz"])[0] == 2
    cfg = Config(image_size=32, dim_embedding=8)
    np.savez(tmp_path / "other.npz", **params_to_flat(init_variables(cfg, torch.Generator().manual_seed(0))[0]))
    with open(tmp_path / "vocab.csv", "w") as f:
        f.write("word,frequency\n.,0.5\na,0.5\n")
    rc, _, err = captured(bench_eval.main, ["--cpu", "--image-size", "32", "--batch", "1", "--iters", "1",
                                            "--params", str(tmp_path / "other.npz"), "--vocab", str(tmp_path / "vocab.csv"),
                                            *extra(SMALL)])
    assert rc == 2 and "param leaves" in err
    rc, out, _ = captured(bench_eval.main, ["--cpu", "--image-size", "32", "--batch", "1", "--iters", "1",
                                            "--no-early-exit", *extra(SMALL)])
    assert rc == 0 and rows(out)[0]["early_exit"] is False


def test_bench_attend_sweep_and_block_b(tmp_path):
    """``--cpu`` is the plumbing smoke over the plain version: the JAX
    script's line (``sweep`` and ``min_speedup``) with the masked rows,
    labelled a smoke, no verdict; ``--block-b`` has no counterpart and
    exits 2."""
    from sat_tpu_torch.tools import bench_attend

    assert '{"sweep": rows, "min_speedup": min_speedup' in jax_source("bench_pallas.py")
    rc, out, _ = captured(bench_attend.main, ["--cpu", "--batch", "2", "--iters", "1"])
    line = rows(out)[-1]
    assert rc == 0 and "smoke complete" in out and "verdict:" not in out
    assert [r["batch"] for r in line["sweep"]] == [2] and math.isfinite(line["min_speedup"])
    assert [r["live"] for r in line["masked"]] == [48, 24, 3] and "smoke" in line
    assert line["device_kind"] == "cpu" and line["sweep"][0]["err_ctx_kernel"] < 1e-4
    rc, out, err = captured(bench_attend.main, ["--cpu", "--block-b", "8"])
    assert rc == 2 and "--block-b" in err and rows(out) == []


def test_bench_diag_row_is_the_jax_scripts(monkeypatch):
    """The JAX script's one row (``diag_tap_overhead`` in ``%_of_step``),
    its three per-step times, on the CPU (``SAT_TORCH_DEVICE=cpu``) at a
    tiny size."""
    from sat_tpu_torch.tools import bench_diag

    monkeypatch.setenv("SAT_TORCH_DEVICE", "cpu")
    rc, out, _ = captured(bench_diag.main, ["--batch", "2", "--iters", "2", "--rounds", "2"])
    (row,) = rows(out)
    assert [(row["metric"], row["unit"])] == jax_pairs("bench_diag.py") and finite(row)
    assert rc == (0 if row["value"] < 1.0 else 1)
    assert all(row[f"{k}_ms_per_step"] > 0 for k in ("off", "basic", "full")) and row["device_kind"] == "cpu"
