"""The port's observability in train, eval, test and bulk held against
sat_tpu's on the fixture dataset, both packages with telemetry, the
flight recorder, ``diag_level=full`` and a train SLO on: the same
artifact names (the port's decode also writes a heartbeat) and the same
JSON key sets of ``heartbeat.json``, ``breakdown*.json``,
``telemetry.jsonl``, ``compile_report*.json`` and ``slo.jsonl``; the same
span names in ``trace*.json``; the same postmortem bundle after an
injected preemption; no artifact with telemetry off; the breakdown
within 5% of wall; JAX's ``test_profiler_window_*`` cases on the port's
window with a fake profiler; ``MetricsListener`` serving ``/metrics``
during a run and ``SIGUSR2`` opening a profiler window; bulk with the
flight recorder bitwise bulk without it."""

import glob
import json
import os
import shutil
import signal
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

from sat_tpu import cli as jax_cli
from sat_tpu import runtime as jrt
from sat_tpu import telemetry as jax_telemetry
from sat_tpu.bulk.runner import run_bulk as jax_run_bulk
from sat_tpu.telemetry import blackbox as jax_blackbox
from sat_tpu_torch import cli, runtime, telemetry
from sat_tpu_torch.bulk import runner
from sat_tpu_torch.config import Config
from sat_tpu_torch.telemetry import blackbox, promtext
from tests.torch_port_helpers import configs

torch.set_num_threads(2)

SMALL = dict(
    image_size=32, dim_embedding=16, num_lstm_units=16, dim_initialize_layer=16,
    dim_attend_layer=16, dim_decode_layer=32, compute_dtype="float32", save_period=3,
    log_every=2, num_epochs=1, num_data_workers=2, max_caption_length=20, vocabulary_size=200,
)
# every knob the slice turns on: spans, recorder, taps, a train SLO that
# burns at once (so slo.jsonl has a transition row)
OBSERVED = dict(
    telemetry=True, blackbox=True, diag_level="full", heartbeat_interval=0.05,
    slo_captions_per_s=1e9, slo_window_fast_s=0.2, slo_window_slow_s=0.4,
)


def _settings(coco_fixture, root, pkg, **kw):
    c = coco_fixture["config"]
    return dict(
        SMALL, **OBSERVED,
        train_caption_file=c.train_caption_file, train_image_dir=c.train_image_dir,
        eval_image_dir=c.eval_image_dir, eval_caption_file=c.eval_caption_file,
        test_image_dir=c.test_image_dir, max_eval_ann_num=9, batch_size=4,
        vocabulary_file=os.path.join(root, "vocabulary.csv"),
        temp_annotation_file=os.path.join(root, pkg, "anns.csv"),
        temp_data_file=os.path.join(root, pkg, "data.npy"),
        save_dir=os.path.join(root, pkg, "models"), summary_dir=os.path.join(root, pkg, "summary"),
        eval_result_dir=os.path.join(root, pkg, "eval"),
        eval_result_file=os.path.join(root, pkg, "results.json"),
        test_result_dir=os.path.join(root, pkg, "test"),
        test_result_file=os.path.join(root, pkg, "results.csv"),
        quarantine_ledger=os.path.join(root, pkg, "quarantine.jsonl"), **kw,
    )


def _tdir(config, phase):
    return config.replace(telemetry_dir=os.path.join(os.path.dirname(config.save_dir), "tel", phase))


def _disable_all():
    jax_telemetry.disable()
    jax_blackbox.uninstall()
    telemetry.disable()
    blackbox.uninstall()


@pytest.fixture(scope="module")
def runs(coco_fixture, tmp_path_factory):
    """Each package's train, eval, test and bulk with everything on, each
    phase into its own telemetry dir; returns {pkg: {phase: config}}."""
    root = str(tmp_path_factory.mktemp("torch_obs"))
    out = {}
    for pkg in ("jax", "port"):
        jc, tc = configs(**_settings(coco_fixture, root, pkg))
        c = jc if pkg == "jax" else tc
        got = out[pkg] = {}
        try:
            got["train"] = _tdir(c, "train")
            if pkg == "jax":
                jrt.train(got["train"])
            else:
                runtime.train(got["train"], device="cpu")
            _disable_all()
            ckpt = os.path.join(c.save_dir, "6.npz")
            got["eval"] = _tdir(c.replace(phase="eval"), "eval")
            got["test"] = _tdir(c.replace(phase="test"), "test")
            if pkg == "jax":
                jrt.evaluate(got["eval"], model_file=ckpt)
                _disable_all()
                jrt.test(got["test"], model_file=ckpt)
            else:
                runtime.evaluate(got["eval"], model_file=ckpt, device="cpu")
                _disable_all()
                runtime.test(got["test"], model_file=ckpt, device="cpu")
            _disable_all()
            got["bulk"] = _tdir(c.replace(
                phase="bulk", bulk_input=c.train_image_dir, bulk_output=os.path.join(root, pkg, "bulk"),
                bulk_shard_rows=6, beam_size=2, serve_slot_pages=2, serve_page_width=2, shard_cache="off",
            ), "bulk")
            if pkg == "jax":
                assert jax_run_bulk(got["bulk"], model_file=ckpt) == 0
            else:
                assert runner.run_bulk(got["bulk"], model_file=ckpt, device="cpu") == 0
        finally:
            _disable_all()
    return out


def _names(d):
    return sorted(os.listdir(d))


def _json(path):
    with open(path) as f:
        return json.load(f)


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _span_names(path):
    return {e["name"] for e in _json(path)["traceEvents"] if e.get("ph") == "X"}


# the one artifact the port writes that the JAX package does not: the
# decode loop's heartbeat (the card's name and allocated bytes)
DECODE_EXTRA = {"heartbeat.json"}


@pytest.mark.parametrize("phase", ["train", "eval", "test", "bulk"])
def test_artifact_names_match_jax(runs, phase):
    want = set(_names(runs["jax"][phase].telemetry_dir))
    got = set(_names(runs["port"][phase].telemetry_dir))
    extra = DECODE_EXTRA if phase in ("eval", "test") else set()
    assert got == want | extra
    assert "blackbox" in got
    assert not any(n.startswith("postmortem_") for n in got)  # clean exits
    if phase == "train":
        assert {"heartbeat.json", "trace.json", "breakdown.json", "telemetry.jsonl",
                "compile_report.json", "slo.jsonl"} <= got
    elif phase != "bulk":
        assert {"trace-decode.json", "breakdown-decode.json", "compile_report-decode.json"} <= got


ARTIFACTS = [("train", "heartbeat.json"), ("bulk", "heartbeat.json"), ("train", "breakdown.json"),
             ("eval", "breakdown-decode.json"), ("test", "breakdown-decode.json"),
             ("train", "compile_report.json"), ("eval", "compile_report-decode.json"),
             ("train", "telemetry.jsonl"), ("train", "slo.jsonl")]


@pytest.mark.parametrize("phase,name", ARTIFACTS, ids=[f"{p}-{n}" for p, n in ARTIFACTS])
def test_json_key_sets_match_jax(runs, phase, name):
    paths = {pkg: os.path.join(runs[pkg][phase].telemetry_dir, name) for pkg in ("jax", "port")}
    if name.endswith(".jsonl"):
        want, got = _jsonl(paths["jax"]), _jsonl(paths["port"])
        assert want and got
        assert {k for r in got for k in r} == {k for r in want for k in r}
        if name == "telemetry.jsonl":
            assert [r["step"] for r in got] == [r["step"] for r in want] == [2, 4, 6]
            diag = lambda rows: {k for k in rows[-1]["gauges"] if k.startswith("diag/")}  # noqa: E731
            assert diag(got) == diag(want) and "diag/grad_norm/decoder.lstm" in diag(got)
            assert all(np.isfinite(v) for k, v in got[-1]["gauges"].items() if k.startswith("diag/"))
        return
    want, got = _json(paths["jax"]), _json(paths["port"])
    assert sorted(got) == sorted(want)
    if name.startswith("breakdown"):
        assert sorted(got["phases"]) == sorted(want["phases"])
        assert sorted(got["nested"]) == sorted(want["nested"])
        assert sorted(got["step"]) == sorted(want["step"])
    if name.startswith("compile_report"):
        assert sorted(got["functions"]) == sorted(want["functions"])
        for fn in want["functions"]:
            assert sorted(got["functions"][fn]) == sorted(want["functions"][fn])
            assert got["functions"][fn]["cost"]["flops"] > 0
    if name == "heartbeat.json":
        assert got["phase"] == want["phase"] == phase
        if phase == "train":
            assert got["supervisor"] == {"restarts": 0}
            assert got["device_kind"] == "cpu" and got["device_platform"] == "cpu"
            assert got["step"] == want["step"] == 6
            assert sorted(got["diag"]) == sorted(want["diag"])


@pytest.mark.parametrize("phase,name", [("train", "trace.json"), ("eval", "trace-decode.json"),
                                        ("test", "trace-decode.json")])
def test_trace_span_names_match_jax(runs, phase, name):
    want = _span_names(os.path.join(runs["jax"][phase].telemetry_dir, name))
    got = _span_names(os.path.join(runs["port"][phase].telemetry_dir, name))
    assert got == want
    loop = "train" if phase == "train" else "decode"
    assert {f"{loop}/data_wait", f"{loop}/dispatch", "feed/device_put"} <= got


@pytest.mark.parametrize("phase,name", [("train", "breakdown.json"), ("eval", "breakdown-decode.json")])
def test_breakdown_phases_sum_within_5pct_of_wall(runs, phase, name):
    report = _json(os.path.join(runs["port"][phase].telemetry_dir, name))
    assert report["phase_total_s"] == pytest.approx(report["wall_s"], rel=0.05)
    assert report["steps"] == (6 if phase == "train" else 3)  # 9 eval ids in batches of 4
    accounted = sum(p["total_s"] for k, p in report["phases"].items() if k != "other")
    assert 0 < accounted <= report["wall_s"] * 1.05


def test_metrics_jsonl_carries_the_diag_columns(runs):
    def rows(pkg):
        return _jsonl(os.path.join(runs[pkg]["train"].summary_dir, "metrics.jsonl"))

    got, want = rows("port"), rows("jax")
    assert [r["step"] for r in got] == [r["step"] for r in want]
    assert {k for k in got[-1] if k.startswith("diag/")} == {k for k in want[-1] if k.startswith("diag/")}
    assert 0.0 < got[-1]["diag/attn_entropy_frac"] <= 1.0


def _die_when_slo_logged(monkeypatch, pkg, tdir):
    """Hold the injected preemption until the SLO engine's thread has
    logged the burn to ``slo.jsonl``.  The bundle copies the files that
    exist when the exit fires, and this one is the only file a timer
    writes: without the wait, whether it is in the bundle depends on how
    loaded the machine is."""
    if pkg == "jax":
        from sat_tpu.resilience.faultinject import FaultPlan
    else:
        from sat_tpu_torch.resilience.faultinject import FaultPlan
    kill = FaultPlan.maybe_kill

    def maybe_kill(self, step):
        if self.die_at_step is not None and step >= self.die_at_step:
            deadline = time.monotonic() + 60.0
            while not os.path.exists(os.path.join(tdir, "slo.jsonl")) and time.monotonic() < deadline:
                time.sleep(0.02)
        return kill(self, step)

    monkeypatch.setattr(FaultPlan, "maybe_kill", maybe_kill)


def _die_run(pkg, coco_fixture, root, monkeypatch):
    """train through the package's CLI with --blackbox, preempted at step
    2 by ``SAT_FI_DIE_AT_STEP`` once the burning train SLO is logged;
    returns (exit code, telemetry dir)."""
    jc, tc = configs(**_settings(coco_fixture, root, pkg))
    config = _tdir(jc if pkg == "jax" else tc, "die")
    path = os.path.join(root, f"{pkg}.json")
    os.makedirs(root, exist_ok=True)
    config.save(path)
    monkeypatch.setenv("SAT_FI_DIE_AT_STEP", "2")
    _die_when_slo_logged(monkeypatch, pkg, config.telemetry_dir)
    try:
        rc = (jax_cli if pkg == "jax" else cli).main(["--config", path, "--phase", "train", "--blackbox"])
    finally:
        _disable_all()
    return rc, config.telemetry_dir


def test_postmortem_bundle_matches_jax_after_an_injected_exit(coco_fixture, tmp_path, monkeypatch):
    monkeypatch.setenv("SAT_TORCH_DEVICE", "cpu")
    bundles = {}
    for pkg in ("jax", "port"):
        rc, tdir = _die_run(pkg, coco_fixture, str(tmp_path), monkeypatch)
        assert rc == 1
        found = glob.glob(os.path.join(tdir, "postmortem_*"))
        assert len(found) == 1, (pkg, _names(tdir))
        bundles[pkg] = found[0]
    want, got = _names(bundles["jax"]), _names(bundles["port"])
    assert got == want and "manifest.json" in got
    manifest = _json(os.path.join(bundles["port"], "manifest.json"))
    assert manifest["reason"] == "simulated_preemption" and manifest["exit_code"] == 1
    assert sorted(manifest) == sorted(_json(os.path.join(bundles["jax"], "manifest.json")))


def test_telemetry_off_leaves_no_artifact(coco_fixture, tmp_path):
    _, tc = configs(**_settings(coco_fixture, str(tmp_path), "port"))
    config = tc.replace(telemetry=False, blackbox=False, diag_level="off", max_steps=2)
    runtime.train(config, device="cpu")
    runtime.evaluate(config.replace(phase="eval"), model_file=os.path.join(config.save_dir, "2.npz"),
                     device="cpu")
    assert not os.path.exists(os.path.join(config.summary_dir, "telemetry"))
    assert isinstance(telemetry.get(), telemetry.NullTelemetry)
    rows = _jsonl(os.path.join(config.summary_dir, "metrics.jsonl"))
    assert rows and not any(k.startswith("diag/") for r in rows for k in r)


def test_telemetry_off_keeps_the_callers_registry(coco_fixture, tmp_path):
    """A run with telemetry off leaves a registry its caller enabled in
    place (bulk and serve enable their own) and records into it: the
    loader's counters land there, and the run writes no artifact."""
    _, tc = configs(**_settings(coco_fixture, str(tmp_path), "port"))
    config = tc.replace(telemetry=False, blackbox=False, diag_level="off", max_steps=2)
    tel = telemetry.enable()
    try:
        runtime.train(config, device="cpu")
        runtime.evaluate(config.replace(phase="eval"), model_file=os.path.join(config.save_dir, "2.npz"),
                         device="cpu")
        assert telemetry.get() is tel
        assert tel.aggregates().get("decode/batch", (0,))[0] == 3
    finally:
        telemetry.disable()
    assert not os.path.exists(os.path.join(config.summary_dir, "telemetry"))


# -- ProfilerWindow: JAX's test_profiler_window_* on the port's window -------


@pytest.fixture
def fake_profiler(monkeypatch):
    calls = []
    monkeypatch.setattr(runtime, "_start_trace", lambda device: calls.append(("start",)))
    monkeypatch.setattr(runtime, "_stop_trace", lambda prof, d: calls.append(("stop",)))
    monkeypatch.setattr(runtime, "_sync", lambda x: calls.append(("sync", x)))
    return calls


def _window_config(tmp_path, **kw):
    return Config(**{"profile_dir": str(tmp_path / "prof"), "profile_start_step": 5, "profile_num_steps": 3, **kw})


WINDOW_CASES = ["resume_aware_start", "max_start_clamps_short_loops", "exit_closes_early_loop_exit",
                "sweep_reentry_never_double_opens", "off_when_no_dir", "exit_idempotent",
                "start_collision_degrades_and_never_stops", "stop_failure_degrades_and_stays_closed"]


@pytest.mark.parametrize("case", WINDOW_CASES)
def test_profiler_window(case, fake_profiler, monkeypatch, tmp_path, capsys):
    W = runtime.ProfilerWindow
    prof_dir = str(tmp_path / "prof")
    if case == "resume_aware_start":
        with W(_window_config(tmp_path)) as prof:
            for i in range(100, 110):
                prof.before_step(i)
                prof.after_step(i, f"sync{i}")
        assert [c[0] for c in fake_profiler if c[0] != "sync"] == ["start", "stop"]
        assert fake_profiler[fake_profiler.index(("stop",)) - 1] == ("sync", "sync102")
    elif case == "max_start_clamps_short_loops":
        with W(_window_config(tmp_path), max_start=2) as prof:
            for i in range(3):
                prof.before_step(i)
                prof.after_step(i, i)
        assert ("start",) in fake_profiler and ("stop",) in fake_profiler
        assert len(os.listdir(prof_dir)) == 1
    elif case == "exit_closes_early_loop_exit":
        with W(_window_config(tmp_path, profile_start_step=0)) as prof:
            prof.before_step(0)
            prof.after_step(0, "s0")
        assert fake_profiler[-1] == ("stop",) and ("sync", "s0") in fake_profiler
    elif case == "sweep_reentry_never_double_opens":
        for _ in range(3):
            with W(_window_config(tmp_path), max_start=1) as prof:
                for i in range(2):
                    prof.before_step(i)
                    prof.after_step(i, i)
        assert [c[0] for c in fake_profiler if c[0] in ("start", "stop")] == ["start", "stop"] * 3
        assert len(os.listdir(prof_dir)) == 3  # a directory a window
    elif case == "off_when_no_dir":
        with W(_window_config(tmp_path, profile_dir="")) as prof:
            for i in range(10):
                prof.before_step(i)
                prof.after_step(i, i)
        assert fake_profiler == []
    elif case == "exit_idempotent":
        w = W(_window_config(tmp_path, profile_start_step=0))
        w.before_step(0)
        w.after_step(0, "s")
        w.__exit__()
        w.__exit__()
        assert [c[0] for c in fake_profiler].count("stop") == 1
    elif case == "start_collision_degrades_and_never_stops":
        starts = []

        def boom(device):
            starts.append(device)
            raise RuntimeError("Profiler is already enabled")

        monkeypatch.setattr(runtime, "_start_trace", boom)
        with W(_window_config(tmp_path, profile_start_step=0)) as prof:
            for i in range(10):
                prof.before_step(i)
                prof.after_step(i, i)
        assert len(starts) == 1
        assert ("stop",) not in fake_profiler and ("sync", 0) not in fake_profiler
        assert "start_trace failed" in capsys.readouterr().err
    else:
        stops = []

        def boom(p, d):
            stops.append("stop")
            raise RuntimeError("No profile started")

        monkeypatch.setattr(runtime, "_stop_trace", boom)
        with W(_window_config(tmp_path, profile_start_step=0)) as prof:
            for i in range(5):
                prof.before_step(i)
                prof.after_step(i, i)
        assert stops == ["stop"]
        assert "stop_trace failed" in capsys.readouterr().err


def test_profiler_window_writes_a_torch_trace(tmp_path):
    """The real torch.profiler behind the window: one trace.json in its own
    directory, holding the steps' CPU ops."""
    with runtime.ProfilerWindow(_window_config(tmp_path, profile_start_step=0, profile_num_steps=2),
                                device=torch.device("cpu")) as prof:
        for i in range(4):
            prof.before_step(i)
            x = torch.ones(8, 8) @ torch.ones(8, 8)
            prof.after_step(i, x)
    (window,) = os.listdir(tmp_path / "prof")
    names = {e.get("name") for e in _json(str(tmp_path / "prof" / window / "trace.json"))["traceEvents"]}
    assert "aten::mm" in names


# -- /metrics and SIGUSR2 during a port train run ----------------------------


def test_metrics_listener_and_sigusr2_during_a_train_run(coco_fixture, tmp_path, monkeypatch):
    """A port train run with ``metrics_port`` and a slowed step: one scrape
    of ``/metrics`` while it runs shows the train gauges, and one
    ``SIGUSR2`` opens a live profiler window (a trace under
    ``profiles/``)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    _, tc = configs(**_settings(coco_fixture, str(tmp_path), "port"))
    config = tc.replace(metrics_port=port, log_every=1, profile_window_ms=50.0, blackbox=False,
                        slo_captions_per_s=0.0, telemetry_dir=str(tmp_path / "tel"))
    monkeypatch.setenv("SAT_FI_SLOW_STEP_MS", "300")
    scraped, errors = [], []

    def poke():
        deadline = time.time() + 60
        while time.time() < deadline and not scraped:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=5) as r:
                    text = r.read().decode()
                if 'name="train/step"' in text:
                    scraped.append(text)
                    os.kill(os.getpid(), signal.SIGUSR2)
            except OSError as e:
                errors.append(e)
                time.sleep(0.05)

    t = threading.Thread(target=poke, daemon=True)
    t.start()
    try:
        runtime.train(config, device="cpu")
    finally:
        t.join(timeout=60)
        _disable_all()
    assert scraped, errors[-3:]
    assert promtext.CONTENT_TYPE.startswith("text/plain")
    assert "sat_up 1" in scraped[0] and 'sat_gauge{name="supervisor/restarts"} 0' in scraped[0]
    traces = glob.glob(str(tmp_path / "tel" / "profiles" / "*" / "trace.json"))
    assert len(traces) == 1
    with pytest.raises(OSError):  # the listener is gone with the run
        urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=2)


# -- bulk with the flight recorder -------------------------------------------


def test_bulk_with_blackbox_is_bitwise_bulk_without(runs, tmp_path):
    """The recorder observes only: the same output files, byte for byte."""
    with_bb = runs["port"]["bulk"]
    without = with_bb.replace(blackbox=False, telemetry=False, bulk_output=str(tmp_path / "plain"),
                              telemetry_dir=str(tmp_path / "tel"))
    try:
        assert runner.run_bulk(without, model_file=os.path.join(with_bb.save_dir, "6.npz"), device="cpu") == 0
    finally:
        _disable_all()

    def files(d):
        return {n: open(os.path.join(d, n), "rb").read() for n in _names(d) if n.startswith("captions_")}

    a, b = files(with_bb.bulk_output), files(without.bulk_output)
    assert a and a == b
    ring = _jsonl(sorted(glob.glob(os.path.join(with_bb.telemetry_dir, "blackbox", "seg_*.jsonl")))[0])
    events = [r.get("event") for r in ring]
    assert events[0] == "bulk_start" and "bulk_shard_done" in events and events[-1] == "bulk_complete"
    assert not os.path.exists(os.path.join(without.telemetry_dir, "blackbox"))
    shutil.rmtree(str(tmp_path / "plain"))
