"""The port's evidence tools (``sat_tpu_torch.tools``) held against the JAX
package's scripts on the CPU: the corpora byte for byte; the quality run
against ``scripts/quality_run.py`` at the small model's widths (losses,
captions, scores, the scores.json keys); a continued run bitwise an
uninterrupted one; the import-then-finetune checks, and its exported npy
in sat_tpu; export and trim against ``scripts/export_reference.py`` and
``scripts/trim_model.py``; ``merge_traces`` and ``check_slo`` against
theirs on the port's trace exports and SLO logs; ``analyze_postmortem``
over a port bundle; every tool refusing to run without a card unless
asked for the CPU."""

import contextlib
import importlib
import importlib.util
import io
import json
import os
import shutil
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from sat_tpu_torch import telemetry
from sat_tpu_torch.tools import (
    check_slo,
    continue_quality_run,
    corpus,
    export_reference,
    import_finetune_run,
    merge_traces,
    quality_run,
    trim_model,
)
from sat_tpu_torch.train.checkpoint import load_flat

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_runtime.py's small model, float32 (the tools' --extra-set)
TINY = ["dim_embedding=16", "num_lstm_units=16", "dim_initialize_layer=16", "dim_attend_layer=16",
        "dim_decode_layer=32", "compute_dtype=float32", "num_data_workers=2"]
# dropout off: the packages draw their masks from different generators
NO_DROPOUT = ["fc_drop_rate=0.0", "lstm_drop_rate=0.0"]
# 8 images, 16 pairs: 4 steps an epoch at batch 4, 2 epochs
RUN = ["--steps", "8", "--num-images", "8", "--batch-size", "4", "--image-size", "32"]


def extra(sets):
    return [x for s in sets for x in ("--extra-set", s)]


def jax_script(name: str):
    """``scripts/<name>.py`` as a module (its top level imports no jax)."""
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_jax_main(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [module.__file__] + list(argv))
    return module.main()


def tree_bytes(root: str) -> dict:
    out = {}
    for base, _, names in os.walk(root):
        for n in names:
            path = os.path.join(base, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def jax_initial_state(config_path: str, out: str) -> str:
    """The state ``sat_tpu.runtime.train`` starts from (``create_train_state``
    at the config's seed) as a flat npz the port restores bitwise."""
    from sat_tpu.config import Config as JaxConfig
    from sat_tpu.train.checkpoint import state_to_flat
    from sat_tpu.train.step import create_train_state

    jc = JaxConfig.load(config_path)
    np.savez(out, **state_to_flat(create_train_state(jax.random.PRNGKey(jc.seed), jc)))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX script (``--cpu --no-results-md``) and the port's tool on
    the same arguments: 8 steps of the small model, dropout off, a log
    row a step.  The packages draw their initial weights from different
    generators, so the port's run starts from the JAX run's initial state
    (``runtime.setup_train_state`` handed it as its checkpoint)."""
    from sat_tpu_torch import runtime

    root = tmp_path_factory.mktemp("quality")
    args = RUN + extra(TINY + NO_DROPOUT + ["log_every=1"])
    mp = pytest.MonkeyPatch()
    try:
        assert run_jax_main(jax_script("quality_run"), ["--cpu", "--no-results-md", "--out", str(root / "jax")]
                            + args, mp) == 0
        init = jax_initial_state(str(root / "jax" / "models" / "config.json"), str(root / "jax_init.npz"))
        setup = runtime.setup_train_state
        mp.setattr(runtime, "setup_train_state", lambda config, **kw: setup(config, **{**kw, "model_file": init}))
        assert quality_run.main(["--cpu", "--out", str(root / "port")] + args) == 0
        os.remove(init)
    finally:
        mp.undo()
    yield root
    shutil.rmtree(root, ignore_errors=True)  # each checkpoint holds VGG16's full convs and their slots


def _json(path):
    with open(path) as f:
        return json.load(f)


def _losses(root):
    with open(os.path.join(root, "summary", "metrics.jsonl")) as f:
        return [(r["step"], r["total_loss"]) for r in map(json.loads, f)]


@pytest.mark.parametrize("kind", ["basic", "rich"])
def test_corpus_bytes_equal_the_jax_script(tmp_path, kind):
    """Both corpora, written by the JAX script's makers and the port's on
    this machine: every JPEG and the captions JSON byte for byte, and the
    rich corpus's caption lengths."""
    script = jax_script("quality_run")
    if kind == "basic":
        want = script.make_corpus(str(tmp_path / "jax"))
        got = corpus.make_corpus(str(tmp_path / "port"))
    else:
        want = script.make_rich_corpus(str(tmp_path / "jax"))
        got = corpus.make_rich_corpus(str(tmp_path / "port"))
        assert got[2] == want[2]
    jb, pb = tree_bytes(str(tmp_path / "jax")), tree_bytes(str(tmp_path / "port"))
    assert sorted(pb) == sorted(jb) and len(pb) == {"basic": 49, "rich": 337}[kind]
    assert all(pb[k] == jb[k] for k in jb)


def test_loss_curve_reader_matches_the_jax_script(runs):
    path = str(runs / "port" / "summary" / "metrics.jsonl")
    script = jax_script("quality_run")
    for samples in (3, 12, 10**9):
        assert corpus.read_loss_curve(path, samples) == script.read_loss_curve(path, samples)


def test_quality_run_losses_match_the_jax_script(runs):
    """Every logged step's total loss within 1e-5 relative of the JAX
    script's: the bound ``tests/test_torch_train_loop.py`` holds the two
    packages' losses to (their sums run in other orders)."""
    got, want = _losses(runs / "port"), _losses(runs / "jax")
    assert [s for s, _ in got] == [s for s, _ in want] == list(range(1, 9))
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-5)


def test_quality_run_captions_scores_and_keys_match_the_jax_script(runs):
    """results.json captions identical, each score within 1e-6, the same
    scores.json keys but the port's ``power_limit``; summary.md written
    and RESULTS.md untouched."""
    got, want = _json(runs / "port" / "results.json"), _json(runs / "jax" / "results.json")
    assert sorted(got, key=lambda r: r["image_id"]) == sorted(want, key=lambda r: r["image_id"])
    scores, jscores = _json(runs / "port" / "scores.json"), _json(runs / "jax" / "scores.json")
    assert sorted(scores) == sorted(set(jscores) | {"power_limit"})
    assert sorted(scores["scores"]) == sorted(jscores["scores"])
    for k, v in jscores["scores"].items():
        assert abs(scores["scores"][k] - v) <= 1e-6, k
    for k in ("steps", "num_images", "corpus", "train_cnn", "vocab_words", "protocol"):
        assert scores[k] == jscores[k], k
    assert (scores["device"], scores["power_limit"]) == ("cpu", None)
    assert "| Bleu_4 |" in (runs / "port" / "summary.md").read_text()


def test_continued_run_is_bitwise_the_uninterrupted_run(tmp_path):
    """3 steps, then ``continue_quality_run`` one more epoch, against 6
    steps straight (dropout on): 6.npz bitwise, scores.json keeping the
    first run's fields and naming the step it continued from."""
    base = ["--num-images", "6", "--batch-size", "4", "--image-size", "32", "--cpu"] + extra(TINY)
    assert quality_run.main(["--steps", "3", "--out", str(tmp_path / "cont")] + base) == 0
    with contextlib.redirect_stdout(io.StringIO()):
        assert continue_quality_run.main(["--out", str(tmp_path / "cont"), "--corpus", "basic", "--extra-epochs", "1",
                                          "--batch-size", "4", "--image-size", "32", "--cpu"] + extra(TINY)) == 0
    assert quality_run.main(["--steps", "6", "--out", str(tmp_path / "straight")] + base) == 0
    got, want = load_flat(str(tmp_path / "cont" / "models" / "6.npz")), load_flat(
        str(tmp_path / "straight" / "models" / "6.npz"))
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    scores = _json(tmp_path / "cont" / "scores.json")
    assert (scores["steps"], scores["continued_from_step"], scores["corpus"]) == (6, 3, "basic")
    shutil.rmtree(tmp_path)


def test_import_finetune_checks_pass_and_the_npy_imports_into_jax(tmp_path):
    """The four checks at the small size (4 images at batch 2, Adam at
    1e-2 and a log row a step, so 12 donor and 8 finetune steps show
    them); the exported npy imported into sat_tpu's and the port's fresh
    states gives the same eval loss within 1e-5 relative."""
    out = tmp_path / "ift"
    with contextlib.redirect_stdout(io.StringIO()):
        rc = import_finetune_run.main(["--cpu", "--steps-a", "12", "--steps-b", "8", "--num-images", "4",
                                       "--batch-size", "2", "--image-size", "32", "--out", str(out)]
                                      + extra(TINY + ["initial_learning_rate=0.01", "log_every=1"]))
    summary = _json(out / "summary.json")
    assert rc == 0, summary
    assert summary["verdicts"] == {"import_resumes_phase_a": True, "import_beats_scratch_start": True,
                                   "finetune_improves": True, "finetune_beats_scratch": True}
    assert summary["tensors_exported"] == summary["tensors_imported"] > 0

    from sat_tpu.config import Config as JaxConfig
    from sat_tpu.train.checkpoint import import_reference_checkpoint as jax_import
    from sat_tpu.train.step import create_train_state as jax_state
    from sat_tpu.train.step import make_eval_loss_step as jax_eval_loss
    from sat_tpu_torch import runtime
    from sat_tpu_torch.config import Config
    from sat_tpu_torch.data.dataset import prepare_train_data
    from sat_tpu_torch.data.images import ImageLoader
    from sat_tpu_torch.train.checkpoint import import_reference_checkpoint
    from sat_tpu_torch.train.step import make_eval_loss_step

    config = Config.load(str(out / "models_b" / "config.json"))
    ref = str(out / "reference_layout.npy")
    state, n = import_reference_checkpoint(runtime.setup_train_state(config, seed=7, device="cpu"), ref)
    jc = JaxConfig.from_dict(config.to_dict())
    jstate, jn = jax_import(jax_state(jax.random.PRNGKey(7), jc), ref)
    assert n == jn == summary["tensors_exported"]
    data = prepare_train_data(config)
    batch = {"images": ImageLoader(config.image_size).load_images(data.image_files[:2]),
             "word_idxs": data.word_idxs[:2].astype(np.int32), "masks": data.masks[:2].astype(np.float32)}
    want = jax_eval_loss(jc)(jstate, batch)
    got = make_eval_loss_step(config)(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("total_loss", "cross_entropy_loss", "attention_loss", "accuracy"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    shutil.rmtree(tmp_path)


def test_export_and_trim_match_the_jax_scripts(runs, tmp_path, monkeypatch):
    """One port checkpoint (the quality run's 8.npz and its config.json)
    through both packages' export and trim command lines: the same names,
    the arrays bitwise."""
    monkeypatch.setenv("SAT_TORCH_DEVICE", "cpu")
    ckpt = str(runs / "port" / "models" / "8.npz")
    with contextlib.redirect_stdout(io.StringIO()):
        assert run_jax_main(jax_script("export_reference"), [ckpt, str(tmp_path / "jax.npy")], monkeypatch) == 0
        assert export_reference.main([ckpt, str(tmp_path / "port.npy")]) == 0
    want = np.load(tmp_path / "jax.npy", allow_pickle=True).item()
    got = np.load(tmp_path / "port.npy", allow_pickle=True).item()
    assert sorted(got) == sorted(want) and len(got) > 40
    assert all(np.array_equal(got[k], want[k]) for k in want)

    with contextlib.redirect_stdout(io.StringIO()):
        assert run_jax_main(jax_script("trim_model"), [ckpt, str(tmp_path / "jax.npz")], monkeypatch) == 0
        assert trim_model.main([ckpt, str(tmp_path / "port.npz")]) == 0
        assert trim_model.main([ckpt]) == 2  # usage, as the JAX script's
    want, got = load_flat(str(tmp_path / "jax.npz")), load_flat(str(tmp_path / "port.npz"))
    assert sorted(got) == sorted(want) and not any(k.startswith("optimizer/") for k in got)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    shutil.rmtree(tmp_path)


TOOLS = {
    "quality_run": ["--out", "{tmp}/q"],
    "continue_quality_run": ["--out", "{tmp}/q"],
    "import_finetune_run": ["--out", "{tmp}/i"],
    "export_reference": ["{tmp}/a.npz", "{tmp}/a.npy"],
    "trim_model": ["{tmp}/a.npz", "{tmp}/b.npz"],
    "replay_exemplar": ["--dir", "{tmp}"],
    "merge_traces": ["{tmp}/trace.json"],
    "check_slo": ["{tmp}/slo.jsonl"],
}


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_each_tool_needs_a_card_unless_asked_for_the_cpu(name, tmp_path, monkeypatch):
    """Without a card, ``--cpu`` or ``SAT_TORCH_DEVICE=cpu`` every tool
    raises before it writes anything; ``SAT_TORCH_DEVICE=cuda`` is no
    request for the CPU either."""
    module = importlib.import_module(f"sat_tpu_torch.tools.{name}")
    argv = [a.format(tmp=tmp_path) for a in TOOLS[name]]
    for env in (None, "cuda"):
        if env is None:
            monkeypatch.delenv("SAT_TORCH_DEVICE", raising=False)
        else:
            monkeypatch.setenv("SAT_TORCH_DEVICE", env)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            module.main(argv)
    assert sorted(os.listdir(tmp_path)) == []


# -- the operator's tools over the port's trace exports and SLO logs -----------


def _port_trace(path: str, names) -> None:
    """A trace export of the port's registry holding spans ``names``."""
    tel = telemetry.enable()
    try:
        for name in names:
            with tel.span(name):
                time.sleep(0.001)
        from sat_tpu_torch.telemetry import exporters

        assert exporters.export_chrome_trace(tel, path) == path
    finally:
        telemetry.disable()


def _captured(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_merge_traces_matches_the_jax_script(tmp_path, monkeypatch):
    """Two port trace exports (anchors 20 ms apart), an empty trace and an
    unreadable file: the JAX script's merged document, printed line and
    exit code (0, 2, 1)."""
    monkeypatch.setenv("SAT_TORCH_DEVICE", "cpu")
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    _port_trace(a, ["train/step", "train/dispatch"])
    time.sleep(0.02)
    _port_trace(b, ["decode/batch"])
    with open(tmp_path / "empty.json", "w") as f:
        json.dump({"traceEvents": []}, f)
    (tmp_path / "bad.json").write_text("{not json")
    jax_merge = jax_script("merge_traces")
    for inputs, rc in (([a, b], 0), ([str(tmp_path / "empty.json")], 2), ([a, str(tmp_path / "bad.json")], 1)):
        got = _captured(merge_traces.main, inputs + ["--out", str(tmp_path / "port_out.json")])
        want = _captured(jax_merge.main, inputs + ["--out", str(tmp_path / "jax_out.json")])
        assert got[0] == want[0] == rc
        assert got[1].replace("port_out", "jax_out") == want[1]
        assert got[2] == want[2]
        if rc == 0:
            merged = _json(tmp_path / "port_out.json")
            assert merged == _json(tmp_path / "jax_out.json")
            assert len(merged["otherData"]["merged_from"]) == 2 and merged["otherData"]["merged_from"][1]["shift_us"] > 0


def _port_slo_log(path: str, levels) -> None:
    """The port's SLO engine over a gauge ceiling (target 1.0), one tick a
    level of the gauge: each crossing is a transition row."""
    from sat_tpu_torch.telemetry.slo import Objective, SLOEngine

    tel = telemetry.enable()
    try:
        engine = SLOEngine(tel, [Objective("queue", "gauge_ceiling", 1.0, "serve/queue_depth")], jsonl_path=path)
        for level in levels:
            tel.gauge("serve/queue_depth", level)
            engine.tick()
    finally:
        telemetry.disable()


def test_check_slo_matches_the_jax_script(tmp_path, monkeypatch):
    """Port SLO logs through both packages' gates: a recovered burn (0,
    and 2 under --strict), a burn still on (2), a foreign schema version
    (3), a torn line and an empty log (0), a missing file (1); the same
    printed lines."""
    monkeypatch.setenv("SAT_TORCH_DEVICE", "cpu")
    recovered, burning = str(tmp_path / "recovered.jsonl"), str(tmp_path / "burning.jsonl")
    _port_slo_log(recovered, [0.5, 3.0, 0.5])
    _port_slo_log(burning, [3.0])
    assert [r["event"] for r in map(json.loads, open(recovered))] == ["burning", "ok"]
    foreign = tmp_path / "foreign.jsonl"
    foreign.write_text(json.dumps({**json.loads(open(burning).readline()), "schema_version": 99}) + "\n")
    torn = tmp_path / "torn.jsonl"
    torn.write_text(open(recovered).read() + '{"name": "que')
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    jax_gate = jax_script("check_slo")
    cases = (([recovered], 0), ([recovered, "--strict"], 2), ([burning], 2), ([str(foreign)], 3),
             ([str(torn)], 0), ([str(empty)], 0), ([str(tmp_path / "missing.jsonl")], 1))
    for argv, rc in cases:
        got, want = _captured(check_slo.main, argv), _captured(jax_gate.main, argv)
        assert got == want and got[0] == rc, argv


def test_analyze_postmortem_reads_a_port_bundle(tmp_path):
    """A bundle of the port's flight recorder (a watchdog abort, exit 86,
    during a checkpoint) read by ``scripts/analyze_postmortem.py --json``:
    exit 0, the exit code, the reason and the wedged phase."""
    from sat_tpu_torch.telemetry import blackbox

    tdir = str(tmp_path / "telemetry")
    tel = telemetry.enable()
    try:
        bb = blackbox.BlackBox(os.path.join(tdir, "blackbox"), tel)
        blackbox.install(bb, telemetry_dir=tdir, config_snapshot={"phase": "train"})
        with tel.span("train/step"):
            pass
        bb.event("train_start", step=0)
        bb.journal(3)
        bundle = blackbox.dump("watchdog_abort", exit_code=86, phase="checkpoint", step=3)
    finally:
        blackbox.uninstall()
        telemetry.disable()
    assert bundle and os.path.isdir(bundle)
    out = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "analyze_postmortem.py"), tdir, "--json"],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout)
    assert summary["exit_code"] == 86 and summary["reason"] == "watchdog_abort"
    assert summary["wedged_phase"] == "checkpoint" and "watchdog" in summary["probable_cause"]

