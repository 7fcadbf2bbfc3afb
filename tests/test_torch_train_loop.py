"""The port's training loop (``runtime.train`` on the CPU) on the shared
COCO fixture: metrics, tfevents and checkpoints; kill-and-resume bitwise
its uninterrupted run; the batch order and the data caches shared with
sat_tpu; checkpoints crossing between the packages both ways; the
sentinel's rollback; the CLI; and the train knobs not ported yet."""

import json
import os
import struct

import jax
import numpy as np
import pytest
import torch

from sat_tpu import runtime as jrt
from sat_tpu.data import dataset as jax_dataset
from sat_tpu.train.checkpoint import restore_checkpoint as jax_restore_checkpoint
from sat_tpu.train.step import create_train_state as jax_create_train_state
from sat_tpu.train.step import make_eval_loss_step as jax_make_eval_loss_step
from sat_tpu.utils.summary import _masked_crc
from sat_tpu_torch import cli, runtime
from sat_tpu_torch.config import Config
from sat_tpu_torch.data import dataset
from sat_tpu_torch.data.vocabulary import vocab_fingerprint
from sat_tpu_torch.resilience import faultinject, lineage
from sat_tpu_torch.resilience.lineage import CheckpointWriteError
from sat_tpu_torch.train import step as step_mod
from sat_tpu_torch.train.checkpoint import load_flat, state_to_flat
from sat_tpu_torch.train.step import make_eval_loss_step

torch.set_num_threads(2)

# tests/test_runtime.py's small model: 24 captions, batch 4, 6 steps an epoch
SMALL = dict(
    image_size=32, dim_embedding=16, num_lstm_units=16, dim_initialize_layer=16,
    dim_attend_layer=16, dim_decode_layer=32, compute_dtype="float32", save_period=3,
    log_every=1, num_epochs=1, num_data_workers=2,
)


def port_config(coco_fixture, tmp, **kw) -> Config:
    """The fixture's config for the port, with its own save, summary and
    cache paths under ``tmp``."""
    base = Config.from_dict(coco_fixture["config"].to_dict())
    return base.replace(**{
        **SMALL,
        "save_dir": os.path.join(tmp, "models"), "summary_dir": os.path.join(tmp, "summary"),
        "temp_annotation_file": os.path.join(tmp, "anns.csv"),
        "temp_data_file": os.path.join(tmp, "data.npy"),
        **kw,
    })


def jax_config(config: Config):
    from sat_tpu.config import Config as JaxConfig

    return JaxConfig.from_dict(config.to_dict())


def fixed_batch(config, dataset_obj, index=0):
    """One training batch as numpy, images decoded by the port's loader."""
    from sat_tpu_torch.data.images import ImageLoader

    files, words, masks = dataset_obj.image_files[:4], dataset_obj.word_idxs[:4], dataset_obj.masks[:4]
    images = ImageLoader(config.image_size).load_images(files)
    return {"images": images, "word_idxs": words.astype(np.int32), "masks": masks.astype(np.float32)}


@pytest.fixture(scope="module")
def trained(coco_fixture, tmp_path_factory):
    """The port trained 6 steps on the CPU (checkpoints at 3 and 6)."""
    tmp = str(tmp_path_factory.mktemp("port_train"))
    config = port_config(coco_fixture, tmp)
    state = runtime.train(config, device="cpu")
    return config, state


def test_train_writes_metrics_tfevents_and_checkpoints(trained):
    config, state = trained
    assert state.step == 6
    with open(os.path.join(config.summary_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [1, 2, 3, 4, 5, 6]
    for r in rows:
        for k in ("total_loss", "cross_entropy_loss", "attention_loss", "reg_loss", "accuracy",
                  "grad_norm", "attention/mean", "attention/std", "attention/max"):
            assert isinstance(r[k], float) and np.isfinite(r[k]), (r["step"], k)
    events = [n for n in os.listdir(config.summary_dir) if n.startswith("events.out.tfevents.")]
    assert len(events) == 1
    with open(os.path.join(config.summary_dir, events[0]), "rb") as f:
        data = f.read()
    records = 0
    while data:  # TFRecord framing with masked crc32c, checked by the JAX package's crc
        (length,) = struct.unpack("<Q", data[:8])
        assert struct.unpack("<I", data[8:12])[0] == _masked_crc(data[:8])
        payload = data[12 : 12 + length]
        assert struct.unpack("<I", data[12 + length : 16 + length])[0] == _masked_crc(payload)
        data = data[16 + length :]
        records += 1
    assert records == 7  # the file-version record and one a logged step
    assert lineage.checkpoint_steps(config.save_dir) == [3, 6]
    assert lineage.last_good_step(config.save_dir) == 6
    ok, reason = lineage.verify_checkpoint(os.path.join(config.save_dir, "6.npz"))
    assert ok, reason
    meta = lineage.read_sidecar_meta(os.path.join(config.save_dir, "6.npz"))
    assert meta["vocab"] == vocab_fingerprint(config.vocabulary_file, config.vocabulary_size)
    assert meta["topology"]["device_count"] == 1 and meta["topology"]["platform"] == "cpu"
    assert Config.load(os.path.join(config.save_dir, "config.json")).global_step == 6


def test_kill_and_resume_equals_uninterrupted_bitwise(coco_fixture, tmp_path):
    """Stopped at step 8 of 12 (2 epochs) and resumed with ``load``: the
    parameters and every optimizer slot bitwise those of the
    uninterrupted 12 steps (dropout on: the masks replay from the step)."""
    full = port_config(coco_fixture, str(tmp_path / "full"), num_epochs=2, save_period=0)
    want = runtime.train(full, device="cpu")
    assert want.step == 12

    cut = port_config(coco_fixture, str(tmp_path / "cut"), num_epochs=2, max_steps=8, save_period=0)
    assert runtime.train(cut, device="cpu").step == 8
    resumed = runtime.setup_train_state(cut, load=True, device="cpu")
    assert resumed.step == 8
    got = runtime.train(cut.replace(max_steps=0), state=resumed, device="cpu")
    assert got.step == 12

    a, b = state_to_flat(got), state_to_flat(want)
    assert sorted(a) == sorted(b)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_dataset_seek_replays_the_jax_batch_order(coco_fixture, tmp_path):
    """The port's DataSet gives JAX's batches (files, word_idxs, masks) for
    three epochs, and ``seek(1, 2)`` resumes on JAX's batch 2 of epoch 1."""
    config = port_config(coco_fixture, str(tmp_path))
    ours = dataset.prepare_train_data(config)
    theirs = jax_dataset.prepare_train_data(jax_config(config))
    assert ours.count == theirs.count == 24
    for _ in range(3):
        for a, b in zip(ours, theirs, strict=True):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    ours.seek(1, 2)
    theirs.seek(1, 2)
    assert [tuple(b[0]) for b in ours] == [tuple(b[0]) for b in theirs]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_data_caches_are_interchangeable(coco_fixture, tmp_path, writer):
    """vocabulary.csv, the annotation CSV and the data .npy written by one
    package serve the other: the same DataSet arrays as the writer's."""
    config = port_config(coco_fixture, str(tmp_path), vocabulary_file=str(tmp_path / "vocabulary.csv"))
    prepare = {"jax": lambda: jax_dataset.prepare_train_data(jax_config(config)),
               "port": lambda: dataset.prepare_train_data(config)}
    written = prepare[writer]()
    for name in ("vocabulary.csv", "anns.csv", "data.npy"):
        assert os.path.exists(tmp_path / name)
    read = prepare["port" if writer == "jax" else "jax"]()
    for field in ("image_ids", "image_files", "word_idxs", "masks"):
        np.testing.assert_array_equal(getattr(read, field), getattr(written, field), err_msg=field)


def test_port_checkpoint_restores_into_jax(trained):
    """Every tensor of the port's 6.npz (params and Adam slots) loads into
    JAX's ``create_train_state`` skeleton, and JAX's eval loss on a batch
    equals the port's within 1e-5 relative."""
    config, state = trained
    jc = jax_config(config)
    path = os.path.join(config.save_dir, "6.npz")
    skeleton = jax_create_train_state(jax.random.PRNGKey(9), jc)
    n_leaves = len(jax.tree_util.tree_leaves((skeleton.params, skeleton.opt_state)))
    jstate, count = jax_restore_checkpoint(skeleton, model_file=path)
    assert count == n_leaves == len(load_flat(path)) - 1  # all but global_step
    assert int(jstate.step) == 6
    batch = fixed_batch(config, dataset.prepare_train_data(config))
    want = jax_make_eval_loss_step(jc)(jstate, batch)
    got = make_eval_loss_step(config)(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("total_loss", "cross_entropy_loss", "attention_loss", "accuracy"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


def test_jax_checkpoint_resumes_in_the_port(coco_fixture, tmp_path):
    """JAX trains 6 steps (dropout off, checkpoints at 3 and 6); the port
    resumes from JAX's 3.npz and takes steps 4-6 on the same batches.
    Parameters within 1e-4 of the most three Adam steps can move one
    (3 · lr); Adam slots within 1e-5 of each leaf's largest value,
    floored at 1e-3 of the largest of its slot (mu or nu).  A leaf whose
    gradient nearly cancels (attend/fc_1a/bias, ~1e-8) holds mostly
    rounding, which Adam's normalisation scales up to a whole update."""
    config = port_config(coco_fixture, str(tmp_path), fc_drop_rate=0.0, lstm_drop_rate=0.0)
    want = jrt.train(jax_config(config))
    assert int(want.step) == 6
    from sat_tpu.train.checkpoint import state_to_flat as jax_state_to_flat

    want_flat = jax_state_to_flat(want)
    state = runtime.setup_train_state(config, model_file=os.path.join(config.save_dir, "3.npz"), device="cpu")
    assert state.step == 3
    got = state_to_flat(runtime.train(config.replace(save_dir=str(tmp_path / "port")), state=state,
                                      device="cpu"))
    assert sorted(got) == sorted(want_flat)

    step_bound = 1e-4 * 3 * config.initial_learning_rate
    largest = {}
    for k, w in want_flat.items():
        slot = "/".join(k.split("/")[:4])
        largest[slot] = max(largest.get(slot, 0.0), float(np.abs(w).max()))
    for k, w in want_flat.items():
        if k.startswith("optimizer/") and w.ndim:
            atol = 1e-5 * max(float(np.abs(w).max()), 1e-3 * largest["/".join(k.split("/")[:4])])
        else:
            atol = step_bound
        np.testing.assert_allclose(got[k], w, rtol=0, atol=atol, err_msg=k)


def test_sentinel_rollback_restores_last_good_and_moves_past(coco_fixture, tmp_path, monkeypatch):
    """A step that poisons the parameters and its metrics (NaN) at step 5:
    with ``anomaly_policy="rollback"`` the loop restores LAST_GOOD (step
    4), skips the poisoned batch and ends at step 6 with finite weights
    that never saw it."""
    real = step_mod.make_train_step

    def poisoning(config):
        step = real(config)

        def run(state, batch, generator):
            state, metrics = step(state, batch, generator)
            if state.step == 5:
                with torch.no_grad():
                    state.params["decoder"]["lstm"]["kernel"].fill_(float("nan"))
                metrics = {k: v * float("nan") for k, v in metrics.items()}
            return state, metrics

        return run

    monkeypatch.setattr(runtime, "make_train_step", poisoning)
    config = port_config(coco_fixture, str(tmp_path), anomaly_policy="rollback", save_period=2)
    state = runtime.train(config, device="cpu")
    assert state.step == 6
    flat = state_to_flat(state)
    assert all(np.isfinite(v).all() for v in flat.values())
    with open(os.path.join(config.summary_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [1, 2, 3, 4, 5, 6]
    assert rows[4]["total_loss"] == "nan"
    assert lineage.last_good_step(config.save_dir) == 6
    # the 6 saved at the end is 4's weights plus one step (the 6th batch)
    assert lineage.checkpoint_steps(config.save_dir) == [2, 4, 6]


def test_cli_train_needs_a_card_unless_patched_to_the_cpu(coco_fixture, tmp_path, monkeypatch):
    config = port_config(coco_fixture, str(tmp_path), phase="train", max_steps=2, save_period=0)
    path = str(tmp_path / "train.json")
    config.save(path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--config", path])
    real = runtime.resolve_device
    monkeypatch.setattr(runtime, "resolve_device", lambda device=None: real("cpu"))
    assert cli.main(["--config", path]) == 0
    assert lineage.last_good_step(config.save_dir) == 2
    assert cli.main(["--config", path, "--load", "--set", "max_steps=3"]) == 0
    assert lineage.last_good_step(config.save_dir) == 3

    def lost(*a, **k):
        raise CheckpointWriteError("final checkpoint did not land")

    monkeypatch.setattr(runtime, "train", lost)
    assert cli.main(["--config", path]) == 1
    assert cli.build_config(["--config", path, "--train_cnn"])[0].train_cnn
    # --supervise hands the same argv to the port's supervisor (patched)
    from sat_tpu_torch.resilience import supervisor

    seen = []
    monkeypatch.setattr(supervisor, "supervise", lambda argv, **kw: seen.append((argv, kw)) or 0)
    assert cli.main(["--config", path, "--supervise"]) == 0
    assert seen == [(["--config", path, "--supervise"],
                     {"max_restarts": config.supervise_max_restarts,
                      "backoff_base_s": config.supervise_backoff_s})]
    # --load_cnn imports the pretrained CNN of --cnn_model_file (default
    # ./vgg16_no_fc.npy, absent here): the missing file's error, as in JAX
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="vgg16_no_fc.npy"):
        cli.main(["--config", path, "--load_cnn"])


@pytest.mark.parametrize(
    "knob",
    [
        {"mesh_shape": (2, 1)},
        {"context_parallel": 2},
        {"remat_decoder": True},
        {"remat_cnn": True},
        {"diag_level": "basic"},
        {"telemetry": True},
        {"blackbox": True},
        {"profile_dir": "/nonexistent/profile"},
        {"fleet_telemetry": True},
    ],
    ids=lambda k: next(iter(k)),
)
def test_unported_train_knobs_raise(coco_fixture, tmp_path, knob):
    config = port_config(coco_fixture, str(tmp_path)).replace(**knob)
    with pytest.raises(NotImplementedError, match="not ported"):
        runtime.train(config, device="cpu")


def test_train_over_the_shard_cache_is_bitwise_the_live_run(coco_fixture, trained, tmp_path):
    """``shard_cache="on"`` builds the cache over the training images and
    trains from it: the same 6 steps, bitwise, as the live-decode run."""
    config = port_config(coco_fixture, str(tmp_path), shard_cache="on", shard_cache_dir=str(tmp_path / "cache"))
    state = runtime.train(config, device="cpu")
    assert os.path.exists(os.path.join(config.shard_cache_dir, "r32-v1", "manifest.json"))
    a, b = state_to_flat(state), state_to_flat(trained[1])
    assert sorted(a) == sorted(b)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_quarantine_ledger_knob_places_the_ledger(coco_fixture, tmp_path, monkeypatch):
    """A caption zeroed by ``SAT_FI_BAD_CAPTION_AT`` is quarantined as
    ``caption_all_oov`` at its (pass, batch, row), into the file
    ``quarantine_ledger`` names, and the run completes."""
    faultinject.reset_io_faults()
    monkeypatch.setenv("SAT_FI_BAD_CAPTION_AT", "3")
    ledger = str(tmp_path / "ledger" / "q.jsonl")
    config = port_config(coco_fixture, str(tmp_path), quarantine_ledger=ledger, save_period=0)
    assert runtime.train(config, device="cpu").step == 6
    with open(ledger) as f:
        lines = [json.loads(line) for line in f]
    assert [(e["reason"], e["kind"], e["pos"]) for e in lines] == [("caption_all_oov", "caption", [0, 0, 2])]
    assert not os.path.exists(os.path.join(config.summary_dir, "quarantine.jsonl"))


def test_quarantine_max_fraction_trips_the_ceiling(tmp_path, monkeypatch):
    """A fixture of 32 images, a quarter of them undecodable
    (``SAT_FI_BAD_IMAGE_EVERY=4``): under the default ceiling (half the
    rows seen) 8 steps train on substituted rows; at 0.25 the eighth
    quarantined file trips it and the CLI exits 87."""
    from tests.fixtures import make_coco_fixture

    fixture = make_coco_fixture(str(tmp_path / "coco"), num_images=32)
    monkeypatch.setenv("SAT_FI_BAD_IMAGE_EVERY", "4")
    config = port_config(fixture, str(tmp_path / "half"), max_steps=8, save_period=0)
    assert runtime.train(config, device="cpu").step == 8
    real = runtime.resolve_device
    monkeypatch.setattr(runtime, "resolve_device", lambda device=None: real("cpu"))
    path = str(tmp_path / "train.json")
    port_config(fixture, str(tmp_path / "quarter"), max_steps=8, save_period=0, phase="train",
                quarantine_max_fraction=0.25).save(path)
    assert cli.main(["--config", path]) == 87
    with open(os.path.join(str(tmp_path / "quarter"), "summary", "quarantine.jsonl")) as f:
        assert len(f.readlines()) == 8


def test_rng_impl_is_accepted_and_does_not_change_the_run(coco_fixture, tmp_path):
    """``rng_impl`` picks a JAX bit generator; the port draws with torch's
    and ignores it: the same losses under either value."""
    rows = []
    for impl in ("threefry2x32", "rbg"):
        config = port_config(coco_fixture, str(tmp_path / impl), rng_impl=impl, max_steps=2, save_period=0)
        runtime.train(config, device="cpu")
        with open(os.path.join(config.summary_dir, "metrics.jsonl")) as f:
            rows.append([json.loads(line)["total_loss"] for line in f])
    assert rows[0] == rows[1]


def test_sigterm_stops_at_a_step_boundary_and_saves(coco_fixture, tmp_path, monkeypatch):
    """A SIGTERM during step 2: the loop finishes that step, stops at the
    boundary, saves and verifies the final checkpoint, and returns."""
    import signal

    real = step_mod.make_train_step

    def signalling(config):
        step = real(config)

        def run(state, batch, generator):
            if state.step == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            return step(state, batch, generator)

        return run

    monkeypatch.setattr(runtime, "make_train_step", signalling)
    config = port_config(coco_fixture, str(tmp_path), save_period=0)
    state = runtime.train(config, device="cpu")
    assert state.step == 2
    assert lineage.checkpoint_steps(config.save_dir) == [2]
    assert lineage.last_good_step(config.save_dir) == 2
    assert signal.getsignal(signal.SIGTERM) is not None  # the previous handler is back


def test_restore_that_loads_nothing_is_an_error(coco_fixture, tmp_path):
    config = port_config(coco_fixture, str(tmp_path))
    path = tmp_path / "empty.npz"
    np.savez(path, global_step=np.asarray(5, np.int32), unrelated=np.zeros(3))
    with pytest.raises(ValueError, match="restored 0 tensors"):
        runtime.setup_train_state(config, model_file=str(path), device="cpu")


def test_variable_stats_match_numpy(tmp_path):
    """Per-variable mean/std/min/max rows in metrics.jsonl and one
    histogram event, reduced by torch, equal numpy's."""
    from sat_tpu_torch.utils.summary import SummaryWriter

    rng = np.random.default_rng(0)
    tree = {"decoder": {"fc": {"kernel": torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32))},
                        "emb": {"weights": torch.from_numpy(rng.normal(size=(7,)).astype(np.float32))}}}
    with SummaryWriter(str(tmp_path)) as writer:
        writer.variable_stats(4, tree)
    with open(tmp_path / "metrics.jsonl") as f:
        (row,) = [json.loads(line) for line in f]
    assert row["step"] == 4
    for name, t in (("params/decoder/fc/kernel", tree["decoder"]["fc"]["kernel"]),
                    ("params/decoder/emb/weights", tree["decoder"]["emb"]["weights"])):
        x = t.numpy().astype(np.float64)
        for stat, want in (("mean", x.mean()), ("std", x.std()), ("min", x.min()), ("max", x.max())):
            np.testing.assert_allclose(row[f"{name}/{stat}"], want, rtol=1e-5, err_msg=stat)


def test_watchdog_escalates_to_abort_on_a_wedged_phase():
    """A phase that completed once, then stays open past its deadline:
    warning, stack dump, then the pre-abort hook and the abort with
    exit code 86; a phase that completes stands the watchdog down."""
    from sat_tpu_torch.resilience.watchdog import WATCHDOG_EXIT_CODE, Watchdog

    now = [0.0]
    calls = []
    wd = Watchdog({"dispatch": 10.0}, grace_s=1.0, pre_abort=lambda: calls.append("flush"),
                  abort=lambda code: calls.append(code)).use_clock(lambda: now[0])
    with wd.phase("dispatch"):
        pass
    guard = wd.phase("dispatch")
    guard.__enter__()
    now[0] = 11.0
    wd.check()
    assert wd.stalled_phase == "dispatch" and calls == []
    wd.check()
    now[0] = 13.0
    wd.check()
    assert calls == ["flush", WATCHDOG_EXIT_CODE]
    guard.__exit__(None, None, None)
    wd.check()
    assert wd.stalled_phase is None


def test_retention_keeps_the_newest_and_last_good(coco_fixture, tmp_path):
    """``keep_checkpoints=1``: each save deletes older checkpoints and
    their sidecars, keeping the newest and the LAST_GOOD target."""
    config = port_config(coco_fixture, str(tmp_path), save_period=2, keep_checkpoints=1)
    runtime.train(config, device="cpu")
    assert lineage.checkpoint_steps(config.save_dir) == [6]
    assert sorted(os.listdir(config.save_dir)) == ["6.npz", "6.npz.sha256", "LAST_GOOD", "config.json"]


def test_fault_plan_reads_the_jax_knobs_and_poisons_a_port_state(trained):
    """The port's ``FaultPlan`` reads the same ``SAT_FI_*`` knobs as the
    JAX package's; ``maybe_poison`` turns a train state's params and the
    metrics to NaN at its step, once."""
    import dataclasses

    from sat_tpu.resilience.faultinject import FaultPlan as JaxFaultPlan

    env = {"SAT_FI_DIE_AT_STEP": "5", "SAT_FI_NAN_AT_STEP": "2", "SAT_FI_CORRUPT_SHARD_ROW": "3",
           "SAT_FI_BAD_IMAGE_EVERY": "7", "SAT_FI_SLOW_STEP_MS": "1"}
    plan = faultinject.FaultPlan.from_env(env)
    assert dataclasses.asdict(plan) == dataclasses.asdict(JaxFaultPlan.from_env(env))
    _, state = trained
    metrics = {"total_loss": torch.tensor(1.0)}
    assert plan.maybe_poison(1, state, metrics) == (state, metrics)
    poisoned, bad = plan.maybe_poison(2, state, metrics)
    leaves = [poisoned.params["decoder"]]
    while leaves:
        x = leaves.pop()
        if isinstance(x, dict):
            leaves += list(x.values())
        else:
            assert torch.isnan(x).all()
    assert torch.isnan(bad["total_loss"]) and poisoned.step == state.step
    assert plan.maybe_poison(2, state, metrics) == (state, metrics)
    with pytest.raises(faultinject.SimulatedPreemption):
        plan.maybe_kill(5)
