"""The train layer's run-health metrics, held to sat_tpu's on the same
fixture and the same faults: ``sentinel/anomalies`` and
``sentinel/rollbacks`` (a NaN step under ``anomaly_policy=rollback``, and
a rollback budget spent), ``ckpt/walkbacks`` (a rotten newest checkpoint
before a resume) and the ``data/epoch`` gauge with the heartbeat's and a
quarantine record's ``epoch`` (a second epoch and a poisoned caption).

Both packages train the small model of ``tests/test_runtime.py`` on the
session ``coco_fixture`` (24 captions, 6 steps an epoch at batch 4), each
under its own telemetry registry, and the counter and gauge values must
be equal."""

import json
import os

import numpy as np
import pytest
import torch

from sat_tpu import runtime as jrt
from sat_tpu import telemetry as jtel
from sat_tpu.resilience import sentinel as jsentinel
from sat_tpu.train.checkpoint import restore_checkpoint as jax_restore_checkpoint
from sat_tpu.train.step import create_train_state as jax_create_train_state
from sat_tpu_torch import runtime, telemetry
from sat_tpu_torch.resilience import sentinel
from sat_tpu_torch.resilience.faultinject import SimulatedPreemption
from sat_tpu_torch.resilience.quarantine import ledger_path_for
from sat_tpu_torch.train.checkpoint import restore_checkpoint
from tests.test_torch_train_loop import jax_config, port_config

torch.set_num_threads(2)

TRAIN_METRICS = ("sentinel/anomalies", "sentinel/rollbacks", "ckpt/walkbacks")


@pytest.fixture(autouse=True)
def _registries():
    """Each test leaves both process-global registries as it found them."""
    yield
    telemetry.disable()
    jtel.disable()


def _counts(tel) -> dict:
    counters = tel.counters()
    return {name: counters.get(name, 0) for name in TRAIN_METRICS}


def _both_train(config, monkeypatch, env):
    """sat_tpu's and the port's train of ``config`` (each into its own
    directories) under the ``SAT_FI_*`` knobs in ``env``; returns
    ((jax config, counters, gauges), (port config, counters, gauges)),
    the values read from each package's registry after its run."""
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    out = []
    for name in ("jax", "port"):
        cfg = config.replace(**{
            key: os.path.join(getattr(config, key), name)
            for key in ("save_dir", "summary_dir")
        })
        if name == "jax":
            jc = jax_config(cfg)
            jrt.train(jc)
            tel = jtel.get()
            out.append((jc, _counts(tel), dict(tel.gauges())))
        else:
            runtime.train(cfg, device="cpu")
            tel = telemetry.get()
            out.append((cfg, _counts(tel), dict(tel.gauges())))
    return out


def test_nan_step_under_rollback_counts_one_anomaly_and_one_rollback(coco_fixture, tmp_path, monkeypatch):
    """SAT_FI_NAN_AT_STEP=5 under ``anomaly_policy=rollback``: both packages
    count one anomaly and one granted rollback, and walk back nothing (the
    rollback restores LAST_GOOD by name)."""
    config = port_config(coco_fixture, str(tmp_path), anomaly_policy="rollback", save_period=2, telemetry=True)
    (_, jax_counts, _), (_, port_counts, _) = _both_train(config, monkeypatch, {"SAT_FI_NAN_AT_STEP": "5"})
    assert jax_counts == {"sentinel/anomalies": 1, "sentinel/rollbacks": 1, "ckpt/walkbacks": 0}
    assert port_counts == jax_counts


def test_spent_rollback_budget_counts_anomalies_but_no_rollback():
    """NaN metrics at more log boundaries than the rollback budget: every
    one is an anomaly in both packages, only the granted rollbacks are
    counted, and the ones past the budget degrade to ``warn`` uncounted."""
    assert sentinel.MAX_ROLLBACKS == jsentinel.MAX_ROLLBACKS
    jtel.enable()
    telemetry.enable()
    jax_s = jsentinel.AnomalySentinel("rollback")
    port_s = sentinel.AnomalySentinel("rollback")
    metrics = [{"loss": 1.0}, {"loss": float("nan")}, {"loss": float("inf")}, {"loss": 2.0},
               {"loss": float("nan")}, {"loss": float("nan")}, {"loss": float("nan")}]
    actions = [(jax_s.check(step, m), port_s.check(step, m)) for step, m in enumerate(metrics, 1)]
    assert [j for j, _ in actions] == ["ok", "rollback", "rollback", "ok", "rollback", "warn", "warn"]
    assert [p for _, p in actions] == [j for j, _ in actions]
    want = {"sentinel/anomalies": 5, "sentinel/rollbacks": 3, "ckpt/walkbacks": 0}
    assert _counts(jtel.get()) == want
    assert _counts(telemetry.get()) == want


def test_rotten_newest_checkpoint_counts_one_walkback(coco_fixture, tmp_path, monkeypatch):
    """A run saves 2 and 4, the byte flip of SAT_FI_CORRUPT_CKPT_STEP=4
    rots 4.npz and SAT_FI_DIE_AT_STEP=5 preempts it; the resume walks back
    past 4.npz to 2.npz and counts one ``ckpt/walkbacks`` in both
    packages."""
    config = port_config(coco_fixture, str(tmp_path), save_period=2)
    monkeypatch.setenv("SAT_FI_CORRUPT_CKPT_STEP", "4")
    monkeypatch.setenv("SAT_FI_DIE_AT_STEP", "5")
    jc = jax_config(config.replace(save_dir=str(tmp_path / "jax")))
    pc = config.replace(save_dir=str(tmp_path / "port"))
    with pytest.raises(Exception, match="preempt|Preempt"):
        jrt.train(jc)
    with pytest.raises(SimulatedPreemption):
        runtime.train(pc, device="cpu")
    for d in (jc.save_dir, pc.save_dir):
        assert sorted(f for f in os.listdir(d) if f.endswith(".npz")) == ["2.npz", "4.npz"]
    monkeypatch.delenv("SAT_FI_CORRUPT_CKPT_STEP")
    monkeypatch.delenv("SAT_FI_DIE_AT_STEP")

    import jax

    jax_tel = jtel.enable()
    restored, _ = jax_restore_checkpoint(jax_create_train_state(jax.random.PRNGKey(0), jc), save_dir=jc.save_dir)
    assert int(restored.step) == 2
    port_tel = telemetry.enable()
    state = runtime.setup_train_state(pc, device="cpu")
    restored, _ = restore_checkpoint(state, save_dir=pc.save_dir)
    assert int(restored.step) == 2
    assert _counts(jax_tel)["ckpt/walkbacks"] == _counts(port_tel)["ckpt/walkbacks"] == 1


def test_epoch_gauge_heartbeat_and_quarantine_record_carry_the_epoch(coco_fixture, tmp_path, monkeypatch):
    """Two epochs with the 30th caption row poisoned (SAT_FI_BAD_CAPTION_AT,
    in the second epoch): ``data/epoch`` ends at 1 in both packages, the
    final heartbeat's ``epoch`` is 1 in both, and the quarantine record of
    the poisoned row carries the epoch (and step) sat_tpu's carries."""
    config = port_config(coco_fixture, str(tmp_path), num_epochs=2, save_period=0, telemetry=True,
                         heartbeat_interval=0.05)
    (jc, _, jax_gauges), (pc, _, port_gauges) = _both_train(config, monkeypatch, {"SAT_FI_BAD_CAPTION_AT": "30"})
    assert jax_gauges["data/epoch"] == port_gauges["data/epoch"] == 1

    beats = []
    for cfg in (jc, pc):
        with open(os.path.join(cfg.summary_dir, "telemetry", "heartbeat.json")) as f:
            beats.append(json.load(f))
    assert beats[0]["epoch"] == beats[1]["epoch"] == 1

    records = []
    for cfg in (jc, pc):
        with open(ledger_path_for(cfg)) as f:
            records.append([json.loads(line) for line in f if line.strip()])
    assert len(records[0]) == len(records[1]) == 1
    jax_rec, port_rec = records[0][0], records[1][0]
    assert port_rec["epoch"] is not None
    assert (port_rec["kind"], port_rec["epoch"], port_rec["step"]) == (jax_rec["kind"], jax_rec["epoch"],
                                                                       jax_rec["step"])
    assert np.isfinite(port_rec["epoch"])
