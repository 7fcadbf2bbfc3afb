"""The port's model lifecycle held to sat_tpu's on the CPU: the canary
hash, the rejection ledger and the controller's state machine on stub
engines; the loader's guards and the engine's compatibility gate; and,
end to end on one float32 checkpoint in both serve modes, reload →
canary → promote and reload → rollback giving sat_tpu's states, slots
and model steps per request id, the canary captioning as sat_tpu's
candidate does."""

import json
import os
import time

import numpy as np
import pytest
import torch

from sat_tpu_torch.lifecycle import canary
from sat_tpu_torch.resilience import lineage
from tests.torch_planes_helpers import (
    boot, caption, close_beams, get_json, http, jax_engine, port_engine, registries, stage_candidate, world,
)

torch.set_num_threads(2)


def test_assign_slot_matches_jax():
    """10,000 request ids at 5 canary fractions: the same slot as
    sat_tpu's hash, sticky and monotone in the fraction."""
    from sat_tpu.lifecycle import canary as jax_canary

    ids = [f"req-{i:05d}-{i * 7919 % 10007}" for i in range(10_000)]
    for fraction in (0.0, 0.1, 0.25, 0.5, 1.0):
        ours = [canary.assign_slot(rid, fraction) for rid in ids]
        assert ours == [jax_canary.assign_slot(rid, fraction) for rid in ids]
        share = ours.count(canary.CANARY) / len(ids)
        assert abs(share - fraction) < 0.02
    assert canary.assign_slot(None, 0.5) == canary.INCUMBENT


def test_rejection_ledger_crosses_packages(tmp_path):
    """A step rejected by either package is rejected for the other,
    exactly once, past a torn tail line."""
    from sat_tpu.resilience import lineage as jax_lineage

    save_dir = str(tmp_path)
    assert lineage.mark_rejected(save_dir, 5, "canary burn") is True
    assert jax_lineage.is_rejected(save_dir, 5) and not jax_lineage.mark_rejected(save_dir, 5, "again")
    with open(os.path.join(save_dir, lineage.REJECTED_NAME), "a") as f:
        f.write('{"step": 9, "rea')  # a crashed append
    assert jax_lineage.mark_rejected(save_dir, 7, "vocab") is True
    assert lineage.rejected_steps(save_dir) == jax_lineage.rejected_steps(save_dir) == {5, 7}
    assert lineage.mark_rejected(save_dir, 8, "shape") and jax_lineage.is_rejected(save_dir, 8)


class _Engine:
    def __init__(self):
        self.step, self.candidate_step, self.encoder_quant = 10, None, "off"

    def install_candidate(self, variables, decoder_params, step, source):
        self.candidate_step = int(step)

    def promote_candidate(self):
        self.step, self.candidate_step = self.candidate_step, None
        return self.step

    def clear_candidate(self):
        self.candidate_step = None


class _Batcher:
    def __init__(self, engine):
        self.engine, self.calls = engine, []

    def lifecycle_control(self, action, timeout=120.0):
        self.calls.append(action)
        if action == "swap":
            return {"step": self.engine.promote_candidate(), "blackout_ms": 1.25}
        return {"ok": True}

    def submit(self, image, **kw):
        raise RuntimeError("no shadow traffic here")


def _run_machine(pkg, tmp_path, monkeypatch, verdict, policy):
    """One cycle of ``pkg``'s controller on stubs: (batcher calls, final
    engine step, last_cycle outcome, ledger)."""
    if pkg == "jax":
        from sat_tpu.config import Config
        from sat_tpu.lifecycle import controller as mod
        from sat_tpu.resilience import lineage as lin
    else:
        from sat_tpu_torch.config import Config
        from sat_tpu_torch.lifecycle import controller as mod
        lin = lineage
    save_dir = str(tmp_path / pkg)
    os.makedirs(save_dir)
    config = Config(save_dir=save_dir, canary_window_s=0.2, promote_policy=policy, canary_shadow_rate=0.0)
    monkeypatch.setattr(mod, "load_candidate", lambda engine, cfg, path: {
        "variables": {}, "decoder_params": {}, "step": 11, "source": path})
    engine = _Engine()
    batcher = _Batcher(engine)
    ctl = mod.LifecycleController(config, engine, batcher)
    assert ctl.begin_cycle(11, "/ckpt/11.npz") and not ctl.begin_cycle(12, "/ckpt/12.npz")
    if verdict is not None:
        deadline = time.monotonic() + 30
        while ctl.state != "CANARY" and time.monotonic() < deadline:
            time.sleep(0.01)
        ok, _ = getattr(ctl, verdict)()
        assert ok
    assert ctl._cycle_done.wait(timeout=30.0)
    last = ctl.snapshot()["last_cycle"]
    return batcher.calls, engine.step, ctl.state, last["outcome"], sorted(lin.rejected_steps(save_dir))


@pytest.mark.parametrize("verdict,policy", [(None, "auto"), ("promote", "manual"), ("rollback", "manual")])
def test_controller_machine_matches_jax(tmp_path, monkeypatch, verdict, policy):
    """The port's copy of the controller walks sat_tpu's state machine:
    the same batcher commands, serving step, outcome and ledger for an
    auto-promote, an operator promote and an operator rollback."""
    got = {pkg: _run_machine(pkg, tmp_path, monkeypatch, verdict, policy) for pkg in ("jax", "torch")}
    assert got["torch"] == got["jax"]


@pytest.fixture(scope="module")
def guarded(tmp_path_factory):
    w = world(tmp_path_factory.mktemp("loader"))
    with registries():
        engine = port_engine(w["tc"])
    w["engine"] = engine
    return w


def _copy_checkpoint(w, name, edit):
    src = lineage.last_good_checkpoint(w["tc"].save_dir)
    with np.load(src) as z:
        flat = {k: z[k] for k in z.files}
    edit(flat)
    path = os.path.join(w["root"], name)
    np.savez(path, **flat)
    return path


@pytest.mark.parametrize("case", ["vocab", "partial", "shape", "rot"])
def test_loader_refuses_what_jax_refuses(guarded, case):
    """A candidate with another vocabulary, a missing decoder tensor, a
    tensor of another shape or a rotted file: the port's loader raises
    before any device work, as sat_tpu's does on the same file."""
    from sat_tpu.lifecycle.loader import load_candidate as jax_load_candidate
    from sat_tpu.resilience import lineage as jax_lineage
    from sat_tpu_torch.lifecycle.loader import load_candidate

    w = guarded
    name = "params/decoder/attend/fc_1a/kernel"

    def edit(flat):
        if case == "partial":
            del flat[name]
        elif case == "shape":
            flat[name] = flat[name][:-1]

    path = _copy_checkpoint(w, f"{case}.npz", edit)
    vocab = {"sha256": "0" * 64, "size": 7} if case == "vocab" else None
    if vocab is None:
        from sat_tpu.data.vocabulary import vocab_fingerprint

        vocab = vocab_fingerprint(w["jc"].vocabulary_file, w["jc"].vocabulary_size)
    jax_lineage.write_sidecar(path, vocab=vocab)
    if case == "rot":
        with open(path, "r+b") as f:
            f.seek(200)
            f.write(b"\x00" * 8)
    with pytest.raises(Exception) as ours:
        load_candidate(w["engine"], w["tc"], path)
    from sat_tpu.data.vocabulary import Vocabulary as JaxVocabulary
    from sat_tpu.serve.engine import ServeEngine as JaxEngine
    from sat_tpu.serve.engine import load_serving_state as jax_load

    jengine = JaxEngine(w["jc"], jax_load(w["jc"])[0], JaxVocabulary(w["jc"].vocabulary_size, w["jc"].vocabulary_file))
    with pytest.raises(Exception) as theirs:
        jax_load_candidate(jengine, w["jc"], path)
    assert type(ours.value).__name__ == type(theirs.value).__name__
    assert w["engine"].candidate_step is None


def test_validate_compat_refuses_drift(guarded):
    """The slot gate: another key set, shape, dtype or device raises; the
    incumbent's own set passes."""
    engine = guarded["engine"]
    params = engine.slot_variables()
    engine._validate_compat(params, "self")

    def swap(path, value):
        out = {k: (dict(v) if isinstance(v, dict) else v) for k, v in params.items()}
        node = out
        for key in path[:-1]:
            node[key] = dict(node[key])
            node = node[key]
        node[path[-1]] = value
        return out

    leaf = ("decoder", "attend", "fc_1a", "kernel")
    t = params["decoder"]["attend"]["fc_1a"]["kernel"]
    for bad, match in ((swap(leaf, t[:-1]), "geometry drift"), (swap(leaf, t.double()), "geometry drift"),
                       (swap(leaf, t.to("meta")), "geometry drift"),
                       (swap(("decoder", "extra"), t), "key set differs")):
        with pytest.raises(ValueError, match=match):
            engine.install_candidate(bad, bad["decoder"], 9, "drifted")
    assert engine.candidate_step is None


def _ids(fraction, n=2):
    inc, can, i = [], [], 0
    while len(inc) < n or len(can) < n:
        rid = f"lc-{i}"
        i += 1
        (can if canary.assign_slot(rid, fraction) == canary.CANARY else inc).append(rid)
    return inc[:n], can[:n]


def _wait_state(port, want, limit_s=60.0):
    deadline = time.monotonic() + limit_s
    while time.monotonic() < deadline:
        if get_json(port, "/stats")[1]["lifecycle"]["state"] == want:
            return
        time.sleep(0.02)
    raise AssertionError(f"never reached {want}: {get_json(port, '/stats')[1]['lifecycle']}")


def _cycle(pkg, w, mode, tmp_path):
    """reload → canary → promote, then reload → rollback, through
    ``pkg``'s server; returns the record of every reply."""
    cfg = w["jc" if pkg == "jax" else "tc"].replace(
        serve_mode=mode, promote_policy="manual", canary_fraction=0.5, canary_window_s=600.0,
        canary_shadow_rate=0.0, model_reload=0.0, telemetry_dir=str(tmp_path / f"t_{pkg}"))
    inc, can = _ids(cfg.canary_fraction)
    record, canary_replies = [], []
    server = boot(pkg, cfg, jax_engine(cfg) if pkg == "jax" else port_engine(cfg))
    try:
        def requests(tag):
            for j, rid in enumerate(inc + can):
                status, reply, _ = caption(server.port, w["jpegs"][j], {"X-Request-Id": rid})
                record.append((tag, rid, status, reply.get("slot"), reply.get("model_step")))
                if tag == "canary" and reply.get("slot") == "canary":
                    canary_replies.append(reply)

        def admin(verb):
            status, _, raw = http(server.port, "POST", f"/{verb}")
            body = json.loads(raw)
            record.append((verb, status, body["ok"], body["state"], body["model_step"]))

        requests("idle")
        stage_candidate(cfg, 1005, seed=1)
        admin("reload")
        _wait_state(server.port, "CANARY")
        hz = get_json(server.port, "/healthz")[1]
        record.append(("healthz", hz["lifecycle_state"], hz.get("candidate_step")))
        requests("canary")
        if pkg == "torch" and mode == "continuous":
            clone = server.batcher._canary_pool
            # the canary runs on a pool cloned over the one engine
            assert clone is not server.pool and clone.engine is server.engine and clone.param_slot == "canary"
        admin("promote")
        requests("promoted")
        stage_candidate(cfg, 1010, seed=2)
        admin("reload")
        _wait_state(server.port, "CANARY")
        requests("canary2")
        admin("rollback")
        requests("rolled_back")
        admin("reload")
        record.append(("rejected", sorted(lineage.rejected_steps(cfg.save_dir))))
    finally:
        server.shutdown()
    return record, canary_replies


@pytest.mark.parametrize("mode", ["batch", "continuous"])
def test_reload_canary_promote_rollback_matches_jax(tmp_path, mode):
    """Both packages' servers, each on its own copy of one checkpoint and
    the same staged candidates, through the same cycle: every reply's
    status, slot and model step, every admin verb's answer and the ledger
    are sat_tpu's, and the canary captions as sat_tpu's candidate does."""
    out = {}
    with registries():
        for pkg in ("jax", "torch"):
            (tmp_path / pkg).mkdir()
            out[pkg] = _cycle(pkg, world(tmp_path / pkg), mode, tmp_path)
    (record, canaries), (jrecord, jcanaries) = out["torch"], out["jax"]
    assert record == jrecord
    assert ("promote", 200, True, "IDLE", 1005) in record and ("rollback", 200, True, "IDLE", 1005) in record
    assert ("healthz", "CANARY", 1005) in record and ("rejected", [1010]) in record
    assert record[-2][:2] == ("reload", 409)
    assert {r[3:] for r in record if r[0] == "canary"} == {("incumbent", 5), ("canary", 1005)}
    assert len(canaries) == len(jcanaries) == 2
    for ours, theirs in zip(canaries, jcanaries):
        close_beams(ours, theirs)
