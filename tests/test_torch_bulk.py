"""The port's ``--phase bulk`` held against sat_tpu's on the CPU, and against
itself across kills.

One corpus: the fixture's 12 training JPEGs, one file that is not a JPEG
(``zz_broken.jpg``) and a README (skipped), in output shards of 5 rows
(5 + 5 + 3); the small model at float32, beam 2, a 2 × 2 slot pool, one
checkpoint from ``sat_tpu.runtime.create_train_state`` whose terminator
bias is lowered by 2 (so captions run full length).  Against JAX: the
same shard names, row counts, files, caption strings and quarantine
markers, ``log_prob`` within 1e-5 absolute and ``prob`` within 1e-5
relative, the same ledger line.  Against itself: every resume, replay
and repeated run bitwise.
"""

import json
import os
import shutil

import jax
import pytest
import torch

from sat_tpu import runtime as jrt
from sat_tpu import telemetry as jax_telemetry
from sat_tpu.bulk.runner import run_bulk as jax_run_bulk
from sat_tpu.data import dataset as jax_dataset
from sat_tpu.train.checkpoint import save_checkpoint
from sat_tpu_torch import cli, telemetry
from sat_tpu_torch.bulk import runner
from sat_tpu_torch.bulk.manifest import corpus_fingerprint, load_manifest, manifest_path_for, write_manifest
from sat_tpu_torch.bulk.writer import shard_filename, sidecar_path, verify_shard
from sat_tpu_torch.bulk.corpus import resolve_corpus
from sat_tpu_torch.data.images import ImageLoader
from sat_tpu_torch.resilience.faultinject import SimulatedPreemption
from sat_tpu_torch.resilience.quarantine import SystemicCorruption
from tests.torch_port_helpers import configs

torch.set_num_threads(2)

BROKEN = "zz_broken.jpg"


@pytest.fixture(scope="module")
def world(coco_fixture, tmp_path_factory):
    """The corpus, the checkpoint, and each package's completed run."""
    root = str(tmp_path_factory.mktemp("torch_bulk"))
    corpus = os.path.join(root, "corpus")
    shutil.copytree(coco_fixture["train_img_dir"], corpus)
    with open(os.path.join(corpus, BROKEN), "wb") as f:
        f.write(b"not a jpeg")
    with open(os.path.join(corpus, "README.txt"), "w") as f:
        f.write("not an image\n")
    c = coco_fixture["config"]
    settings = dict(
        phase="bulk", train_caption_file=c.train_caption_file, max_train_ann_num=None,
        vocabulary_file=os.path.join(root, "vocabulary.csv"), save_dir=os.path.join(root, "models"),
        summary_dir=os.path.join(root, "summary"), temp_annotation_file=os.path.join(root, "anns.csv"),
        temp_data_file=os.path.join(root, "data.npy"), max_caption_length=12, beam_size=2,
        serve_slot_pages=2, serve_page_width=2, shard_cache="off", heartbeat_interval=0.0,
        num_data_workers=2, bulk_input=corpus, bulk_shard_rows=5,
    )
    jc, tc = configs(**settings)
    vocab = jax_dataset.build_vocabulary(jc)
    state = jax.jit(jrt.create_train_state, static_argnums=1)(jax.random.PRNGKey(0), jc)
    fc_2 = state.params["decoder"]["decode"]["fc_2"]
    fc_2 = {**fc_2, "bias": fc_2["bias"].at[vocab.word2idx["."]].add(-2.0)}
    decoder = {**state.params["decoder"], "decode": {**state.params["decoder"]["decode"], "fc_2": fc_2}}
    path = save_checkpoint(state._replace(params={**state.params, "decoder": decoder}), jc)

    def cfg(name, **kw):
        out = dict(bulk_output=os.path.join(root, name), quarantine_ledger=os.path.join(root, name + ".jsonl"))
        return tc.replace(**{**out, **kw})

    try:
        jcfg = jc.replace(bulk_output=os.path.join(root, "jax"), quarantine_ledger=os.path.join(root, "jax.jsonl"))
        assert jax_run_bulk(jcfg, model_file=path) == 0
    finally:
        jax_telemetry.disable()
    w = {"root": root, "path": path, "cfg": cfg, "jax": jcfg}
    w["port"] = cfg("port")
    try:
        assert runner.run_bulk(w["port"], model_file=path, device="cpu") == 0
        w["gauges"] = telemetry.get().gauges()
    finally:
        telemetry.disable()
    return w


@pytest.fixture
def bulk(world):
    """``run_bulk`` on the CPU with the world's checkpoint; the telemetry
    registry it enables is switched off again afterwards."""

    def run(config):
        return runner.run_bulk(config, model_file=world["path"], device="cpu")

    yield run
    telemetry.disable()


def outputs(out_dir):
    return {
        f: open(os.path.join(out_dir, f), "rb").read()
        for f in sorted(os.listdir(out_dir))
        if f.startswith("captions_") and not f.endswith(".tmp")
    }


def rows(out_dir):
    return [
        json.loads(line)
        for name, blob in outputs(out_dir).items() if name.endswith(".jsonl")
        for line in blob.decode().splitlines()
    ]


def ledger(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def clone(world, name):
    """An output directory seeded with the port's completed run."""
    dst = os.path.join(world["root"], name)
    shutil.copytree(world["port"].bulk_output, dst)
    return world["cfg"](name)


def test_bulk_matches_jax_at_float32(world):
    jax_out, port_out = outputs(world["jax"].bulk_output), outputs(world["port"].bulk_output)
    assert list(jax_out) == list(port_out) == [
        f"{shard_filename(i)}{ext}" for i in range(3) for ext in ("", ".crc32c")
    ]
    for name in jax_out:
        if name.endswith(".crc32c"):
            assert json.loads(jax_out[name])["rows"] == json.loads(port_out[name])["rows"]
    jrows, trows = rows(world["jax"].bulk_output), rows(world["port"].bulk_output)
    assert [r["file"] for r in trows] == resolve_corpus(world["port"].bulk_input)
    assert len(trows) == 13
    for a, b in zip(jrows, trows):
        assert set(a) == set(b)
        assert (a["file"], a.get("quarantined"), a.get("substituted_from")) == (
            b["file"], b.get("quarantined"), b.get("substituted_from"))
        assert [c["caption"] for c in a["captions"]] == [c["caption"] for c in b["captions"]]
        assert len(b["captions"]) == 2
        for x, y in zip(a["captions"], b["captions"]):
            assert y["log_prob"] == pytest.approx(x["log_prob"], abs=1e-5, rel=0)
            assert y["prob"] == pytest.approx(x["prob"], rel=1e-5, abs=0)
    marked = [r for r in trows if r.get("quarantined")]
    assert [os.path.basename(r["file"]) for r in marked] == [BROKEN]
    keys = ("file", "reason", "kind", "sha", "error")
    jl, tl = ledger(world["jax"].quarantine_ledger), ledger(world["port"].quarantine_ledger)
    assert [{k: e[k] for k in keys} for e in tl] == [{k: e[k] for k in keys} for e in jl]
    assert tl[0]["reason"] == "decode_failed" and tl[0]["kind"] == "image"


def test_port_skips_the_shards_jax_committed(world, bulk):
    """The manifest and sidecar formats are shared: the port verifies the
    JAX package's committed shards and skips them; a missing one it
    decodes itself."""
    config = world["cfg"]("from_jax")
    shutil.copytree(world["jax"].bulk_output, config.bulk_output)
    before = outputs(config.bulk_output)
    assert bulk(config) == 0
    assert outputs(config.bulk_output) == before
    shard = os.path.join(config.bulk_output, shard_filename(1))
    os.unlink(shard)
    assert bulk(config) == 0
    after = outputs(config.bulk_output)
    assert after[shard_filename(1)] == outputs(world["port"].bulk_output)[shard_filename(1)]
    assert {k: v for k, v in after.items() if "00001" not in k} == {
        k: v for k, v in before.items() if "00001" not in k}


def test_bulk_gauges(world):
    g = world["gauges"]
    assert g["bulk/images_done"] == g["bulk/images_total"] == 13
    assert g["bulk/shards_done"] == g["bulk/shards_total"] == 3
    assert g["bulk/quarantined"] == 1 and g["bulk/decode_steps"] > 0
    assert g["bulk/captions_per_s"] > 0 and g["bulk/device_ms_per_image"] > 0
    assert "bulk/steady_compiles" not in g


def test_resume_noop_leaves_outputs_untouched(world, bulk, capsys):
    config = clone(world, "noop")
    before = outputs(config.bulk_output)
    mtimes = {f: os.stat(os.path.join(config.bulk_output, f)).st_mtime_ns for f in before}
    assert bulk(config) == 0
    assert "nothing to do" in capsys.readouterr().err
    assert outputs(config.bulk_output) == before
    assert {f: os.stat(os.path.join(config.bulk_output, f)).st_mtime_ns for f in before} == mtimes


def test_resume_after_kill_between_shards_is_bitwise(world, bulk):
    config = clone(world, "between")
    mpath = manifest_path_for(config.bulk_output)
    m = load_manifest(mpath)
    for k in [k for k in m["completed"] if k != "0"]:
        shard = os.path.join(config.bulk_output, m["completed"].pop(k)["file"])
        os.unlink(shard)
        os.unlink(sidecar_path(shard))
    write_manifest(mpath, m)
    assert bulk(config) == 0
    assert outputs(config.bulk_output) == outputs(world["port"].bulk_output)


def test_resume_after_kill_mid_shard_is_bitwise(world, bulk):
    """A torn ``.tmp`` of shard 1 and no committed file: the relaunch
    deletes the orphan and re-decodes shard 1 from its first row."""
    config = clone(world, "mid_tmp")
    mpath = manifest_path_for(config.bulk_output)
    m = load_manifest(mpath)
    shard = os.path.join(config.bulk_output, m["completed"].pop("1")["file"])
    os.unlink(sidecar_path(shard))
    os.rename(shard, shard + ".tmp")
    with open(shard + ".tmp", "ab") as f:
        f.write(b'{"torn')
    write_manifest(mpath, m)
    assert bulk(config) == 0
    assert outputs(config.bulk_output) == outputs(world["port"].bulk_output)
    assert not os.path.exists(shard + ".tmp")


def test_injected_preemption_mid_shard_resumes_bitwise(world, bulk, monkeypatch):
    """``SAT_FI_DIE_AT_STEP`` at half the control run's decode steps: the
    kill lands inside a shard, the relaunch finishes bitwise the
    uninterrupted run."""
    half = world["gauges"]["bulk/decode_steps"] // 2
    config = world["cfg"]("killed")
    monkeypatch.setenv("SAT_FI_DIE_AT_STEP", str(half))
    with pytest.raises(SimulatedPreemption):
        bulk(config)
    done = load_manifest(manifest_path_for(config.bulk_output))["completed"]
    assert 0 < len(done) < 3
    monkeypatch.delenv("SAT_FI_DIE_AT_STEP")
    assert bulk(config) == 0
    assert outputs(config.bulk_output) == outputs(world["port"].bulk_output)


def test_resume_redecodes_corrupt_committed_shard(world, bulk):
    config = clone(world, "rot")
    shard = os.path.join(config.bulk_output, shard_filename(0))
    data = open(shard, "rb").read()
    with open(shard, "wb") as f:
        f.write(data[:3] + bytes([data[3] ^ 0x40]) + data[4:])
    assert not verify_shard(shard)
    assert bulk(config) == 0
    assert outputs(config.bulk_output) == outputs(world["port"].bulk_output)


def test_corpus_change_restarts_frontier(world, bulk):
    config = clone(world, "refreshed").replace(bulk_shard_rows=7)
    assert bulk(config) == 0
    m = load_manifest(manifest_path_for(config.bulk_output))
    files = resolve_corpus(config.bulk_input)
    assert m["corpus_sha"] == corpus_fingerprint(files, 7, config.image_size)
    assert len(m["completed"]) == 2
    written = []
    for k in sorted(m["completed"], key=int):
        with open(os.path.join(config.bulk_output, m["completed"][k]["file"])) as f:
            written += [json.loads(line)["file"] for line in f]
    assert written == files


def poison(monkeypatch, victims):
    """``ImageLoader.load_raw`` fails for the named corpus files."""
    real = ImageLoader.load_raw

    def load_raw(self, image_file):
        if os.path.basename(image_file) in victims:
            raise ValueError(f"poisoned test image {image_file}")
        return real(self, image_file)

    monkeypatch.setattr(ImageLoader, "load_raw", load_raw)


def test_poisoned_runs_are_bitwise_equal_and_replay_from_the_ledger(world, bulk, monkeypatch):
    files = resolve_corpus(world["port"].bulk_input)
    victim = os.path.basename(files[2])
    poison(monkeypatch, {victim})
    runs = []
    for name in ("poison_a", "poison_b"):
        config = world["cfg"](name)
        assert bulk(config) == 0
        runs.append(outputs(config.bulk_output))
    assert runs[0] == runs[1]
    marked = [r for r in rows(world["cfg"]("poison_a").bulk_output) if r.get("quarantined")]
    assert sorted(os.path.basename(r["file"]) for r in marked) == sorted([victim, BROKEN])
    for r in marked:
        assert set(r) == {"file", "captions", "quarantined", "substituted_from"}
        assert r["substituted_from"] != r["file"]
    # healthy loader, inherited ledger: the ledger alone forces the same
    # substitutions
    monkeypatch.undo()
    config = world["cfg"]("replay", quarantine_ledger=world["cfg"]("poison_a").quarantine_ledger)
    assert bulk(config) == 0
    assert outputs(config.bulk_output) == runs[0]


def test_all_rows_of_a_shard_poisoned_is_systemic(world, bulk, monkeypatch):
    poison(monkeypatch, {os.path.basename(f) for f in resolve_corpus(world["port"].bulk_input)})
    with pytest.raises(SystemicCorruption, match="no healthy row"):
        bulk(world["cfg"]("poison_all"))


def test_cli_bulk_end_to_end_and_exit_87_above_the_ceiling(world, monkeypatch, capsys):
    """``--phase bulk`` through the CLI (its device patched to the CPU):
    the same bytes as the in-process run, then "nothing to do"; with 8 of
    13 images poisoned in one shard the quarantine ceiling (half the rows
    seen) trips and the CLI exits 87."""
    monkeypatch.setattr(runner, "resolve_device", lambda device=None: torch.device("cpu"))
    config = world["cfg"]("cli")
    path = os.path.join(world["root"], "cli.json")
    config.save(path)
    try:
        assert cli.main(["--config", path, "--model_file", world["path"]]) == 0
        assert outputs(config.bulk_output) == outputs(world["port"].bulk_output)
        assert cli.main(["--config", path, "--model_file", world["path"]]) == 0
        assert "nothing to do" in capsys.readouterr().err
        files = resolve_corpus(config.bulk_input)
        poison(monkeypatch, {os.path.basename(f) for f in files[:8]})
        rc = cli.main(["--config", path, "--model_file", world["path"], "--bulk_shard_rows", "13",
                       "--bulk_output", os.path.join(world["root"], "cli87"),
                       "--set", f"quarantine_ledger={os.path.join(world['root'], 'cli87.jsonl')}"])
    finally:
        telemetry.disable()
    assert rc == 87
    assert "systemic data corruption" in capsys.readouterr().err
    assert len(ledger(os.path.join(world["root"], "cli87.jsonl"))) == 8


def test_cli_bulk_flags_build_the_config():
    config, opts = cli.build_config(
        ["--phase", "bulk", "--bulk_input", "in", "--bulk_output", "out", "--bulk_shard_rows", "7"])
    assert (config.phase, config.bulk_input, config.bulk_output, config.bulk_shard_rows) == (
        "bulk", "in", "out", 7)
    assert "bulk" in cli.PORTED_PHASES and opts["repair_shards"] is False


def test_bulk_heartbeat_carries_the_bulk_gauges(world, bulk):
    config = world["cfg"]("heartbeat", heartbeat_interval=0.05)
    assert bulk(config) == 0
    with open(os.path.join(config.summary_dir, "telemetry", "heartbeat.json")) as f:
        beat = json.load(f)
    assert beat["phase"] == "bulk" and beat["bulk_output"] == config.bulk_output
    assert beat["bulk"]["images_done"] == beat["bulk"]["images_total"] == 13
    assert beat["bulk"]["device_ms_per_image"] > 0
    assert (beat["process_index"], beat["process_count"]) == (0, 1)


def test_bulk_over_the_shard_cache_writes_the_same_bytes(world, bulk, monkeypatch):
    """``shard_cache="on"`` cannot build a cache over a file it cannot
    decode: the build raises, as in the JAX package.  Over a cache of the
    decodable files (``"auto"``) the rows come from the cache, the broken
    file is a cache miss whose live decode fails (quarantined as
    ``cache_miss+live_decode_failed``), and the output bytes equal the
    live run's; with a rotted shard row and ``verify_shards="full"`` too."""
    cache_dir = os.path.join(world["root"], "cache")
    with pytest.raises(FileNotFoundError, match=BROKEN):
        bulk(world["cfg"]("cached0", shard_cache="on", shard_cache_dir=cache_dir))
    files = [f for f in resolve_corpus(world["port"].bulk_input) if os.path.basename(f) != BROKEN]
    from sat_tpu_torch.data.shards import build_shard_cache

    build_shard_cache(files, os.path.join(cache_dir, "r32-v1"), 32, rows_per_shard=8)
    config = world["cfg"]("cached", shard_cache="auto", shard_cache_dir=cache_dir)
    assert bulk(config) == 0
    assert outputs(config.bulk_output) == outputs(world["port"].bulk_output)
    assert ledger(config.quarantine_ledger)[0]["reason"] == "cache_miss+live_decode_failed"
    monkeypatch.setenv("SAT_FI_CORRUPT_SHARD_ROW", "2")
    config = world["cfg"]("cached_rot", shard_cache="auto", shard_cache_dir=cache_dir, verify_shards="full")
    assert bulk(config) == 0
    assert outputs(config.bulk_output) == outputs(world["port"].bulk_output)


def test_run_bulk_refusals(world, bulk, monkeypatch):
    with pytest.raises(ValueError, match="bulk_output"):
        runner.run_bulk(world["port"].replace(bulk_output=""), device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        runner.run_bulk(world["cfg"]("refused", blackbox=True), device="cpu")
    # serve_quality is no longer refused: it acts, every row gains its
    # quality signals
    config = world["cfg"]("quality", serve_quality="on")
    assert bulk(config) == 0
    rows = [json.loads(line) for name, blob in sorted(outputs(config.bulk_output).items())
            if name.endswith(".jsonl") for line in blob.decode().splitlines()]
    assert rows and all(set(r["quality"]) == {"margin", "norm_logprob", "unk_rate", "coverage_dev"} for r in rows)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.run_bulk(world["cfg"]("no_card"), model_file=world["path"])
    assert not os.path.exists(world["cfg"]("no_card").bulk_output)


def test_io_fault_hook_is_retried(tmp_path, monkeypatch):
    """``SAT_FI_IO_FAILURES=2:bulk_manifest``: the first two manifest
    writes fail with EIO inside ``retry_io``, which retries (counting
    ``io/retries``) and lands the file."""
    from sat_tpu_torch.bulk.manifest import new_manifest
    from sat_tpu_torch.resilience import faultinject, retry

    monkeypatch.setattr(retry, "_defaults", {"retries": 3, "base_delay_s": 0.0})
    monkeypatch.setenv("SAT_FI_IO_FAILURES", "2:bulk_manifest")
    faultinject.reset_io_faults()
    tel = telemetry.enable()
    try:
        path = manifest_path_for(str(tmp_path))
        write_manifest(path, new_manifest(["/a.jpg"], 4, 32))
        assert tel.counters()["io/retries"] == 2
    finally:
        telemetry.disable()
        faultinject.reset_io_faults()
    assert load_manifest(path)["total_images"] == 1


def test_sigterm_drains_at_a_shard_boundary(world, bulk, monkeypatch, capsys):
    """A SIGTERM while shard 0 decodes: the shard is finished and committed,
    the run stops at the boundary with exit 0, and a relaunch completes
    the directory bitwise the uninterrupted run's."""
    import signal

    real = runner._decode_shard
    calls = []

    def signalling(*a, **k):
        if not calls:
            os.kill(os.getpid(), signal.SIGTERM)
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(runner, "_decode_shard", signalling)
    config = world["cfg"]("sigterm")
    assert bulk(config) == 0
    assert "drained at shard boundary on SIGTERM" in capsys.readouterr().err
    assert list(load_manifest(manifest_path_for(config.bulk_output))["completed"]) == ["0"]
    monkeypatch.setattr(runner, "_decode_shard", real)
    assert bulk(config) == 0
    assert outputs(config.bulk_output) == outputs(world["port"].bulk_output)
