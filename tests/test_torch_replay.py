"""``sat_tpu_torch.tools.replay_exemplar`` held against
``scripts/replay_exemplar.py`` on the CPU: exemplars a port server
records with the quality plane on (batch and continuous mode, bursts of
concurrent requests) replay bitwise in the geometry they were captured
in; exemplars sat_tpu's server records on the same weights replay in the
port with the same captions; the exit codes of both tools agree on a
match (0), another checkpoint (1) and missing data (2); ``--diff`` prints
what the JAX script prints."""

import concurrent.futures
import contextlib
import importlib.util
import io
import json
import os
import shutil
import sys

import pytest
import torch

from sat_tpu_torch.telemetry.exemplar import read_exemplars
from sat_tpu_torch.tools import replay_exemplar
from tests.torch_planes_helpers import boot, caption, jax_engine, port_engine, registries, stage_candidate, world

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BURST = 4


def _burst(port, bodies):
    with concurrent.futures.ThreadPoolExecutor(len(bodies)) as pool:
        replies = list(pool.map(lambda body: caption(port, body), bodies))
    assert [r[0] for r in replies] == [200] * len(bodies)


def _capture(package, config, bodies):
    """Serve ``config`` (the quality plane on, every request an outlier,
    the recorder's rate limit off) and send ``bodies`` in bursts of
    ``BURST``; returns the exemplar directory."""
    engine = jax_engine(config) if package == "jax" else port_engine(config)
    server = boot(package, config, engine)
    try:
        server.exemplars.min_interval_s = 0.0
        for i in range(0, len(bodies), BURST):
            _burst(server.port, bodies[i:i + BURST])
        return server.exemplars.dir
    finally:
        server.shutdown()


@pytest.fixture(scope="module")
def qworld(tmp_path_factory):
    """One step-5 checkpoint; exemplars of 8 requests from the port's
    server in each mode and from sat_tpu's in batch mode."""
    root = tmp_path_factory.mktemp("replay")
    w = world(root, serve_quality="on", serve_quality_margin_min=1e9)
    bodies = (w["jpegs"] + w["jpegs"])[:2 * BURST]
    dirs = {}
    with registries():
        for package, mode in (("torch", "batch"), ("torch", "continuous"), ("jax", "batch")):
            tdir = str(root / f"{package}_{mode}")
            config = (w["jc"] if package == "jax" else w["tc"]).replace(serve_mode=mode, telemetry_dir=tdir)
            dirs[(package, mode)] = _capture(package, config, bodies)
    w["dirs"] = dirs
    yield w
    shutil.rmtree(root, ignore_errors=True)


def _jax_replay():
    spec = importlib.util.spec_from_file_location("jax_replay_exemplar",
                                                  os.path.join(REPO, "scripts", "replay_exemplar.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run(package, argv, monkeypatch):
    """(exit code, the JSON lines printed) of one package's replay tool."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        if package == "jax":
            module = _jax_replay()
            monkeypatch.setattr(sys, "argv", [module.__file__] + argv)
            try:
                rc = module.main()
            except SystemExit as e:
                rc = e.code
        else:
            monkeypatch.setenv("SAT_TORCH_DEVICE", "cpu")
            try:
                rc = replay_exemplar.main(argv)
            except SystemExit as e:
                rc = e.code
    return rc, [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]


@pytest.mark.parametrize("mode", ["batch", "continuous"])
def test_port_exemplars_replay_bitwise_in_their_geometry(qworld, mode, monkeypatch):
    """Every exemplar of the port's bursts carries its geometry (some
    captured wider than 1) and replays bitwise with ``--all``: exit 0, the
    captions and the alphas digests equal."""
    exdir = qworld["dirs"][("torch", mode)]
    rows, torn = read_exemplars(exdir)
    assert torn == 0 and len(rows) == 2 * BURST
    assert {r["geometry"]["mode"] for r in rows} == {mode}
    assert max(r["geometry"]["encode_width"] for r in rows) > 1
    if mode == "continuous":
        assert all(0 <= r["geometry"]["pool_slot"] < 4 for r in rows)
    rc, verdicts = _run("torch", ["--dir", exdir, "--all"], monkeypatch)
    assert rc == 0
    assert [v["verdict"] for v in verdicts] == ["BITWISE MATCH"] * len(rows)
    assert [v["replayed"] for v in verdicts] == [r["caption"] for r in rows]
    assert all(v["alphas_digest_replayed"] == v["alphas_digest_captured"] for v in verdicts)


def test_jax_exemplars_replay_in_the_port(qworld, monkeypatch):
    """sat_tpu's exemplars (no geometry: replayed alone in the smallest
    bucket, as the JAX script replays them) give the port the captions
    sat_tpu captured, and the JAX script the same verdicts."""
    exdir = qworld["dirs"][("jax", "batch")]
    rows, _ = read_exemplars(exdir)
    assert len(rows) == 2 * BURST and not any("geometry" in r for r in rows)
    rc, verdicts = _run("torch", ["--dir", exdir, "--all"], monkeypatch)
    jrc, jverdicts = _run("jax", ["--dir", exdir, "--all"], monkeypatch)
    assert rc == jrc == 0
    assert [v["replayed"] for v in verdicts] == [v["replayed"] for v in jverdicts] == [r["caption"] for r in rows]


@pytest.mark.parametrize("case", ["match", "request_id", "other_checkpoint", "no_stored_image", "no_meta"])
def test_exit_codes_match_the_jax_script(qworld, case, tmp_path, monkeypatch):
    """Both tools on the port's batch-mode exemplars: the newest row (0),
    one row by request id (0), ``--model`` another checkpoint (1), an
    ``--index`` whose image was over the size cap or evicted (2), a
    directory without meta.json (2)."""
    exdir = qworld["dirs"][("torch", "batch")]
    rows, _ = read_exemplars(exdir)
    argv = ["--dir", exdir]
    want = 0
    if case == "request_id":
        argv += ["--request-id", rows[2]["request_id"]]
    elif case == "other_checkpoint":
        argv += ["--model", _jittered(qworld, tmp_path)]
        want = 1
    elif case == "no_stored_image":
        copy = _copy_dir(exdir, tmp_path / "ex")
        _rewrite_rows(copy, lambda r: {**r, "image": None})
        argv = ["--dir", copy, "--index", "1"]
        want = 2
    elif case == "no_meta":
        copy = _copy_dir(exdir, tmp_path / "ex")
        os.remove(os.path.join(copy, "meta.json"))
        argv = ["--dir", copy]
        want = 2
    got, want_jax = _run("torch", argv, monkeypatch)[0], _run("jax", argv, monkeypatch)[0]
    assert got == want_jax == want


def test_an_evicted_image_is_missing_data(qworld, tmp_path, monkeypatch):
    """A row whose stored image the budget evicted: the port exits 2
    (missing data, as the tools' documented codes say), not 1 (a
    mismatch); the JAX script counts it as a failed replay and exits 1."""
    copy = _copy_dir(qworld["dirs"][("torch", "batch")], tmp_path / "ex")
    rows, _ = read_exemplars(copy)
    os.remove(os.path.join(copy, rows[-1]["image"]))
    assert _run("torch", ["--dir", copy], monkeypatch)[0] == 2
    assert _run("jax", ["--dir", copy], monkeypatch)[0] == 1


def test_diff_prints_what_the_jax_script_prints(qworld, tmp_path, monkeypatch):
    """``--all --diff OLD NEW`` (the checkpoint and a jittered one) over
    the port's continuous-mode exemplars: the same old and new captions
    and the same ``caption_divergence`` as the JAX script, some rows
    apart."""
    from sat_tpu.telemetry.quality import caption_divergence

    exdir = qworld["dirs"][("torch", "continuous")]
    old = os.path.join(qworld["tc"].save_dir, "5.npz")
    argv = ["--dir", exdir, "--all", "--diff", old, _jittered(qworld, tmp_path)]
    rc, got = _run("torch", argv, monkeypatch)
    jrc, want = _run("jax", argv, monkeypatch)
    assert rc == jrc == 0 and len(got) == len(want) == 2 * BURST
    for g, w in zip(got, want):
        assert (g["old"], g["new"], g["divergence"]) == (w["old"], w["new"], w["divergence"])
        assert g["divergence"] == round(caption_divergence(g["old"], g["new"]), 4)
    assert any(g["divergence"] > 0 for g in got)


def _jittered(qworld, tmp_path) -> str:
    """A copy of the world's checkpoint with its decoder jittered, under
    its own save_dir (the world's LAST_GOOD stays where it was)."""
    save_dir = tmp_path / "other"
    shutil.copytree(qworld["tc"].save_dir, save_dir)
    return stage_candidate(qworld["tc"].replace(save_dir=str(save_dir)), 9, seed=3, scale=1.0)


def _copy_dir(src, dst) -> str:
    shutil.copytree(src, dst)
    return str(dst)


def _rewrite_rows(exdir, fn) -> None:
    for name in os.listdir(exdir):
        if name.startswith("seg_"):
            path = os.path.join(exdir, name)
            with open(path) as f:
                rows = [json.loads(line) for line in f if line.strip()]
            with open(path, "w") as f:
                f.writelines(json.dumps(fn(r), sort_keys=True) + "\n" for r in rows)
