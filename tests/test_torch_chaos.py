"""The port's chaos campaign (``sat_tpu_torch.tools.chaos_campaign``)
against the JAX package's (``scripts/chaos_campaign.py``) on the CPU.

The same scenario list; the port's campaign on the JAX test's pair
(``tests/test_integrity.py``: the poison e2e and the systemic abort)
with a report ``scripts/check_regression.py`` accepts; a serve scenario
through its embedded child; the report stamp's keys; the fixture's bytes;
the postmortem analyzer's JSON; and a planted fault (a supervisor that
restarts on exit 87) that the campaign must fail.  Every child runs with
``--cpu`` at the campaign's small widths, torch on 2 threads.
"""

from __future__ import annotations

import filecmp
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = {k: v for k, v in os.environ.items() if not k.startswith("SAT_FI_")}
    env["OMP_NUM_THREADS"] = "2"
    return env


def campaign(args, cwd=REPO, timeout=400):
    return subprocess.run(
        [sys.executable, "-m", "sat_tpu_torch.tools.chaos_campaign", "--cpu", *args],
        cwd=cwd, env=_env(), capture_output=True, text=True, timeout=timeout,
    )


def test_list_prints_the_jax_scripts_lines():
    """``--list`` prints the JAX script's 24 lines, names and docstrings in
    order; the port's docstrings leave out the JAX project's issue numbers
    ("ISSUE 10 acceptance" reads "Acceptance")."""
    jax = subprocess.run([sys.executable, os.path.join("scripts", "chaos_campaign.py"), "--list"],
                         cwd=REPO, env=_env(), capture_output=True, text=True, timeout=120)
    port = subprocess.run([sys.executable, "-m", "sat_tpu_torch.tools.chaos_campaign", "--list"],
                          cwd=REPO, env=_env(), capture_output=True, text=True, timeout=120)
    assert jax.returncode == 0 and port.returncode == 0, jax.stderr + port.stderr
    want = re.sub(r"ISSUE \d+ acceptance", "Acceptance", jax.stdout).splitlines()
    assert len(want) == 24
    assert port.stdout.splitlines() == want


def test_campaign_pair_passes_and_the_gate_accepts_its_report(tmp_path):
    """The JAX test's pair through the port's campaign: exit 0, pass rate
    1.0 over 2 scenarios, every row stamped, and ``check_regression.py``
    accepts the report."""
    report = tmp_path / "chaos_report.json"
    proc = campaign(["--only", "poison_quarantine_replay,systemic_no_restart",
                     "--out", str(report), "--workdir", str(tmp_path / "wd")])
    assert proc.returncode == 0, proc.stderr[-4000:]
    rows = json.loads(report.read_text())
    metrics = {r["metric"]: r for r in rows}
    assert metrics["chaos_poison_quarantine_replay"]["value"] == 1.0
    assert metrics["chaos_systemic_no_restart"]["value"] == 1.0
    assert metrics["chaos_pass_rate"]["value"] == 1.0
    assert metrics["chaos_pass_rate"]["scenarios"] == 2
    assert metrics["chaos_pass_rate"]["failed"] == []
    assert all("schema_version" in r for r in rows)
    assert (tmp_path / "summary.md").is_file()

    gate = subprocess.run([sys.executable, os.path.join("scripts", "check_regression.py"), str(report)],
                          cwd=REPO, env=_env(), capture_output=True, text=True, timeout=60)
    assert gate.returncode == 0, gate.stdout + gate.stderr


def test_serve_wedge_scenario_passes_through_its_child(tmp_path):
    """``serve_wedge_continuous``: the embedded child boots the port's
    continuous-mode server with the wedge armed; the row carries the
    child's readings and its kernel counts (the CPU's plain version
    counts no launch)."""
    report = tmp_path / "report.json"
    proc = campaign(["--only", "serve_wedge_continuous", "--out", str(report),
                     "--workdir", str(tmp_path / "wd")])
    assert proc.returncode == 0, proc.stderr[-4000:]
    row = json.loads(report.read_text())[0]
    assert row["metric"] == "chaos_serve_wedge_continuous" and row["value"] == 1.0
    assert row["wedged_status"] == 500 and row["retry_status"] == 200 and row["rewarms"] >= 1
    assert row["serve_device"] == "cpu" and row["launches"] == 0 and row["masked_launches"] == 0


def test_bench_stamp_has_the_jax_stamps_keys(monkeypatch):
    from sat_tpu import telemetry as jax_telemetry
    from sat_tpu_torch import telemetry

    got, want = telemetry.bench_stamp(), jax_telemetry.bench_stamp()
    assert set(got) == set(want)
    assert got["schema_version"] == want["schema_version"] and got["git_sha"] == want["git_sha"]
    host = {"host", "machine", "python"}
    # CUDA is not initialized here: the host descriptor alone
    assert set(got["device"]) == host <= set(want["device"])
    # with a card in use the port adds the device keys JAX fills once jax
    # is initialized, and the power limit
    import torch

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(telemetry, "power_limit", lambda index=0: "700.00 W")
    device = telemetry.bench_stamp()["device"]
    assert set(device) == host | {"platform", "kind", "device_count", "power_limit"}
    assert device["platform"] == "gpu" and device["kind"] == "NVIDIA H100 80GB HBM3" and device["device_count"] == 1


def test_fixture_is_byte_identical_to_the_tests_fixture(tmp_path):
    from sat_tpu_torch.tools.fixtures import make_coco_fixture
    from tests.fixtures import make_coco_fixture as jax_fixture

    port, jax = make_coco_fixture(str(tmp_path / "port")), jax_fixture(str(tmp_path / "jax"))
    names = []
    for root, _, files in os.walk(jax["root"]):
        names += [os.path.relpath(os.path.join(root, f), jax["root"]) for f in files]
    assert len(names) == 26   # 12 JPEGs twice and two caption files
    for name in names:
        assert filecmp.cmp(os.path.join(jax["root"], name), os.path.join(port["root"], name), shallow=False), name
    relative = {k: os.path.relpath(getattr(port["config"], k), port["root"]) for k in
                ("train_image_dir", "eval_caption_file", "vocabulary_file", "temp_data_file", "save_dir")}
    assert relative == {k: os.path.relpath(getattr(jax["config"], k), jax["root"]) for k in relative}
    assert port["config"].batch_size == jax["config"].batch_size == 4


@pytest.mark.parametrize("reason,exit_code,phase", [("watchdog_wedge", 86, "step"),
                                                    ("systemic_corruption", 87, None)])
def test_analyze_postmortem_gives_the_scripts_json(tmp_path, reason, exit_code, phase):
    """One bundle of the port's flight recorder, read by the port's
    analyzer and by ``scripts/analyze_postmortem.py``: the same JSON and
    exit code (also for a directory without a bundle: exit 1 both)."""
    from sat_tpu_torch import telemetry
    from sat_tpu_torch.telemetry import blackbox

    tdir = str(tmp_path / "telemetry")
    tel = telemetry.enable()
    try:
        bb = blackbox.BlackBox(os.path.join(tdir, "blackbox"), tel)
        blackbox.install(bb, telemetry_dir=tdir, config_snapshot={"phase": "train"})
        with tel.span("train/step"):
            pass
        tel.count("serve/tenant_flood_shed", 9)
        tel.count("serve/tenant_steady_shed", 1)
        bb.event("train_start", step=0)
        bb.journal(3)
        bundle = blackbox.dump(reason, exit_code=exit_code, phase=phase, step=3)
    finally:
        blackbox.uninstall()
        telemetry.disable()
    assert bundle and os.path.isdir(bundle)
    for args in ([tdir, "--json"], [bundle, "--json"], [bundle], [str(tmp_path / "empty")]):
        port = subprocess.run([sys.executable, "-m", "sat_tpu_torch.tools.analyze_postmortem", *args],
                              cwd=REPO, capture_output=True, text=True, timeout=60)
        jax = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "analyze_postmortem.py"), *args],
                             cwd=REPO, capture_output=True, text=True, timeout=60)
        assert port.returncode == jax.returncode, args
        assert port.stdout == jax.stdout, args
    summary = json.loads(subprocess.run(
        [sys.executable, "-m", "sat_tpu_torch.tools.analyze_postmortem", bundle, "--json"],
        cwd=REPO, capture_output=True, text=True, timeout=60).stdout)
    assert summary["exit_code"] == exit_code and summary["flooding_tenant"] == "flood"


def test_a_supervisor_that_restarts_on_87_fails_the_campaign(tmp_path):
    """A planted fault in a copy of the port: the supervisor restarts a
    run that exited 87.  ``systemic_no_restart`` must FAIL, the campaign
    exit 1, and ``failed`` name the scenario."""
    repo = tmp_path / "repo"
    shutil.copytree(os.path.join(REPO, "sat_tpu_torch"), repo / "sat_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    path = repo / "sat_tpu_torch" / "resilience" / "supervisor.py"
    src = path.read_text()
    guard = "            if rc == DATA_CORRUPTION_EXIT_CODE:\n"
    assert src.count(guard) == 1
    path.write_text(src.replace(guard, "            if rc == DATA_CORRUPTION_EXIT_CODE and False:\n"))
    report = tmp_path / "report.json"
    proc = campaign(["--only", "systemic_no_restart", "--out", str(report), "--workdir", str(tmp_path / "wd")],
                    cwd=str(repo))
    assert proc.returncode == 1, proc.stderr[-4000:]
    rows = {r["metric"]: r for r in json.loads(report.read_text())}
    assert rows["chaos_systemic_no_restart"]["value"] == 0.0
    assert rows["chaos_pass_rate"]["value"] == 0.0 and rows["chaos_pass_rate"]["failed"] == ["systemic_no_restart"]
    assert "FAIL systemic_no_restart" in proc.stderr


def test_unknown_scenario_exits_1():
    proc = campaign(["--only", "control,no_such_scenario"])
    assert proc.returncode == 1 and "no_such_scenario" in proc.stderr


def test_refuses_to_run_without_a_card_unless_asked(tmp_path):
    env = {k: v for k, v in _env().items() if k != "SAT_TORCH_DEVICE"}
    proc = subprocess.run([sys.executable, "-m", "sat_tpu_torch.tools.chaos_campaign", "--only", "control",
                           "--workdir", str(tmp_path / "wd")],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "no CUDA device is visible" in proc.stderr
    assert not os.path.exists(tmp_path / "wd")
