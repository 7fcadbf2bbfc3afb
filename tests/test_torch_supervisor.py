"""The port's crash-only supervisor (``sat_tpu_torch.resilience.supervisor``)
and train's fault hooks, held to sat_tpu's (``tests/test_supervisor.py``,
``tests/test_resilience.py``).

Unit layer: ``_strip_supervise`` as sat_tpu's, and the restart policy
through the ``runner`` hook (restarts with ``--load`` and disarmed
``SAT_FI_*``, the budget, a clean child, a signal that stops the loop).

Train's hooks through the port's CLI on the CPU (``SAT_TORCH_DEVICE=cpu``):
``SAT_FI_DIE_AT_STEP`` exits 1 and ``--load`` resumes bitwise to the
uninterrupted run; ``SAT_FI_NAN_AT_STEP`` reaches the sentinel under
each ``anomaly_policy``; ``SAT_FI_CORRUPT_CKPT_STEP`` is caught by the
post-write verify.  Then the chaos run in real processes: ``--supervise``
with ``SAT_FI_WEDGE_AT_STEP=5`` → watchdog abort (exit 86, stack dump) →
restart from LAST_GOOD → a final checkpoint bitwise the control's.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from sat_tpu.resilience.supervisor import _strip_supervise as jax_strip_supervise
from sat_tpu_torch import cli, runtime
from sat_tpu_torch.resilience import lineage
from sat_tpu_torch.resilience.supervisor import RESTARTS_ENV, _strip_supervise, supervise
from sat_tpu_torch.resilience.watchdog import WATCHDOG_EXIT_CODE
from sat_tpu_torch.train.checkpoint import load_flat, state_to_flat
from tests.test_torch_train_loop import port_config

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---------------------------------------------------------------------------
# the restart policy through the runner hook
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["--config", "c.json", "--supervise", "--max_restarts", "4", "--watchdog", "1.0"],
    ["--supervise", "--max_restarts=4"],
    ["--load"],
    ["--phase", "route", "--supervise", "--num_replicas", "2"],
])
def test_strip_supervise_variants(argv):
    assert _strip_supervise(list(argv)) == jax_strip_supervise(list(argv))
    assert "--supervise" not in _strip_supervise(argv) and "--max_restarts" not in _strip_supervise(argv)


def test_supervisor_restarts_with_load_and_disarmed_faults(monkeypatch):
    monkeypatch.setenv("SAT_FI_WEDGE_AT_STEP", "5")
    calls = []
    rcs = iter([WATCHDOG_EXIT_CODE, 1, 0])

    def runner(cmd, env):
        calls.append((list(cmd), dict(env)))
        return next(rcs)

    sleeps = []
    rc = supervise(["--config", "c.json", "--supervise", "--max_restarts", "5"], max_restarts=5,
                   backoff_base_s=0.01, runner=runner, sleep=sleeps.append)
    assert rc == 0 and len(calls) == 3
    assert len(sleeps) == 2 and all(s > 0 for s in sleeps)
    cmd0, env0 = calls[0]
    assert cmd0[:3] == [sys.executable, "-m", "sat_tpu_torch.cli"]
    assert "--supervise" not in cmd0 and "--max_restarts" not in cmd0 and "--load" not in cmd0
    assert env0[RESTARTS_ENV] == "0" and env0.get("SAT_FI_WEDGE_AT_STEP") == "5"
    for n, (cmd, env) in enumerate(calls[1:], start=1):
        assert cmd.count("--load") == 1
        assert env[RESTARTS_ENV] == str(n)
        assert not any(k.startswith("SAT_FI_") for k in env)


@pytest.mark.parametrize("rc,launches", [(WATCHDOG_EXIT_CODE, 3), (1, 3), (-9, 3), (87, 1)],
                         ids=["watchdog", "crash", "killed", "data_corruption"])
def test_supervisor_budget_spent_returns_last_rc(rc, launches):
    calls = []
    got = supervise(["--config", "c.json"], max_restarts=2, backoff_base_s=0.0,
                    runner=lambda cmd, env: calls.append(cmd) or rc, sleep=lambda s: None)
    assert got == rc and len(calls) == launches  # 87 is never restarted


def test_supervisor_clean_child_never_restarts():
    calls = []
    rc = supervise(["--config", "c.json"], max_restarts=3,
                   runner=lambda cmd, env: (calls.append(cmd), 0)[1], sleep=lambda s: None)
    assert rc == 0 and len(calls) == 1


def test_supervisor_signal_stops_restart_loop():
    calls = []

    def runner(cmd, env):
        calls.append(cmd)
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.05)
        return WATCHDOG_EXIT_CODE

    before = signal.getsignal(signal.SIGTERM)
    rc = supervise(["--config", "c.json"], max_restarts=5, runner=runner, sleep=lambda s: None)
    assert rc == WATCHDOG_EXIT_CODE and len(calls) == 1
    assert signal.getsignal(signal.SIGTERM) is before


# ---------------------------------------------------------------------------
# train's fault hooks through the port's CLI
# ---------------------------------------------------------------------------


def _flat(path):
    return {k: np.asarray(v) for k, v in load_flat(path).items()}


def _assert_bitwise(got_path, want_path):
    got, want = _flat(got_path), _flat(want_path)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _saved(coco_fixture, tmp_path, name, **kw):
    config = port_config(coco_fixture, str(tmp_path / name), phase="train", **kw)
    path = str(tmp_path / f"{name}.json")
    config.save(path)
    return config, path


@pytest.fixture()
def on_cpu(monkeypatch):
    monkeypatch.setenv("SAT_TORCH_DEVICE", "cpu")
    for key in [k for k in os.environ if k.startswith("SAT_FI_")]:
        monkeypatch.delenv(key)
    return monkeypatch


def test_cli_injected_preemption_exits_1_and_resumes_bitwise(coco_fixture, tmp_path, on_cpu, capsys):
    control, control_path = _saved(coco_fixture, tmp_path, "control")
    assert cli.main(["--config", control_path]) == 0
    cfg, path = _saved(coco_fixture, tmp_path, "preempted")
    on_cpu.setenv("SAT_FI_DIE_AT_STEP", "5")
    assert cli.main(["--config", path]) == 1
    assert "injected preemption before step 5" in capsys.readouterr().err
    on_cpu.delenv("SAT_FI_DIE_AT_STEP")
    # steps 4 and 5 ran, but died before a later save: 3.npz survives
    assert lineage.checkpoint_steps(cfg.save_dir) == [3] and lineage.last_good_step(cfg.save_dir) == 3
    assert cli.main(["--config", path, "--load"]) == 0
    assert lineage.last_good_step(cfg.save_dir) == 6
    _assert_bitwise(os.path.join(cfg.save_dir, "6.npz"), os.path.join(control.save_dir, "6.npz"))


def _params_finite(save_dir, step):
    flat = _flat(os.path.join(save_dir, f"{step}.npz"))
    return all(np.isfinite(v).all() for k, v in flat.items() if k.startswith("params/"))


@pytest.mark.parametrize("policy", ["warn", "skip", "rollback"])
def test_cli_injected_nan_reaches_the_sentinel(policy, coco_fixture, tmp_path, on_cpu, capsys):
    cfg, path = _saved(coco_fixture, tmp_path, f"nan_{policy}")
    on_cpu.setenv("SAT_FI_NAN_AT_STEP", "4")
    assert cli.main(["--config", path, "--anomaly_policy", policy]) == 0
    err = capsys.readouterr().err
    if policy == "warn":
        # training goes on; the poisoned checkpoints land but are never blessed
        assert lineage.checkpoint_steps(cfg.save_dir) == [3, 6]
        assert not _params_finite(cfg.save_dir, 6)
        assert lineage.last_good_step(cfg.save_dir) == 3
    elif policy == "skip":
        # no checkpoint while unhealthy, the final one included
        assert lineage.checkpoint_steps(cfg.save_dir) == [3]
        assert "final checkpoint suppressed" in err
    else:
        # LAST_GOOD restored, the poison step skipped, a blessed finite end
        assert lineage.last_good_step(cfg.save_dir) == 6
        assert _params_finite(cfg.save_dir, 6)


def test_cli_injected_checkpoint_corruption_is_not_blessed(coco_fixture, tmp_path, on_cpu):
    cfg, path = _saved(coco_fixture, tmp_path, "rot", async_checkpoint=False)
    on_cpu.setenv("SAT_FI_CORRUPT_CKPT_STEP", "3")
    assert cli.main(["--config", path]) == 0
    assert not lineage.verify_checkpoint(os.path.join(cfg.save_dir, "3.npz"))[0]
    assert lineage.last_good_step(cfg.save_dir) == 6
    assert runtime.setup_train_state(cfg, load=True).step == 6


def test_cli_injected_checkpoint_corruption_through_the_async_writer(coco_fixture, tmp_path, on_cpu):
    cfg, path = _saved(coco_fixture, tmp_path, "rot_async", async_checkpoint=True)
    on_cpu.setenv("SAT_FI_CORRUPT_CKPT_STEP", "3")
    assert cli.main(["--config", path]) == 0
    assert not lineage.verify_checkpoint(os.path.join(cfg.save_dir, "3.npz"))[0]
    assert lineage.last_good_step(cfg.save_dir) == 6


# ---------------------------------------------------------------------------
# chaos: wedge → watchdog abort 86 → supervised restart → bitwise resume
# ---------------------------------------------------------------------------


def _run_cli(args, env_extra=None, timeout=300):
    env = {k: v for k, v in os.environ.items() if not k.startswith("SAT_FI_")}
    env.update(SAT_TORCH_DEVICE="cpu", OMP_NUM_THREADS="2", **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", "sat_tpu_torch.cli", *args], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=timeout)


def test_chaos_wedge_abort_restart_bitwise(coco_fixture, tmp_path):
    """Under --supervise with SAT_FI_WEDGE_AT_STEP=5 the wedged child is
    aborted by the watchdog (exit 86, stack dump on disk), restarted from
    LAST_GOOD with faults disarmed, and finishes with a final checkpoint
    bitwise that of an uninterrupted control run."""
    chaos = dict(watchdog_step_s=3.0, watchdog_data_wait_s=120.0, watchdog_dispatch_s=120.0,
                 watchdog_checkpoint_s=120.0, watchdog_grace_s=0.3, supervise_backoff_s=0.1)
    control_cfg, control_path = _saved(coco_fixture, tmp_path, "chaos_control", **chaos)
    chaos_cfg, chaos_path = _saved(coco_fixture, tmp_path, "chaos_wedged", **chaos)

    control = _run_cli(["--config", control_path, "--watchdog", "0.2"])
    assert control.returncode == 0, control.stdout + control.stderr
    assert lineage.checkpoint_steps(control_cfg.save_dir) == [3, 6]

    proc = _run_cli(["--config", chaos_path, "--watchdog", "0.2", "--supervise"],
                    env_extra={"SAT_FI_WEDGE_AT_STEP": "5"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "sat_tpu_torch watchdog: phase 'step' exceeded" in proc.stderr
    assert "aborting with exit code 86" in proc.stderr
    assert "watchdog abort (wedged run; LAST_GOOD landed)" in proc.stderr
    assert "restarting from LAST_GOOD" in proc.stderr
    assert "run completed after 1 restart(s)" in proc.stderr
    dump = os.path.join(chaos_cfg.summary_dir, "telemetry", "watchdog_stacks.txt")
    assert os.path.isfile(dump) and "phase=step" in open(dump).read()
    assert lineage.last_good_step(chaos_cfg.save_dir) == 6
    _assert_bitwise(os.path.join(chaos_cfg.save_dir, "6.npz"), os.path.join(control_cfg.save_dir, "6.npz"))
    # the final state equals the in-process run's too
    want = state_to_flat(runtime.train(port_config(coco_fixture, str(tmp_path / "inproc")), device="cpu"))
    got = _flat(os.path.join(chaos_cfg.save_dir, "6.npz"))
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
