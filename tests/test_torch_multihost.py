"""``python -m sat_tpu_torch.tools.multihost_demo`` on the CPU: N real OS
processes, started by the tool, join one gloo group over a loopback
store, train, checkpoint and run the mesh eval with the cross-rank
gather — the five layouts of sat_tpu's ``tests/test_parallel_runtime.py``
(dp, cp, tp, and 2x2 with cp or tp, both held to a one-process control's
losses) and the fleet plane's straggler verdict, each with the JAX
script's banner; then the tool's argument errors, its refusal to run
without a card unless the CPU is asked for, and its pieces."""

import os
import signal
import subprocess
import sys

import pytest

from sat_tpu_torch.telemetry.fleet import FleetPlane, aggregate_rows
from sat_tpu_torch.tools import multihost_demo
from tests.torch_dist_helpers import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONE_CORE = pytest.mark.skipif(
    (os.cpu_count() or 1) < 2,
    reason="four gloo ranks and a control on a 1-core host starve the store's rendezvous; run "
    "`SAT_TORCH_DEVICE=cpu python -m sat_tpu_torch.tools.multihost_demo --mesh 2,2 --cp "
    "--check-loss-parity` standalone",
)


def run_demo(root, *args, env=None, timeout=300):
    """The tool in its own process group (a timeout kills its ranks too),
    on the CPU with 2 torch threads a rank."""
    full = {k: v for k, v in os.environ.items() if not k.startswith(("SAT_FI_", "JAX_", "XLA_"))}
    full.update(SAT_TORCH_DEVICE="cpu", OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    full.update(env or {})
    proc = subprocess.Popen(
        [sys.executable, "-m", "sat_tpu_torch.tools.multihost_demo", "--root", str(root),
         "--port", str(free_port()), "--join-timeout", "240", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO, env=full,
        start_new_session=True,
    )
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise AssertionError(f"demo timed out\n{out[-2000:]}\n{err[-1500:]}")
    return proc.returncode, out, err


@pytest.mark.parametrize(
    "extra_args,banner",
    [
        ([], "MULTIHOST OK (data-parallel)"),
        (["--cp"], "MULTIHOST OK (context-parallel)"),
        (["--tp"], "MULTIHOST OK (tensor-parallel)"),
        pytest.param(["--mesh", "2,2", "--cp", "--check-loss-parity"], "MULTIHOST OK (mesh 2x2 context-parallel)",
                     marks=ONE_CORE),
        pytest.param(["--mesh", "2,2", "--tp", "--check-loss-parity"], "MULTIHOST OK (mesh 2x2 tensor-parallel)",
                     marks=ONE_CORE),
    ],
    ids=["dp", "cp", "tp", "dp_x_cp_4proc", "dp_x_tp_4proc"],
)
def test_multihost_demo_real_processes(tmp_path, extra_args, banner):
    """Every rank exits 0 with the same scores, the panels cover every
    decoded image, ``--tp`` verifies sharded parameters in every rank,
    and the 2x2 layouts keep the control's losses (first step 1e-3,
    trajectory 5e-2)."""
    rc, out, err = run_demo(tmp_path / "demo", *extra_args)
    assert rc == 0, f"{out[-3000:]}\n--- stderr ---\n{err[-1500:]}"
    assert banner in out
    procs = 4 if "--mesh" in extra_args else 2
    assert f"{procs} processes, scores agree" in out
    for p in range(procs):
        log = (tmp_path / "demo" / f"worker_p{p}.log").read_text()
        assert f"[p{p}] eval done" in log
        assert ("TP verified" in log) == ("--tp" in extra_args)
    if "--check-loss-parity" in extra_args:
        assert "loss parity vs single-process control" in out


def test_multihost_demo_fleet_names_the_slowed_rank(tmp_path):
    """``--fleet``: worker 0 alone is slowed (SAT_FI_SLOW_STEP_MS); the
    merged fleet.json reports both ranks and names process 0 the
    straggler although the ranks' collectives keep them in lockstep (the
    fleet plane reads each rank's step less its waits on the other).
    With two ranks the 1.5x factor over their median needs worker 0's
    step p95 above three times worker 1's.  Two things keep that clear of
    the host's load.  A fixed stall is no multiple of a CPU step that
    grows with the load, so worker 0's stall is 500 ms or six times its
    own median step, measured as it runs, the longer (the demo's
    ``FLEET_SLOW_SCALE``).  And each rank computes on one torch thread:
    with two, a step waits on the slower thread at every parallel op, and
    on a loaded host worker 1's p95 step reached several times its
    median (one thread keeps it near 1.5 times)."""
    # an inherited fault knob never reaches a worker: this one would
    # preempt both ranks at their third step
    rc, out, err = run_demo(tmp_path / "demo", "--fleet", "--slow-ms", "500",
                            env={"SAT_FI_DIE_AT_STEP": "3", "OMP_NUM_THREADS": "1"})
    assert rc == 0, f"{out[-3000:]}\n--- stderr ---\n{err[-1500:]}"
    assert "fleet verdict: p0" in out and "2 hosts merged" in out
    assert "MULTIHOST OK (data-parallel): 2 processes" in out
    assert "[p0] trained to step 40" in (tmp_path / "demo" / "worker_p0.log").read_text()


@pytest.mark.parametrize(
    "args,message",
    [
        (["--cp", "--tp"], "mutually exclusive"),
        (["--mesh", "2,1", "--cp"], "need a model axis >= 2"),
        (["--mesh", "1,2"], "requires --cp or --tp"),
    ],
    ids=["cp_and_tp", "model_axis_under_2", "bare_model_axis"],
)
def test_argument_errors_exit_2(tmp_path, args, message):
    rc, out, err = run_demo(tmp_path / "demo", *args, timeout=60)
    assert rc == 2 and message in err
    assert not (tmp_path / "demo").exists()


def test_no_card_without_the_cpu_request_fails_with_the_reason(tmp_path):
    """Without ``SAT_TORCH_DEVICE=cpu`` the ranks would take the card; with
    none visible the tool refuses at once (no silent CPU run)."""
    env = {k: v for k, v in os.environ.items() if k != "SAT_TORCH_DEVICE"}
    env.update(PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "sat_tpu_torch.tools.multihost_demo", "--root", str(tmp_path / "demo")],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=120,
    )
    assert out.returncode == 1
    assert "FAIL: no CUDA device is visible" in out.stdout and "SAT_TORCH_DEVICE=cpu" in out.stdout
    assert not (tmp_path / "demo" / "config.json").exists()


@pytest.mark.parametrize(
    "log,flake",
    [
        ("torch.distributed.DistStoreError: Timed out after 301 seconds waiting for clients. 1/2 clients joined.",
         True),
        ("RuntimeError: Gloo connectFullMesh failed with [...] Connect timeout", True),
        ("The server socket has failed to listen on any local network address. port: 12765, useIpv6: 0, "
         "code: -98, name: EADDRINUSE, message: address already in use", True),
        ("RuntimeError: [../third_party/gloo/gloo/transport/tcp/pair.cc:534] Connection closed by peer", False),
        ("ValueError: batch_size=3 not divisible by the data-axis size 2", False),
    ],
    ids=["store_timeout", "gloo_connect", "port_in_use", "peer_crashed", "worker_error"],
)
def test_only_the_rendezvous_signature_is_retried(log, flake):
    assert bool(multihost_demo.RENDEZVOUS_FLAKE.search(log)) is flake


def test_sharded_leaves_counts_blocks_not_replicas():
    """A rank's block of the embedding and of the final projection counts;
    the same leaves whole (replicated) count nothing."""
    import torch

    from sat_tpu_torch.config import Config

    config = Config(vocabulary_size=8, num_decode_layers=2, dim_embedding=4, dim_decode_layer=6)
    full = {"decoder": {"word_embedding": {"weights": torch.zeros(8, 4)},
                        "decode": {"fc_2": {"kernel": torch.zeros(6, 8), "bias": torch.zeros(8)}},
                        "lstm": {"kernel": torch.zeros(8, 8)}}}
    block = {"decoder": {"word_embedding": {"weights": torch.zeros(4, 4)},
                         "decode": {"fc_2": {"kernel": torch.zeros(6, 4), "bias": torch.zeros(4)}},
                         "lstm": {"kernel": torch.zeros(8, 8)}}}
    assert multihost_demo.sharded_leaves(full, config, 2) == 0
    assert multihost_demo.sharded_leaves(block, config, 2) == 3


def test_fleet_plane_reads_noted_own_step_times(tmp_path):
    """Noted own step times replace the ``train/step`` span in a rank's
    sidecar row; without notes the span is read, as sat_tpu's plane does."""
    from sat_tpu_torch import telemetry

    tel = telemetry.Telemetry(256)
    for _ in range(5):
        tel.record("train/step", 0, 100_000_000)
    plane = FleetPlane(str(tmp_path / "fleet"), 1, 2, tel)
    assert os.path.isdir(tmp_path / "fleet")
    assert plane.local_row(3)["step_p50_ms"] == pytest.approx(100.0)
    for ms in (10, 12, 11, 10, 30):
        plane.note_step(ms * 1_000_000)
    row = plane.local_row(3)
    assert row["step_p50_ms"] == pytest.approx(11.0) and row["step_p95_ms"] == pytest.approx(26.4)
    slow = dict(row, process_index=0, step_p95_ms=row["step_p95_ms"] * 4)
    doc = aggregate_rows([slow, row], 1.5)
    assert doc["straggler"]["verdict"] and doc["straggler"]["process_index"] == 0
