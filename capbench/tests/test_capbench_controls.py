"""Each cell's control and faults come out not correct against the cell's
own limits, and the program as the configuration states comes out correct,
at a tiny size on the CPU.  The harness's look for a card is skipped; the
rest of a run is driven with the timed path broken underneath.

On the card the same controls and faults are read at the cells' own sizes
with ``python3 -m capbench.readings --workload <cell> --seeds ...
[--variant int8|fp8|half] [--fault <name>]``."""

import time

import pytest
import torch

from capbench import bench, faults
from conftest import tiny_cell

CPU = torch.device("cpu")
OFFLINE = ["vgg16.offline_b512", "resnet50.offline_b512"]


def _run(cell, variant="", seed=2 ** 31 + 11):
    out = bench.driver(cell).run(cell, seed, 0.5, False, CPU, time.perf_counter(), variant=variant)
    return bench.checks_ok(out["checks"]), out


@pytest.mark.parametrize("cell", OFFLINE)
def test_the_program_as_stated_is_correct(cell):
    """(A train step's bf16 rounding at these widths reads above the
    full-size limits; its float32 agreement is in test_capbench_reference.)"""
    ok, out = _run(tiny_cell(cell))
    assert ok, out["checks"]


@pytest.mark.parametrize("cell,variant", [(c, v) for c in OFFLINE for v in ("int8", "fp8")] + [("vgg16.train_b1024", "fp8")])
def test_the_control_is_not_correct(cell, variant):
    ok, out = _run(tiny_cell(cell), variant)
    assert not ok, out["checks"]


@pytest.mark.parametrize("cell", OFFLINE)
@pytest.mark.parametrize("fault", ["alter_a_token", "half_the_batch", "state_unchanged"])
def test_an_offline_fault_is_not_correct(cell, fault):
    with faults.planted(fault):
        ok, out = _run(tiny_cell(cell))
    assert not ok, out["checks"]


@pytest.mark.parametrize("cell", OFFLINE)
def test_a_search_that_keeps_the_wrong_beams_is_not_correct(cell):
    """The 2nd to (K+1)-th best continuations kept each step: its scores
    match its own words, so only ``search_slack`` can catch it."""
    with faults.planted("rank_drop"):
        ok, out = _run(tiny_cell(cell))
    assert not ok, out["checks"]
    assert out["checks"]["search_slack"]["value"] > out["checks"]["search_slack"]["limit"], out["checks"]
    assert out["checks"]["score_err"]["value"] <= out["checks"]["score_err"]["limit"], out["checks"]


def test_a_train_step_that_leaves_the_state_unchanged_is_not_correct(monkeypatch):
    from sat_tpu_torch.train import optimizer

    monkeypatch.setattr(optimizer.Optimizer, "step", lambda self, trainable, grads, state, *a, **k: torch.zeros(()))
    ok, out = _run(tiny_cell("vgg16.train_b1024"))
    assert not ok and out["readings"]["change_err"] == pytest.approx(1.0), out["checks"]


def test_a_train_step_over_half_the_batch_is_not_correct():
    ok, out = _run(tiny_cell("vgg16.train_b1024"), "half")
    assert not ok, out["checks"]
