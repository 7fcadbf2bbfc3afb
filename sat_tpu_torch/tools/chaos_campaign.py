"""Chaos campaign: every SAT_FI fault schedule through real supervised runs.

The port of ``scripts/chaos_campaign.py``: the fleet-shaped rehearsal of
the whole fault matrix, each scenario a short real run of the port's CLI
(``python -m sat_tpu_torch.cli``) on the synthetic COCO fixture of
:mod:`.fixtures`, or an embedded child process booting the port's serve
stack, asserting the documented invariant for that failure mode:

* exit codes land where the contract says (0 contained / recovered,
  86 watchdog abort inside a supervised pair, 87 systemic data
  corruption — and 87 is terminal: the supervisor must NOT restart it);
* contained data faults leave a non-empty quarantine ledger, surface
  ``data/quarantined*`` gauges in heartbeat.json, and NEVER change batch
  geometry — a replay against the same ledger reproduces the final
  checkpoint bitwise;
* process-plane faults (preempt/wedge/SIGTERM/ckpt rot/IO flake) resume
  or degrade exactly as their tests promise, end-to-end through the CLI;
* the serve, route, bulk and lifecycle planes contain their faults the
  same way (fast 500s and a re-warm, a router retry, tier-scoped sheds,
  a canary rollback, tenant isolation, quality drift caught).

Emits a campaign report: a JSON array of report rows
(``{"metric": "chaos_<scenario>", "value": 1.0|0.0, ...}``) plus a
``chaos_pass_rate`` summary, each stamped by ``telemetry.bench_stamp``
(``schema_version``), so ``scripts/check_regression.py`` accepts the
artifact as-is.  With ``--out`` a ``summary.md`` beside the report lists
each scenario's verdict, seconds and readings.

The children run on the card unless the campaign is given ``--cpu`` (or
runs under ``SAT_TORCH_DEVICE=cpu``, which they inherit); without a card
and without that request the campaign refuses to start.  The serving
children report their ``fused_attend`` launches (``launches``,
``masked_launches``) and device (``serve_device``) among their readings.

``--extra-set KEY=VALUE`` (the port's addition) is applied to every
scenario's config, the embedded children's too, after the small model:
``--extra-set image_size=224 --extra-set dim_embedding=512 ...`` runs the
matrix at the flagship widths.

Usage: python -m sat_tpu_torch.tools.chaos_campaign [--list] [--only a,b,...]
       [--out report.json] [--workdir DIR] [--keep] [--timeout 420]
       [--cpu] [--extra-set KEY=VALUE ...]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import List

from .. import telemetry
from ..resilience import lineage
from ..resilience.quarantine import DATA_CORRUPTION_EXIT_CODE
from ..resilience.watchdog import WATCHDOG_EXIT_CODE

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[chaos_campaign +{time.perf_counter() - _T0:6.1f}s] {msg}",
          file=sys.stderr, flush=True)


# Same tiny model the resilience tests train: 24 annotation rows, batch 4
# -> 6 steps, checkpoints at 3 and 6.  Telemetry on so every scenario can
# read heartbeat.json.
SMALL_MODEL = dict(
    image_size=32,
    dim_embedding=16,
    num_lstm_units=16,
    dim_initialize_layer=16,
    dim_attend_layer=16,
    dim_decode_layer=32,
    compute_dtype="float32",
    save_period=3,
    log_every=1,
    num_epochs=1,
    num_data_workers=2,
    telemetry=True,
    heartbeat_interval=0.1,
)

# Watchdog/supervisor timings for the scenarios that arm them (the
# test_supervisor chaos values: fast enough to fire inside one run).
CHAOS_TIMINGS = dict(
    watchdog_interval=0.2,
    watchdog_step_s=5.0,
    watchdog_data_wait_s=120.0,
    watchdog_dispatch_s=120.0,
    watchdog_checkpoint_s=120.0,
    watchdog_grace_s=0.3,
    supervise_backoff_s=0.1,
)


class Failure(AssertionError):
    """One scenario invariant did not hold."""


def check(cond, msg: str) -> None:
    if not cond:
        raise Failure(msg)


# -- child-run plumbing ------------------------------------------------------

_TIMEOUT = 420
# --cpu: every child asked for the CPU (SAT_TORCH_DEVICE=cpu)
_CPU = False
# --extra-set overrides, "KEY=VALUE" strings, in the order given
_EXTRA_SET: List[str] = []


def _child_env(extra=None):
    env = {k: v for k, v in os.environ.items() if not k.startswith("SAT_FI_")}
    if _CPU:
        env["SAT_TORCH_DEVICE"] = "cpu"
    env.update(extra or {})
    return env


def run_cli(args, env_extra=None):
    return subprocess.run(
        [sys.executable, "-m", "sat_tpu_torch.cli", *args],
        capture_output=True, text=True, cwd=REPO,
        env=_child_env(env_extra), timeout=_TIMEOUT,
    )


def run_child(script: str, workdir: str, env_extra=None):
    """One embedded child script (``python -c``) on ``workdir``, the
    ``--extra-set`` list passed as its second argument."""
    return subprocess.run(
        [sys.executable, "-c", script, workdir, json.dumps(_EXTRA_SET)],
        capture_output=True, text=True, cwd=REPO,
        env=_child_env(env_extra), timeout=_TIMEOUT,
    )


def extra_overrides(config) -> dict:
    """``--extra-set`` as typed ``Config`` fields (parsed as the CLI's
    ``--set`` parses them)."""
    from ..cli import _parse_override

    out = {}
    for item in _EXTRA_SET:
        key, _, raw = item.partition("=")
        out[key] = _parse_override(config, key, raw)
    return out


class Ctx:
    """One campaign's shared fixture + per-scenario config factory."""

    def __init__(self, root: str):
        from .fixtures import make_coco_fixture

        self.root = root
        fixture_dir = os.path.join(root, "fixture")
        os.makedirs(fixture_dir, exist_ok=True)
        self.fix = make_coco_fixture(fixture_dir)

    def cfg(self, name: str, **kw):
        base = os.path.join(self.root, name)
        config = self.fix["config"].replace(**{
            **SMALL_MODEL,
            "save_dir": os.path.join(base, "models"),
            "summary_dir": os.path.join(base, "summary"),
            **kw,
        })
        return config.replace(**extra_overrides(config))

    def launch(self, config, *extra_args, env=None, name: str = "run"):
        """The CLI on ``config`` (saved as ``<name>.json``); its standard
        output and error are kept as ``<name>.out`` and ``<name>.err``."""
        path = os.path.join(self.root, f"{name}.json")
        config.save(path)
        proc = run_cli(["--config", path, *extra_args], env_extra=env)
        for suffix, text in (("out", proc.stdout), ("err", proc.stderr)):
            with open(os.path.join(self.root, f"{name}.{suffix}"), "w") as f:
                f.write(text)
        return proc


def _read_ledger(path):
    if not os.path.exists(path):
        return []
    entries = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                entries.append(json.loads(line))
            except ValueError:
                pass  # torn tail line: same tolerance as the manager
    return entries


def _heartbeat(config):
    path = os.path.join(config.summary_dir, "telemetry", "heartbeat.json")
    check(os.path.isfile(path), f"heartbeat.json missing: {path}")
    with open(path) as f:
        return json.load(f)


def _flat_npz(path):
    import numpy as np

    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _assert_bitwise(path_a: str, path_b: str) -> None:
    import numpy as np

    a, b = _flat_npz(path_a), _flat_npz(path_b)
    check(set(a) == set(b),
          f"checkpoint key sets differ: {path_a} vs {path_b}")
    for k in a:
        check(np.array_equal(a[k], b[k]),
              f"tensor {k} differs between {path_a} and {path_b}")


def _final_ckpt(config, step: int = 6) -> str:
    path = os.path.join(config.save_dir, f"{step}.npz")
    check(os.path.isfile(path), f"expected final checkpoint {path}")
    return path


def _check_clean(proc, what: str) -> None:
    check(proc.returncode == 0,
          f"{what}: rc {proc.returncode}\n{proc.stdout}\n{proc.stderr}")


def _child_result(proc, what: str) -> dict:
    check(proc.returncode == 0,
          f"{what} child rc {proc.returncode}\n{proc.stdout}\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _kernels(result: dict) -> dict:
    """A serving child's kernel launches and the device it served from
    (``serve_device``: the row's ``device`` is the stamp's)."""
    return {"launches": result["launches"], "masked_launches": result["masked_launches"],
            "serve_device": result["device"]}


# -- the scenario matrix ----------------------------------------------------

SCENARIOS = []


def scenario(fn):
    SCENARIOS.append(fn)
    return fn


@scenario
def control(ctx: Ctx):
    """No faults: clean run, empty ledger, heartbeat alive."""
    cfg = ctx.cfg("control")
    proc = ctx.launch(cfg, name="control")
    _check_clean(proc, "control run")
    _final_ckpt(cfg)
    check(not _read_ledger(os.path.join(cfg.summary_dir, "quarantine.jsonl")),
          "control run quarantined records")
    hb = _heartbeat(cfg)
    check(hb.get("step") == 6, f"heartbeat step {hb.get('step')} != 6")
    return {"steps": hb.get("step")}


@scenario
def preempt_restart(ctx: Ctx):
    """SAT_FI_DIE_AT_STEP under --supervise: abrupt death, restart from
    LAST_GOOD, clean completion."""
    cfg = ctx.cfg("preempt", **CHAOS_TIMINGS)
    proc = ctx.launch(cfg, "--supervise", env={"SAT_FI_DIE_AT_STEP": "5"},
                      name="preempt")
    _check_clean(proc, "supervised preempted run")
    check("restarting from LAST_GOOD" in proc.stderr,
          "supervisor never restarted")
    _final_ckpt(cfg)
    check(lineage.last_good_step(cfg.save_dir) == 6, "LAST_GOOD != 6")
    return {"restarts": proc.stderr.count("restarting from LAST_GOOD")}


@scenario
def sigterm_drain(ctx: Ctx):
    """SAT_FI_SIGTERM_AT_STEP: graceful boundary stop, final checkpoint
    flushed and blessed, rc 0."""
    cfg = ctx.cfg("sigterm")
    proc = ctx.launch(cfg, env={"SAT_FI_SIGTERM_AT_STEP": "4"},
                      name="sigterm")
    _check_clean(proc, "SIGTERM run")
    check("relaunch with --load" in proc.stderr, "no graceful-stop notice")
    check(lineage.last_good_step(cfg.save_dir) == 4,
          "boundary checkpoint not blessed")
    return {"stopped_at": 4}


@scenario
def nan_sentinel_skip(ctx: Ctx):
    """SAT_FI_NAN_AT_STEP with policy=skip: the poisoned tail never
    reaches disk; the run still exits 0."""
    cfg = ctx.cfg("nan_skip", anomaly_policy="skip")
    proc = ctx.launch(cfg, env={"SAT_FI_NAN_AT_STEP": "4"}, name="nan_skip")
    _check_clean(proc, "NaN-skip run")
    check("final checkpoint suppressed" in proc.stderr,
          "sentinel never suppressed the poisoned save")
    check(lineage.checkpoint_steps(cfg.save_dir) == [3],
          f"poisoned checkpoints on disk: "
          f"{lineage.checkpoint_steps(cfg.save_dir)}")
    return {"surviving_steps": [3]}


@scenario
def ckpt_bitrot(ctx: Ctx):
    """SAT_FI_CORRUPT_CKPT_STEP: post-write verify catches the flip,
    LAST_GOOD skips the rotten file, the run completes."""
    cfg = ctx.cfg("ckpt_rot")
    proc = ctx.launch(cfg, env={"SAT_FI_CORRUPT_CKPT_STEP": "3"},
                      name="ckpt_rot")
    _check_clean(proc, "checkpoint-rot run")
    ok, _ = lineage.verify_checkpoint(os.path.join(cfg.save_dir, "3.npz"))
    check(not ok, "corrupted 3.npz still verifies")
    check(lineage.last_good_step(cfg.save_dir) == 6,
          "LAST_GOOD did not advance past the rot")
    return {"rotten_step": 3}


@scenario
def io_flake(ctx: Ctx):
    """SAT_FI_IO_FAILURES: transient IO errors are retried through;
    the run neither crashes nor loses a checkpoint."""
    cfg = ctx.cfg("io_flake")
    proc = ctx.launch(cfg, env={"SAT_FI_IO_FAILURES": "2"}, name="io_flake")
    _check_clean(proc, "IO-flake run")
    _final_ckpt(cfg)
    check(lineage.last_good_step(cfg.save_dir) == 6, "LAST_GOOD != 6")
    return {}


@scenario
def wedge_watchdog(ctx: Ctx):
    """SAT_FI_WEDGE_AT_STEP under --supervise: watchdog aborts 86, the
    supervisor restarts, the pair exits 0."""
    cfg = ctx.cfg("wedge", **CHAOS_TIMINGS)
    proc = ctx.launch(cfg, "--supervise", env={"SAT_FI_WEDGE_AT_STEP": "5"},
                      name="wedge")
    _check_clean(proc, "supervised wedged run")
    check(f"aborting with exit code {WATCHDOG_EXIT_CODE}" in proc.stderr,
          "watchdog never aborted")
    check("restarting from LAST_GOOD" in proc.stderr,
          "supervisor never restarted after 86")
    _final_ckpt(cfg)
    return {}


@scenario
def slow_step_quiet(ctx: Ctx):
    """SAT_FI_SLOW_STEP_MS: degraded-but-alive must NOT trip the armed
    watchdog."""
    cfg = ctx.cfg("slow", **CHAOS_TIMINGS)
    proc = ctx.launch(cfg, env={"SAT_FI_SLOW_STEP_MS": "50"}, name="slow")
    _check_clean(proc, "slow-step run")
    check("exceeded its" not in proc.stderr,
          "watchdog fired on a slow-but-progressing run")
    return {}


@scenario
def shard_bitrot_fallback(ctx: Ctx):
    """SAT_FI_CORRUPT_SHARD_ROW with verify_shards=open: the crc sidecar
    catches the rot, the row live-decodes through the fallback, nothing
    is quarantined, and the final params match the clean run bitwise."""
    cache_dir = os.path.join(ctx.root, "bitrot_cache")
    common = dict(shard_cache="on", shard_cache_dir=cache_dir,
                  verify_shards="open")
    seed_cfg = ctx.cfg("bitrot_seed", **common)
    _check_clean(ctx.launch(seed_cfg, name="bitrot_seed"),
                 "cache-seeding run")

    cfg = ctx.cfg("bitrot", **common)
    proc = ctx.launch(cfg, env={"SAT_FI_CORRUPT_SHARD_ROW": "1"},
                      name="bitrot")
    _check_clean(proc, "shard-bitrot run")
    check(not _read_ledger(os.path.join(cfg.summary_dir, "quarantine.jsonl")),
          "recoverable bitrot was quarantined")
    hb = _heartbeat(cfg)
    counters = hb.get("counters", {})
    check(counters.get("data/corrupt_rows", 0) >= 1,
          f"corrupt row never detected: {counters}")
    check(counters.get("data/decode_fallback", 0) >= 1,
          f"fallback never decoded: {counters}")
    _assert_bitwise(_final_ckpt(seed_cfg), _final_ckpt(cfg))
    return {"corrupt_rows": counters.get("data/corrupt_rows")}


@scenario
def poison_quarantine_replay(ctx: Ctx):
    """The acceptance e2e: CORRUPT_SHARD_ROW + BAD_IMAGE_EVERY armed —
    the corrupt row's fallback decode also fails, the record is
    quarantined and substituted, the run completes with zero crashes,
    heartbeat carries the data gauges, and a replay against the same
    ledger (faults disarmed) reproduces the final checkpoint bitwise."""
    cache_dir = os.path.join(ctx.root, "poison_cache")
    ledger = os.path.join(ctx.root, "poison_ledger.jsonl")
    common = dict(shard_cache="on", shard_cache_dir=cache_dir,
                  verify_shards="open", quarantine_ledger=ledger)
    _check_clean(ctx.launch(ctx.cfg("poison_seed", shard_cache="on",
                                    shard_cache_dir=cache_dir),
                            name="poison_seed"),
                 "cache-seeding run")

    cfg = ctx.cfg("poison", **common)
    proc = ctx.launch(
        cfg,
        env={"SAT_FI_CORRUPT_SHARD_ROW": "1", "SAT_FI_BAD_IMAGE_EVERY": "1"},
        name="poison",
    )
    _check_clean(proc, "poisoned run")
    entries = _read_ledger(ledger)
    check(entries, "quarantine ledger is empty")
    check(any("live_decode_failed" in e.get("reason", "") for e in entries),
          f"no fallback-failure entry in ledger: {entries}")
    hb = _heartbeat(cfg)
    data = hb.get("data", {})
    check(data.get("quarantined_total", 0) >= 1,
          f"heartbeat data gauges missing: {hb.get('data')}")
    check(hb.get("counters", {}).get("data/quarantined", 0) >= 1,
          "data/quarantined counter missing")

    replay_cfg = ctx.cfg("poison_replay", **common)
    _check_clean(ctx.launch(replay_cfg, name="poison_replay"),
                 "ledger replay run")
    _assert_bitwise(_final_ckpt(cfg), _final_ckpt(replay_cfg))
    return {"ledger_entries": len(entries)}


@scenario
def caption_anomaly(ctx: Ctx):
    """SAT_FI_BAD_CAPTION_AT: an all-OOV caption row is quarantined by
    position and substituted; the run completes."""
    cfg = ctx.cfg("caption")
    proc = ctx.launch(cfg, env={"SAT_FI_BAD_CAPTION_AT": "5"},
                      name="caption")
    _check_clean(proc, "bad-caption run")
    entries = _read_ledger(os.path.join(cfg.summary_dir, "quarantine.jsonl"))
    caption = [e for e in entries if e.get("kind") == "caption"]
    check(caption, f"no caption-kind ledger entry: {entries}")
    check(caption[0].get("reason") == "caption_all_oov",
          f"unexpected reason: {caption[0]}")
    _final_ckpt(cfg)
    return {"ledger_entries": len(entries)}


@scenario
def systemic_no_restart(ctx: Ctx):
    """SAT_FI_BAD_IMAGE_EVERY=1 (every record poisoned): the run must
    abort with exit code 87 and the supervisor must NOT restart it."""
    cfg = ctx.cfg("systemic", **CHAOS_TIMINGS, shard_cache="off")
    proc = ctx.launch(cfg, "--supervise",
                      env={"SAT_FI_BAD_IMAGE_EVERY": "1"}, name="systemic")
    check(proc.returncode == DATA_CORRUPTION_EXIT_CODE,
          f"rc {proc.returncode} != {DATA_CORRUPTION_EXIT_CODE}\n"
          f"{proc.stdout}\n{proc.stderr}")
    check("FATAL" in proc.stderr, "no FATAL notice")
    check("not restarting" in proc.stderr,
          "supervisor restarted a systemically corrupt run")
    check("restarting from LAST_GOOD" not in proc.stderr,
          "supervisor restarted a systemically corrupt run")
    entries = _read_ledger(os.path.join(cfg.summary_dir, "quarantine.jsonl"))
    check(entries, "systemic abort left no ledger")
    return {"ledger_entries": len(entries)}


@scenario
def quarantine_ceiling(ctx: Ctx):
    """The ledger is cumulative evidence: a run inheriting a ledger that
    already names 8 rotten files needs ONE more quarantine to cross the
    ceiling (fraction tightened to 0.1) and abort with exit 87."""
    ledger = os.path.join(ctx.root, "ceiling_ledger.jsonl")
    with open(ledger, "w") as f:
        for i in range(8):
            f.write(json.dumps({
                "file": f"/decommissioned/rotten_{i}.jpg",
                "reason": "decode_failed", "kind": "image", "sha": None,
            }) + "\n")
    cfg = ctx.cfg("ceiling", shard_cache="off", quarantine_ledger=ledger,
                  quarantine_max_fraction=0.1)
    # BAD_IMAGE_EVERY=6 poisons exactly one fixture basename: its first
    # decode is quarantine #9 — past min_records, 9/rows_seen > 0.1
    proc = ctx.launch(cfg, env={"SAT_FI_BAD_IMAGE_EVERY": "6"},
                      name="ceiling")
    check(proc.returncode == DATA_CORRUPTION_EXIT_CODE,
          f"rc {proc.returncode} != {DATA_CORRUPTION_EXIT_CODE}\n"
          f"{proc.stdout}\n{proc.stderr}")
    check("systemic data corruption" in proc.stderr,
          "abort did not name the ceiling")
    check(len(_read_ledger(ledger)) == 9, "new quarantine never appended")
    return {}


@scenario
def fleet_straggler(ctx: Ctx):
    """Acceptance, half 1: SAT_FI_SLOW_STEP_MS on one host of a
    simulated fleet.  Two fast peer sidecars are pre-seeded into the
    shared fleet_dir, the one real process runs slowed with
    --fleet_telemetry, and the merged fleet.json must report all three
    hosts and name the real (slow) process 0 as the straggler."""
    fleet_dir = os.path.join(ctx.root, "fleet_dir")
    os.makedirs(fleet_dir, exist_ok=True)
    for p in (1, 2):
        with open(os.path.join(fleet_dir, f"heartbeat_p{p}.json"), "w") as f:
            json.dump({
                "process_index": p, "process_count": 3, "host": f"fast{p}",
                "pid": 1000 + p, "step": 6, "time_unix": time.time(),
                "step_p50_ms": 4.0, "step_p95_ms": 5.0, "data_wait_ms": 0.5,
                "dispatch_ms": 1.0, "rss_mb": 256.0, "quarantined": 0.0,
            }, f)
    cfg = ctx.cfg("fleet", fleet_telemetry=True, fleet_dir=fleet_dir,
                  straggler_factor=1.5)
    proc = ctx.launch(cfg, env={"SAT_FI_SLOW_STEP_MS": "50"}, name="fleet")
    _check_clean(proc, "fleet straggler run")
    with open(os.path.join(fleet_dir, "fleet.json")) as f:
        doc = json.load(f)
    check(doc.get("hosts_reporting") == 3,
          f"fleet.json merged {doc.get('hosts_reporting')} hosts, not 3")
    verdict = doc.get("straggler", {})
    check(verdict.get("verdict") is True,
          f"no straggler verdict despite a 50ms/step host: {verdict}")
    check(verdict.get("process_index") == 0,
          f"straggler verdict names p{verdict.get('process_index')}, "
          "expected the slowed p0")
    hb = _heartbeat(cfg)
    check(hb.get("fleet", {}).get("straggler_index") == 0,
          f"heartbeat fleet/* gauges missing the verdict: {hb.get('fleet')}")
    check(hb.get("process_index") == 0 and hb.get("process_count") == 1,
          "heartbeat lacks process identity stamps")
    return {"skew": verdict.get("skew")}


@scenario
def wedge_postmortem(ctx: Ctx):
    """Acceptance, half 2: a wedge -> exit 86 run with
    --blackbox leaves a complete postmortem bundle, and one
    analyze_postmortem.py command identifies the wedged phase."""
    import glob as _glob

    cfg = ctx.cfg("wedge_pm", **CHAOS_TIMINGS, blackbox=True)
    proc = ctx.launch(cfg, env={"SAT_FI_WEDGE_AT_STEP": "5"},
                      name="wedge_pm")
    check(proc.returncode == WATCHDOG_EXIT_CODE,
          f"rc {proc.returncode} != {WATCHDOG_EXIT_CODE}\n"
          f"{proc.stdout}\n{proc.stderr}")
    tdir = os.path.join(cfg.summary_dir, "telemetry")
    bundles = _glob.glob(os.path.join(tdir, "postmortem_*"))
    check(bundles, f"watchdog abort left no postmortem bundle under {tdir}")
    bundle = max(bundles, key=os.path.getmtime)
    with open(os.path.join(bundle, "manifest.json")) as f:
        manifest = json.load(f)
    check(manifest.get("reason") == "watchdog_wedge",
          f"manifest reason {manifest.get('reason')}")
    check(manifest.get("exit_code") == WATCHDOG_EXIT_CODE,
          f"manifest exit_code {manifest.get('exit_code')}")
    for name in ("spans_tail.json", "state.json", "watchdog_stacks.txt",
                 "heartbeat.json", "config.json"):
        check(os.path.exists(os.path.join(bundle, name)),
              f"bundle incomplete: {name} missing "
              f"(has {sorted(os.listdir(bundle))})")
    check(_glob.glob(os.path.join(bundle, "blackbox", "seg_*.jsonl")),
          "bundle has no black-box ring segments")
    analyzer = subprocess.run(
        [sys.executable, "-m", "sat_tpu_torch.tools.analyze_postmortem",
         bundle, "--json"],
        capture_output=True, text=True, cwd=REPO, timeout=60,
    )
    check(analyzer.returncode == 0,
          f"analyze_postmortem rc {analyzer.returncode}: {analyzer.stderr}")
    summary = json.loads(analyzer.stdout)
    check(summary.get("wedged_phase") in ("step", "dispatch"),
          f"analyzer blamed phase {summary.get('wedged_phase')!r}, "
          "expected the wedged step/dispatch")
    check("wedged" in summary.get("probable_cause", ""),
          f"probable cause unhelpful: {summary.get('probable_cause')}")
    return {"wedged_phase": summary.get("wedged_phase"),
            "bundle_files": len(os.listdir(bundle))}


# Every embedded child starts with this: the port's serve stack, the
# campaign's small serving model (a 30-word vocabulary over two captions)
# with the campaign's --extra-set applied after it, an init checkpoint
# drawn from seed 0 and blessed LAST_GOOD, one 32x32 JPEG, and the kernel
# counts a child reports.  argv: workdir, the --extra-set list as JSON.
_CHILD_PRELUDE = r'''
import json, os, sys, threading, time, urllib.error, urllib.request

import cv2
import numpy as np
import torch

from sat_tpu_torch import telemetry
from sat_tpu_torch.cli import _parse_override
from sat_tpu_torch.config import Config
from sat_tpu_torch.data.vocabulary import Vocabulary, vocab_fingerprint
from sat_tpu_torch.device import resolve_device
from sat_tpu_torch.ops.fused_attend import fused_attend
from sat_tpu_torch.resilience import lineage
from sat_tpu_torch.serve.engine import ServeEngine, load_serving_state
from sat_tpu_torch.serve.server import CaptionServer
from sat_tpu_torch.train.checkpoint import save_checkpoint
from sat_tpu_torch.train.step import create_train_state

workdir = sys.argv[1]
extra_set = json.loads(sys.argv[2])
device = resolve_device(None)
vocab_file = os.path.join(workdir, "vocabulary.csv")
vocabulary = Vocabulary(size=30)
vocabulary.build(["a man riding a horse.", "a cat on a table."])
vocabulary.save(vocab_file)


def build_config(**kw):
    config = Config(
        phase="serve", image_size=32, dim_embedding=16, num_lstm_units=16,
        dim_initialize_layer=16, dim_attend_layer=16, dim_decode_layer=32,
        compute_dtype="float32", vocabulary_size=vocabulary.size,
        vocabulary_file=vocab_file, beam_size=2,
        save_dir=os.path.join(workdir, "models"),
        summary_dir=os.path.join(workdir, "summary"),
        heartbeat_interval=0.0, **kw,
    )
    return config.replace(**{
        key: _parse_override(config, key, raw)
        for key, _, raw in (item.partition("=") for item in extra_set)})


def init_checkpoint(config, edit=None):
    """Seed-0 initial weights (``edit`` may change them first) saved
    and blessed LAST_GOOD."""
    os.makedirs(config.save_dir, exist_ok=True)
    state = create_train_state(config, torch.Generator().manual_seed(0), device)
    if edit is not None:
        with torch.no_grad():
            edit(state.params)
    save_checkpoint(state, config)
    lineage.mark_last_good(config.save_dir, int(state.step))


def kernel_counts(stats):
    """{launches, masked_launches, device} from a server's /stats."""
    k = (stats.get("kernels") or {}).get("fused_attend") or {}
    return {"launches": k.get("launches", 0),
            "masked_launches": k.get("masked_launches", 0),
            "device": stats.get("device")}


def builds(tel):
    """The port's compile events: kernels built in this process
    (``kernel/builds``); it compiles nothing else."""
    return tel.counters().get("kernel/builds", 0)


img = np.random.default_rng(0).integers(0, 255, (32, 32, 3), dtype=np.uint8)
ok, buf = cv2.imencode(".jpg", img)
jpeg = bytes(buf)
'''

# The serve-plane wedge rehearsal runs in its own process: boot the
# continuous-batching serve stack with the wedge fault armed, prove
# in-flight slots surface fast 500s, the slot pool re-warms, and the next
# request serves clean.
_SERVE_WEDGE_CHILD = _CHILD_PRELUDE + r'''
config = build_config(
    serve_mode="continuous", serve_slot_pages=2, serve_page_width=2,
    serve_wedge_timeout_ms=250.0,
)
tel = telemetry.enable()
init_checkpoint(config)
state, _ = load_serving_state(config)
engine = ServeEngine(config, state, vocabulary, tel=tel)
server = CaptionServer(config, engine, port=0).start()
port = server.port


def post(timeout=60.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/caption", data=jpeg, method="POST",
        headers={"Content-Type": "image/jpeg"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def get(route):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{route}", timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


result = {}
status, payload = post(timeout=30.0)
result["wedged_status"] = status
result["wedged_error"] = payload.get("error", "")
result["wedged_batches"] = tel.counters().get("serve/wedged_batches", 0)
deadline = time.time() + 60.0
health = {}
while time.time() < deadline:
    code, health = get("/healthz")
    if code == 200 and health.get("status") == "ok":
        break
    time.sleep(0.05)
result["health_status"] = health.get("status", "")
result["rewarms"] = tel.counters().get("serve/rewarms", 0)
status, payload = post()
result["retry_status"] = status
result["retry_captions"] = bool(payload.get("captions"))
result["pool_busy_after"] = server.pool.occupancy()
result.update(kernel_counts(get("/stats")[1]))
server.shutdown()
print(json.dumps(result))
'''


@scenario
def serve_wedge_continuous(ctx: Ctx):
    """SAT_FI_WEDGE_SERVE_BATCH against --serve_mode continuous: the
    wedged decode step fails its in-flight slots with fast 500s, the
    paged slot pool re-warms (cached compiles), health recovers, and
    the next request serves clean."""
    workdir = os.path.join(ctx.root, "serve_wedge")
    os.makedirs(workdir, exist_ok=True)
    proc = run_child(_SERVE_WEDGE_CHILD, workdir,
                     {"SAT_FI_WEDGE_SERVE_BATCH": "1"})
    result = _child_result(proc, "serve wedge")
    check(result["wedged_status"] == 500,
          f"in-flight request got {result['wedged_status']}, wanted 500")
    check("wedged" in result["wedged_error"],
          f"500 body does not name the wedge: {result['wedged_error']!r}")
    check(result["wedged_batches"] >= 1, "serve/wedged_batches never counted")
    check(result["health_status"] == "ok",
          f"health never recovered: {result['health_status']!r}")
    check(result["rewarms"] >= 1, "slot pool never re-warmed")
    check(result["retry_status"] == 200 and result["retry_captions"],
          f"post-recovery request failed: {result['retry_status']}")
    check(result["pool_busy_after"] == 0,
          f"slots leaked after recovery: {result['pool_busy_after']} busy")
    return {**{k: result[k] for k in
               ("wedged_status", "rewarms", "retry_status", "pool_busy_after")},
            **_kernels(result)}


# The fleet kill rehearsal also runs in its own process: spawn a 2-replica
# LocalFleet + in-process router, SIGKILL one replica mid-load, and prove
# the router's mark-unreachable + single-retry machinery keeps the edge
# clean — zero 5xx/connection errors beyond the in-flight window.  The
# replicas are --phase serve children of the port's CLI.
_FLEET_PRELUDE = _CHILD_PRELUDE + r'''
from sat_tpu_torch.serve.replica import LocalFleet
from sat_tpu_torch.serve.router import Router


def replica_kernels(fleet):
    """Kernel launches summed over the replicas still alive (a killed
    replica's count dies with it)."""
    out = {"launches": 0, "masked_launches": 0, "device": None}
    for ep in fleet.endpoints:
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{ep.port}/stats", timeout=10) as r:
                got = kernel_counts(json.loads(r.read()))
        except (urllib.error.URLError, OSError, ValueError):
            continue
        out["launches"] += got["launches"]
        out["masked_launches"] += got["masked_launches"]
        out["device"] = got["device"]
    return out
'''

_FLEET_KILL_CHILD = _FLEET_PRELUDE + r'''
config = build_config(serve_buckets=(1, 4), serve_max_batch=4)
tel = telemetry.enable()
init_checkpoint(config)

fleet = LocalFleet(config, 2, root=os.path.join(workdir, "fleet"))
router = None
try:
    fleet.wait_ready(timeout_s=300.0)
    router = Router(
        config.replace(phase="route", route_poll_interval_s=0.2),
        fleet.endpoints, fleet=fleet, port=0,
    ).start()
    port = router.port

    def post(timeout=60.0):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/caption", data=jpeg, method="POST",
            headers={"Content-Type": "image/jpeg"})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                r.read()
                return r.status
        except urllib.error.HTTPError as e:
            e.read()
            return e.code
        except (urllib.error.URLError, OSError):
            return 0

    post()  # warm the edge before measuring

    TOTAL, KILL_AT, RATE = 120, 40, 25.0
    outcomes, lock, threads = [], threading.Lock(), []
    kill_time = None

    def fire(i):
        status = post()
        with lock:
            outcomes.append((time.time(), status))

    for i in range(TOTAL):
        if i == KILL_AT:
            fleet.replicas[1].kill()  # SIGKILL: sockets die mid-flight
            kill_time = time.time()
        t = threading.Thread(target=fire, args=(i,), daemon=True)
        t.start()
        threads.append(t)
        time.sleep(1.0 / RATE)
    for t in threads:
        t.join(timeout=120)

    # the in-flight window: requests completing around the kill may have
    # ridden a socket SIGKILL severed mid-response; everything outside it
    # must be clean (the router retried them onto the survivor)
    GRACE_S = 2.0
    bad = [(t, s) for t, s in outcomes if s == 0 or s >= 500]
    bad_outside = [
        (t, s) for t, s in bad
        if not (kill_time - 0.5 <= t <= kill_time + GRACE_S)
    ]
    after = [s for t, s in outcomes if t > kill_time + GRACE_S]
    deadline = time.time() + 10.0
    routable = 2
    while time.time() < deadline:
        h, code = router.healthz()
        routable = h["replicas_routable"]
        if routable == 1:
            break
        time.sleep(0.1)
    print(json.dumps({
        "total": len(outcomes),
        "ok": sum(1 for _, s in outcomes if s == 200),
        "shed": sum(1 for _, s in outcomes if s == 429),
        "bad_total": len(bad),
        "bad_outside_window": len(bad_outside),
        "bad_statuses": sorted({s for _, s in bad}),
        "post_kill_ok": sum(1 for s in after if s == 200),
        "retries": tel.counters().get("route/retries", 0),
        "routable_after": routable,
        **replica_kernels(fleet),
    }))
finally:
    if router is not None:
        router.shutdown()
    fleet.stop_all(timeout_s=30.0)
'''


@scenario
def fleet_replica_kill(ctx: Ctx):
    """Acceptance: SIGKILL one of two router-fronted replicas
    mid-load; the fleet view marks it unreachable, the single
    different-replica retry absorbs the severed sockets, and the edge
    serves zero 5xx beyond the in-flight window."""
    workdir = os.path.join(ctx.root, "fleet_kill")
    os.makedirs(workdir, exist_ok=True)
    result = _child_result(run_child(_FLEET_KILL_CHILD, workdir), "fleet kill")
    check(result["bad_outside_window"] == 0,
          f"{result['bad_outside_window']} 5xx/conn-errors beyond the "
          f"in-flight window (statuses {result['bad_statuses']})")
    check(result["post_kill_ok"] > 0,
          "no successful requests after the kill — the survivor never "
          "absorbed the load")
    check(result["routable_after"] == 1,
          f"fleet view still routes {result['routable_after']} replicas "
          "after the kill, wanted 1")
    check(result["ok"] + result["shed"] + result["bad_total"]
          == result["total"], "outcome accounting does not add up")
    return {**{k: result[k] for k in
               ("ok", "shed", "bad_total", "bad_outside_window",
                "post_kill_ok", "retries", "routable_after")},
            **_kernels(result)}


# The encode-tier kill rehearsal: a disaggregated encode+decode fleet
# behind the router.  SIGKILL the encode tier mid-traffic; the fleet
# view must empty the tier within a poll, image traffic must shed
# tier-scoped 429s (never 5xx), grids minted before the kill must keep
# flowing to the decode tier throughout, and a respawn restores two-hop
# service.
_ENCODE_TIER_KILL_CHILD = _FLEET_PRELUDE + r'''
from sat_tpu_torch.serve.handoff import GRID_CONTENT_TYPE

config = build_config(serve_buckets=(1, 4), serve_max_batch=4)
tel = telemetry.enable()
init_checkpoint(config)

fleet = LocalFleet(config, 2, root=os.path.join(workdir, "fleet"),
                   tiers=["encode", "decode"])
router = None
try:
    fleet.wait_ready(timeout_s=300.0)
    router = Router(
        config.replace(phase="route", route_poll_interval_s=0.2),
        fleet.endpoints, fleet=fleet, port=0,
    ).start()
    port = router.port

    def post(data, ctype="image/jpeg", timeout=90.0):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/caption", data=data, method="POST",
            headers={"Content-Type": ctype})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                r.read()
                return r.status, dict(r.headers)
        except urllib.error.HTTPError as e:
            e.read()
            return e.code, dict(e.headers)
        except (urllib.error.URLError, OSError):
            return 0, {}

    def healthz():
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
            return json.loads(r.read())

    # a grid minted by the encode tier while it is alive: the starved
    # phase replays it to prove the decode tier keeps serving
    req = urllib.request.Request(
        f"http://127.0.0.1:{fleet.endpoints[0].port}/encode", data=jpeg,
        method="POST", headers={"Content-Type": "image/jpeg"})
    with urllib.request.urlopen(req, timeout=90.0) as r:
        grid = r.read()
        assert r.headers.get("Content-Type") == GRID_CONTENT_TYPE, (
            r.headers.get("Content-Type"))

    steady = [post(jpeg)[0] for _ in range(10)]
    h0 = healthz()

    fleet.replicas[0].kill()  # SIGKILL: the encode tier dies mid-fleet
    deadline = time.time() + 20.0
    while time.time() < deadline:
        if healthz()["replicas_encode"] == 0:
            break
        time.sleep(0.1)

    starved = [post(jpeg) for _ in range(6)]
    grid_during = [post(grid, ctype=GRID_CONTENT_TYPE)[0]
                   for _ in range(4)]

    fleet.respawn("r0")  # same index -> same port, same encode tier
    recovered = 0
    deadline = time.time() + 300.0
    while time.time() < deadline:
        if healthz()["replicas_encode"] >= 1:
            recovered = 1
            break
        time.sleep(0.5)
    after = [post(jpeg)[0] for _ in range(6)]

    statuses = (steady + [s for s, _h in starved] + grid_during + after)
    print(json.dumps({
        "steady": steady,
        "handoffs": tel.counters().get("route/handoffs", 0),
        "pre_kill_encode": h0.get("replicas_encode"),
        "pre_kill_decode": h0.get("replicas_decode"),
        "starved_statuses": sorted({s for s, _h in starved}),
        "starved_tier_scoped": sum(
            1 for s, h in starved
            if s == 429 and h.get("X-Shed-Scope") == "tier"),
        "starved_total": len(starved),
        "grid_during": grid_during,
        "recovered": recovered,
        "after": after,
        "bad_total": sum(1 for s in statuses if s == 0 or s >= 500),
        **replica_kernels(fleet),
    }))
finally:
    if router is not None:
        router.shutdown()
    fleet.stop_all(timeout_s=30.0)
'''


@scenario
def encode_tier_kill(ctx: Ctx):
    """Acceptance: SIGKILL the encode-tier replica of a
    disaggregated encode+decode fleet mid-traffic.  The router's fleet
    view empties the tier within a poll, image traffic sheds coherent
    tier-scoped 429s (NEVER a 5xx), pre-minted grids keep flowing to
    the decode tier the whole time, and a respawn restores two-hop
    service."""
    workdir = os.path.join(ctx.root, "encode_tier_kill")
    os.makedirs(workdir, exist_ok=True)
    result = _child_result(run_child(_ENCODE_TIER_KILL_CHILD, workdir),
                           "encode tier kill")
    check(all(s == 200 for s in result["steady"]),
          f"two-hop steady traffic failed: {result['steady']}")
    check(result["handoffs"] >= len(result["steady"]),
          f"router never two-hopped: {result['handoffs']} handoffs")
    check(result["pre_kill_encode"] == 1 and result["pre_kill_decode"] == 1,
          f"fleet view missed a tier: {result['pre_kill_encode']} encode / "
          f"{result['pre_kill_decode']} decode")
    check(result["starved_statuses"] == [429],
          f"starved image traffic saw {result['starved_statuses']}, "
          "wanted only tier-scoped 429s")
    check(result["starved_tier_scoped"] == result["starved_total"],
          f"{result['starved_total'] - result['starved_tier_scoped']} "
          "sheds lacked X-Shed-Scope: tier")
    check(all(s == 200 for s in result["grid_during"]),
          f"decode tier stopped serving grids during the outage: "
          f"{result['grid_during']}")
    check(result["recovered"] == 1,
          "encode tier never rejoined the fleet view after respawn")
    check(all(s == 200 for s in result["after"]),
          f"two-hop service not restored after respawn: {result['after']}")
    check(result["bad_total"] == 0,
          f"{result['bad_total']} 5xx/conn-errors across the episode — "
          "tier starvation must shed, not error")
    return {**{k: result[k] for k in
               ("handoffs", "starved_tier_scoped", "recovered", "bad_total")},
            **_kernels(result)}


# -- bulk offline captioning ---------------------------------------------------
#
# Both bulk scenarios decode the fixture's train images through the
# --phase bulk pipeline, which needs a blessed checkpoint: one short seed
# train, memoized on the Ctx so --only runs stay self-contained without
# every scenario paying for its own.


def _bulk_checkpoint(ctx: Ctx) -> str:
    """Train the tiny model once; returns the blessed save_dir."""
    if not hasattr(ctx, "_bulk_save_dir"):
        cfg = ctx.cfg("bulk_seed")
        _check_clean(ctx.launch(cfg, name="bulk_seed"), "bulk seed train")
        check(lineage.last_good_step(cfg.save_dir) == 6,
              "bulk seed train left no LAST_GOOD checkpoint")
        ctx._bulk_save_dir = cfg.save_dir
    return ctx._bulk_save_dir


def _bulk_cfg(ctx: Ctx, name: str, **kw):
    return ctx.cfg(
        name,
        phase="bulk",
        save_dir=_bulk_checkpoint(ctx),
        bulk_input=ctx.fix["train_img_dir"],
        bulk_output=os.path.join(ctx.root, name, "out"),
        bulk_shard_rows=4,
        shard_cache="off",
        beam_size=2,
        serve_slot_pages=2,
        serve_page_width=2,
        **kw,
    )


def _bulk_outputs(out_dir: str):
    """{basename: bytes} of every committed caption shard + sidecar."""
    blobs = {}
    for fname in sorted(os.listdir(out_dir)):
        if fname.startswith("captions_") and not fname.endswith(".tmp"):
            with open(os.path.join(out_dir, fname), "rb") as f:
                blobs[fname] = f.read()
    return blobs


@scenario
def bulk_preempt_resume(ctx: Ctx):
    """SAT_FI_DIE_AT_STEP (abrupt death mid-corpus) under --supervise:
    the supervisor relaunches, resume verifies + skips the committed
    output shards, re-decodes the interrupted one, and the final output
    files are bitwise-identical to an uninterrupted control run."""
    import re

    control = _bulk_cfg(ctx, "bulk_control")
    _check_clean(ctx.launch(control, name="bulk_control"),
                 "control bulk run")
    control_blobs = _bulk_outputs(control.bulk_output)
    check(len(control_blobs) == 6,  # 3 shards x (jsonl + crc sidecar)
          f"control run committed {sorted(control_blobs)}, wanted 3 shards")
    # the control heartbeat carries the deterministic fault-injection
    # clock — aim the kill mid-corpus, past the first shard commit
    total_steps = _heartbeat(control).get("bulk", {}).get("decode_steps")
    check(total_steps and total_steps >= 3,
          f"control heartbeat lacks bulk/decode_steps: {total_steps}")
    die_at = max(2, total_steps // 2)

    cfg = _bulk_cfg(ctx, "bulk_preempt", supervise_backoff_s=0.1)
    proc = ctx.launch(cfg, "--supervise",
                      env={"SAT_FI_DIE_AT_STEP": str(die_at)},
                      name="bulk_preempt")
    _check_clean(proc, "supervised bulk run")
    check("restarting from LAST_GOOD" in proc.stderr,
          "supervisor never restarted the killed bulk run")
    resumed = [int(m.group(1)) for m in
               re.finditer(r"\((\d+) already complete", proc.stderr)]
    check(len(resumed) >= 2 and max(resumed) >= 1,
          f"resume frontier never skipped a committed shard: {resumed} "
          f"(die_at={die_at})")
    blobs = _bulk_outputs(cfg.bulk_output)
    check(set(blobs) == set(control_blobs),
          f"output file sets differ: {sorted(blobs)} vs "
          f"{sorted(control_blobs)}")
    for fname in control_blobs:
        check(blobs[fname] == control_blobs[fname],
              f"{fname} differs between interrupted-and-resumed and "
              "uninterrupted runs")
    return {"die_at_step": die_at, "restarts":
            proc.stderr.count("restarting from LAST_GOOD"),
            "shards_skipped_on_resume": max(resumed)}


@scenario
def bulk_poison_quarantine(ctx: Ctx):
    """SAT_FI_BAD_IMAGE_EVERY through --phase bulk: poison images are
    ledgered and substituted (job completes, rc 0, quarantine marked in
    the output rows) — and past the systemic ceiling the job exits 87
    and the supervisor refuses to restart it."""
    ledger = os.path.join(ctx.root, "bulk_poison_ledger.jsonl")
    cfg = _bulk_cfg(ctx, "bulk_poison", quarantine_ledger=ledger)
    # EVERY=6 poisons exactly one fixture basename (crc32 % 6 == 0):
    # contained — 1/12 rows is far below the 0.5 default ceiling
    proc = ctx.launch(cfg, env={"SAT_FI_BAD_IMAGE_EVERY": "6"},
                      name="bulk_poison")
    _check_clean(proc, "poisoned bulk run")
    entries = _read_ledger(ledger)
    check(entries, "quarantine ledger is empty")
    check(all(e.get("kind") == "image" for e in entries),
          f"unexpected ledger kinds: {entries}")
    hb = _heartbeat(cfg)
    check(hb.get("bulk", {}).get("quarantined", 0) >= 1,
          f"heartbeat bulk gauges missing quarantine: {hb.get('bulk')}")
    quarantined_rows = []
    for fname, blob in _bulk_outputs(cfg.bulk_output).items():
        if fname.endswith(".jsonl"):
            for line in blob.splitlines():
                row = json.loads(line)
                if row.get("quarantined"):
                    quarantined_rows.append(row)
    check(len(quarantined_rows) == len(entries),
          f"{len(entries)} ledger entries but {len(quarantined_rows)} "
          "substituted output rows")
    check(all(r.get("substituted_from") for r in quarantined_rows),
          f"substituted rows lack provenance: {quarantined_rows}")

    # ceiling variant: 8 inherited ledger entries + fraction 0.1 — the
    # one new quarantine crosses the ceiling, 87 is terminal under
    # --supervise (same contract as quarantine_ceiling for training)
    ceiling_ledger = os.path.join(ctx.root, "bulk_ceiling_ledger.jsonl")
    with open(ceiling_ledger, "w") as f:
        for i in range(8):
            f.write(json.dumps({
                "file": f"/decommissioned/rotten_{i}.jpg",
                "reason": "decode_failed", "kind": "image", "sha": None,
            }) + "\n")
    ceil_cfg = _bulk_cfg(ctx, "bulk_ceiling",
                         quarantine_ledger=ceiling_ledger,
                         quarantine_max_fraction=0.1,
                         supervise_backoff_s=0.1)
    proc = ctx.launch(ceil_cfg, "--supervise",
                      env={"SAT_FI_BAD_IMAGE_EVERY": "6"},
                      name="bulk_ceiling")
    check(proc.returncode == DATA_CORRUPTION_EXIT_CODE,
          f"rc {proc.returncode} != {DATA_CORRUPTION_EXIT_CODE}\n"
          f"{proc.stdout}\n{proc.stderr}")
    check("FATAL" in proc.stderr, "no FATAL notice")
    check("not restarting" in proc.stderr,
          "supervisor restarted a systemically corrupt bulk run")
    check(len(_read_ledger(ceiling_ledger)) == 9,
          "ceiling quarantine never appended")
    return {"ledger_entries": len(entries),
            "substituted_rows": len(quarantined_rows)}


# The lifecycle rehearsals run in their own process: a serve stack with
# the reloader armed, a retrained checkpoint landing mid-traffic, and the
# full reload -> canary -> verdict cycle driven by the REAL machinery —
# poller, hash router, SLO scorer, ledger.
_LIFECYCLE_CHILD_PRELUDE = _CHILD_PRELUDE + r'''
from sat_tpu_torch.lifecycle import canary


def boot(config):
    tel = telemetry.enable(capacity=16384)
    init_checkpoint(config)
    state, _ = load_serving_state(config)
    engine = ServeEngine(config, state, vocabulary, tel=tel)
    engine.warmup()
    server = CaptionServer(config, engine, port=0).start()
    return tel, engine, server


def stage_candidate(config, base_step, step, jitter=1e-3):
    """A 'retrain' landing: the base params nudged, sidecar attested,
    LAST_GOOD flipped — exactly what finalize_save publishes."""
    flat = dict(np.load(os.path.join(config.save_dir, f"{base_step}.npz")))
    for k in list(flat):
        if k.startswith("params/decoder/") and flat[k].dtype.kind == "f":
            flat[k] = flat[k] + np.asarray(jitter, flat[k].dtype)
    flat["global_step"] = np.asarray(step, np.int64)
    path = os.path.join(config.save_dir, f"{step}.npz")
    with open(path, "wb") as f:
        np.savez(f, **flat)
    lineage.write_sidecar(path, vocab=vocab_fingerprint(
        config.vocabulary_file, config.vocabulary_size))
    lineage.mark_last_good(config.save_dir, step)


def post(port, rid, timeout=90.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/caption", data=jpeg, method="POST",
        headers={"Content-Type": "image/jpeg", "X-Request-Id": rid})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def stats(port):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/stats", timeout=10) as r:
        return json.loads(r.read())


def wait_for(predicate, timeout, what):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
    raise AssertionError("timed out waiting for " + what)
'''

_LIFECYCLE_HOT_SWAP_CHILD = _LIFECYCLE_CHILD_PRELUDE + r'''
# hot swap under load: the reloader notices the landed retrain, canaries
# it, auto-promotes — while a generator hammers /caption the whole time.
config = build_config(
    serve_queue_depth=64,
    serve_mode="continuous", serve_slot_pages=2, serve_page_width=2,
    model_reload=0.3, canary_fraction=0.5, canary_window_s=2.0,
    promote_policy="auto", canary_shadow_rate=0.0,
)
tel, engine, server = boot(config)
port = server.port
base_step = engine.step
compiles0 = builds(tel)

statuses, slots, steps = [], set(), set()
stop = threading.Event()
lock = threading.Lock()


def generate(tag):
    i = 0
    while not stop.is_set():
        status, payload = post(port, f"hs-{tag}-{i}")
        with lock:
            statuses.append(status)
            if status == 200:
                slots.add(payload["slot"])
                steps.add(payload["model_step"])
        i += 1


threads = [threading.Thread(target=generate, args=(t,)) for t in "ab"]
for t in threads:
    t.start()
time.sleep(0.5)  # steady incumbent traffic before the retrain lands
stage_candidate(config, base_step, base_step + 100)
wait_for(lambda: stats(port)["lifecycle"]["serving_step"] == base_step + 100,
         90.0, "auto-promote of the landed retrain")
time.sleep(0.5)  # post-promote traffic on the new incumbent
stop.set()
for t in threads:
    t.join(timeout=120)

s = stats(port)
print(json.dumps({
    "requests": len(statuses),
    "non_200": sorted(set(x for x in statuses if x != 200)),
    "slots": sorted(slots),
    "steps": sorted(steps),
    "served_step": s["lifecycle"]["serving_step"],
    "last_cycle": s["lifecycle"].get("last_cycle"),
    # the port's server compiles nothing ahead (no such /stats field):
    # its compile events since ready are the kernels built since
    "compiles_since_ready": builds(tel) - compiles0,
    "compile_delta": builds(tel) - compiles0,
    "http_5xx": tel.counters().get("serve/http_5xx", 0),
    "swap_blackout_ms": tel.gauges().get("lifecycle/swap_blackout_ms"),
    **kernel_counts(s),
}))
server.shutdown()
'''

_LIFECYCLE_ROLLBACK_CHILD = _LIFECYCLE_CHILD_PRELUDE + r'''
# canary rollback: the candidate's batches run slowed (fault injection),
# the canary p99 objective burns, the controller rolls back on its own
# and the step lands in the rejection ledger — never re-canaried.
config = build_config(
    serve_queue_depth=64,
    model_reload=0.3, canary_fraction=0.5, canary_window_s=30.0,
    promote_policy="auto", canary_shadow_rate=0.0,
    slo_serve_p99_ms=500.0,
)
tel, engine, server = boot(config)
port = server.port
base_step = engine.step
compiles0 = builds(tel)
bad_step = base_step + 100

canary_ids = [f"cr-{i}" for i in range(200)
              if canary.assign_slot(f"cr-{i}", 0.5) == canary.CANARY][:4]
inc_ids = [f"cr-{i}" for i in range(200)
           if canary.assign_slot(f"cr-{i}", 0.5) == canary.INCUMBENT][:2]

status, payload = post(port, inc_ids[0])
assert status == 200, status

stage_candidate(config, base_step, bad_step)
wait_for(lambda: stats(port)["lifecycle"]["state"] == "CANARY",
         60.0, "canary to arm")

# enough canary traffic to clear the SLO's MIN_EVENTS floor; each batch
# runs ~2.5s slowed, blowing the 500ms p99 target
threads = [threading.Thread(target=post, args=(port, rid))
           for rid in canary_ids]
for t in threads:
    t.start()
for t in threads:
    t.join(timeout=120)
wait_for(lambda: stats(port)["lifecycle"]["state"] == "IDLE",
         90.0, "slo-burn rollback")

s = stats(port)
last = s["lifecycle"].get("last_cycle") or {}
reloads_after_verdict = tel.counters().get("lifecycle/reloads", 0)
# the poller keeps running against the unchanged (rejected) pointer:
# give it several intervals to prove it never re-canaries the step
time.sleep(1.2)
s2 = stats(port)
status, payload = post(port, inc_ids[1])

ledger_path = os.path.join(config.save_dir, lineage.REJECTED_NAME)
ledger_lines = [l for l in open(ledger_path).read().splitlines()
                if l.strip()]
print(json.dumps({
    "last_cycle": last,
    "rejected_steps": s["lifecycle"].get("rejected_steps", []),
    "ledger_lines": len(ledger_lines),
    "state_after_wait": s2["lifecycle"]["state"],
    "reloads_total": tel.counters().get("lifecycle/reloads", 0),
    "reloads_at_verdict": reloads_after_verdict,
    "incumbent_status": status,
    "incumbent_step": payload.get("model_step"),
    "served_step": s2["lifecycle"]["serving_step"],
    "compile_delta": builds(tel) - compiles0,
    "http_5xx": tel.counters().get("serve/http_5xx", 0),
    **kernel_counts(stats(port)),
}))
server.shutdown()
'''


@scenario
def lifecycle_hot_swap(ctx: Ctx):
    """A retrained checkpoint lands (sidecar + LAST_GOOD) while load
    generators hammer a continuous-mode server: the reloader canaries
    it, auto-promotes after a clean window, and across the WHOLE cycle
    there are zero non-200s and zero steady-state recompiles, with the
    swap blackout measured."""
    workdir = os.path.join(ctx.root, "lifecycle_hot_swap")
    os.makedirs(workdir, exist_ok=True)
    result = _child_result(run_child(_LIFECYCLE_HOT_SWAP_CHILD, workdir),
                           "hot-swap")
    check(result["non_200"] == [],
          f"requests dropped during the cycle: {result['non_200']} "
          f"out of {result['requests']}")
    check(result["http_5xx"] == 0, f"5xx counted: {result['http_5xx']}")
    check(len(result["steps"]) == 2,
          f"traffic should see exactly old+new steps: {result['steps']}")
    check("canary" in result["slots"],
          f"no request ever routed to the canary: {result['slots']}")
    check((result["last_cycle"] or {}).get("outcome") == "promoted",
          f"cycle did not promote: {result['last_cycle']}")
    check(result["compiles_since_ready"] == 0
          and result["compile_delta"] == 0,
          f"hot swap recompiled: {result['compile_delta']} new compiles")
    check(result["swap_blackout_ms"] is not None
          and result["swap_blackout_ms"] >= 0,
          "swap blackout never measured")
    return {"requests": result["requests"],
            "swap_blackout_ms": result["swap_blackout_ms"],
            **_kernels(result)}


@scenario
def lifecycle_canary_rollback(ctx: Ctx):
    """SAT_FI_CANARY_SLOW_MS slows only candidate batches: the canary
    p99 objective burns, the controller auto-rolls-back, the incumbent
    never blips, and the rejected step lands in the lineage ledger
    exactly once — the reloader never re-canaries it."""
    workdir = os.path.join(ctx.root, "lifecycle_rollback")
    os.makedirs(workdir, exist_ok=True)
    proc = run_child(_LIFECYCLE_ROLLBACK_CHILD, workdir,
                     {"SAT_FI_CANARY_SLOW_MS": "2500"})
    result = _child_result(proc, "rollback")
    last = result["last_cycle"] or {}
    check(last.get("outcome") == "rolled_back",
          f"cycle did not roll back: {last}")
    check("slo burning" in last.get("why", ""),
          f"rollback reason is not the burn: {last.get('why')!r}")
    check(result["ledger_lines"] == 1,
          f"rejection ledger has {result['ledger_lines']} lines, not 1")
    check(result["state_after_wait"] == "IDLE"
          and result["reloads_total"] == result["reloads_at_verdict"],
          "reloader re-canaried a rejected step")
    check(result["incumbent_status"] == 200
          and result["incumbent_step"] == result["served_step"],
          f"incumbent blipped: {result['incumbent_status']} "
          f"step {result['incumbent_step']}")
    check(result["http_5xx"] == 0, f"5xx counted: {result['http_5xx']}")
    check(result["compile_delta"] == 0,
          f"rollback recompiled: {result['compile_delta']}")
    return {"ledger_lines": result["ledger_lines"],
            "why": last.get("why", "")[:80],
            **_kernels(result)}


# The multi-tenant isolation rehearsal: tenant A floods at ~5x its
# admission quota while tenant B sends steady traffic.  B's latency must
# hold, A must see only tenant-scoped 429s (never 5xx), steady state must
# not recompile, and A's SLO lane burns while B's stays green.
_TENANT_FLOOD_CHILD = _CHILD_PRELUDE + r'''
# two-tenant registry: "steady" (weight 4, unlimited, roomy SLO) is the
# default; "flood" (weight 1, 6 rps / burst 3) gets a tight latency
# lane its own queueing will burn while it floods
registry = os.path.join(workdir, "tenants.json")
with open(registry, "w") as f:
    json.dump({
        "default": "steady",
        "tenants": [
            {"name": "steady", "weight": 4.0, "slo_p99_ms": 60000.0},
            {"name": "flood", "weight": 1.0, "rps": 6.0, "burst": 3.0,
             "slo_p99_ms": 40.0},
        ],
    }, f)

config = build_config(
    serve_mode="continuous", serve_slot_pages=2, serve_page_width=2,
    serve_queue_depth=16, tenants=registry,
    slo_window_fast_s=1.5, slo_window_slow_s=3.0,
)
tel = telemetry.enable(capacity=16384)
init_checkpoint(config)
state, _ = load_serving_state(config)
engine = ServeEngine(config, state, vocabulary, tel=tel)
engine.warmup()
server = CaptionServer(config, engine, port=0).start()
port = server.port


def post(tenant, timeout=90.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/caption", data=jpeg, method="POST",
        headers={"Content-Type": "image/jpeg", "X-Tenant": tenant})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            body = json.loads(r.read())
            return (r.status, (time.perf_counter() - t0) * 1e3,
                    body, dict(r.headers))
    except urllib.error.HTTPError as e:
        body = json.loads(e.read())
        return (e.code, (time.perf_counter() - t0) * 1e3,
                body, dict(e.headers))


def get(route):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{route}", timeout=10) as r:
        return r.status, r.read()


def p99(vals):
    vals = sorted(vals)
    return vals[min(len(vals) - 1, int(0.99 * len(vals)))]


# phase A: steady alone — the isolation baseline
alone_ms = []
for _ in range(12):
    status, ms, body, _h = post("steady")
    assert status == 200, (status, body)
    alone_ms.append(ms)
compiles0 = builds(tel)

# phase B: flood hammers ~5x its quota while steady keeps its cadence
stop = threading.Event()
flood_out, lock = [], threading.Lock()


def flood_loop():
    while not stop.is_set():
        status, ms, body, headers = post("flood")
        with lock:
            flood_out.append(
                (status, body.get("shed_scope"),
                 headers.get("X-Shed-Scope"), headers.get("Retry-After")))
        time.sleep(0.01)


threads = [threading.Thread(target=flood_loop, daemon=True)
           for _ in range(3)]
for t in threads:
    t.start()
under_ms, steady_bad = [], []
for _ in range(12):
    status, ms, body, _h = post("steady")
    if status != 200:
        steady_bad.append((status, body))
    under_ms.append(ms)

# keep the flood RUNNING while the SLO engine ticks: the burn windows
# (fast 1.5s / slow 3.0s) only score live spans — stopping the flood
# first would age them out of the fast window before any tick saw them
flood_burning = 0
deadline = time.monotonic() + 25.0
while time.monotonic() < deadline and not flood_burning:
    if tel.gauges().get("slo/tenant_flood_p99_ms_burning") == 1:
        flood_burning = 1
    else:
        time.sleep(0.25)
gauges = tel.gauges()
# health is probed AT the burn moment: a tenant-lane burn must not
# flip the replica's fleet-facing health
health_status = json.loads(get("/healthz")[1]).get("status")
stop.set()
for t in threads:
    t.join(timeout=60)
counters = tel.counters()
_s, stats_raw = get("/stats")
stats = json.loads(stats_raw)
_s, metrics_raw = get("/metrics")
result = {
    "alone_p99_ms": round(p99(alone_ms), 1),
    "under_p99_ms": round(p99(under_ms), 1),
    "steady_bad": steady_bad,
    "flood_total": len(flood_out),
    "flood_statuses": sorted({s for s, *_ in flood_out}),
    "flood_shed": sum(1 for s, *_ in flood_out if s == 429),
    "flood_5xx": sum(1 for s, *_ in flood_out if s >= 500),
    "non_tenant_sheds": [
        r for r in flood_out
        if r[0] == 429 and (r[1] != "tenant" or r[2] != "tenant")
    ][:5],
    "zero_retry_after": sum(
        1 for s, _sc, _h, ra in flood_out
        if s == 429 and (not ra or int(ra) < 1)),
    "compile_delta": builds(tel) - compiles0,
    "flood_burning": flood_burning,
    "steady_burning": gauges.get("slo/tenant_steady_p99_ms_burning", 0),
    "flood_shed_counter": counters.get("serve/tenant_flood_shed", 0),
    "stats_tenants": sorted((stats.get("tenants") or {}).keys()),
    "metrics_has_tenant": b"serve/tenant_flood_shed" in metrics_raw,
    "health_status": health_status,
    **kernel_counts(stats),
}
server.shutdown()
print(json.dumps(result))
'''


@scenario
def tenant_flood_isolation(ctx: Ctx):
    """Acceptance: tenant A floods at ~5x its token-bucket
    quota while tenant B sends steady traffic through the same
    continuous-mode server.  B's p99 holds within margin of its
    flood-free baseline, A sees only tenant-scoped 429s (X-Shed-Scope:
    tenant, Retry-After >= 1, never a 5xx), steady state never
    recompiles, and A's SLO lane burns while B's stays green — without
    flipping the replica's fleet-facing health."""
    workdir = os.path.join(ctx.root, "tenant_flood")
    os.makedirs(workdir, exist_ok=True)
    result = _child_result(run_child(_TENANT_FLOOD_CHILD, workdir),
                           "tenant flood")
    check(result["steady_bad"] == [],
          f"steady tenant was not isolated: {result['steady_bad']}")
    margin = max(5.0 * result["alone_p99_ms"],
                 result["alone_p99_ms"] + 2000.0)
    check(result["under_p99_ms"] <= margin,
          f"steady p99 blew out under flood: {result['under_p99_ms']}ms "
          f"vs {result['alone_p99_ms']}ms alone (margin {margin:.0f}ms)")
    check(result["flood_5xx"] == 0,
          f"flood tenant saw {result['flood_5xx']} 5xx — overload must "
          "shed, not error")
    check(result["flood_shed"] >= 1,
          f"flood at 5x quota was never shed: {result['flood_statuses']}")
    check(set(result["flood_statuses"]) <= {200, 429},
          f"unexpected flood statuses: {result['flood_statuses']}")
    check(result["non_tenant_sheds"] == [],
          f"sheds without tenant scope: {result['non_tenant_sheds']}")
    check(result["zero_retry_after"] == 0,
          f"{result['zero_retry_after']} sheds carried a Retry-After < 1s")
    check(result["compile_delta"] == 0,
          f"steady state recompiled under flood: {result['compile_delta']}")
    check(result["flood_burning"] == 1,
          f"flood tenant's SLO lane never burned: "
          f"{result['flood_burning']}")
    check(result["steady_burning"] == 0,
          f"steady tenant's SLO lane burned: {result['steady_burning']}")
    check(result["health_status"] == "ok",
          f"a tenant-lane burn degraded the replica's fleet-facing "
          f"health: {result['health_status']!r}")
    check(result["flood_shed_counter"] >= 1
          and result["stats_tenants"] == ["flood", "steady"]
          and result["metrics_has_tenant"],
          "per-tenant counters missing from /stats+/metrics")
    return {**{k: result[k] for k in
               ("alone_p99_ms", "under_p99_ms", "flood_total", "flood_shed",
                "compile_delta")},
            **_kernels(result)}


_QUALITY_DRIFT_CHILD = _CHILD_PRELUDE + r'''
from sat_tpu_torch.telemetry.exemplar import load_image, read_exemplars

exdir = os.path.join(workdir, "exemplars")
config = build_config(
    serve_buckets=(1, 4), serve_max_batch=4,
    serve_quality="on", serve_quality_window=24,
    serve_quality_exemplar_dir=exdir,
    slo_quality_psi=0.2,
    slo_window_fast_s=1.5, slo_window_slow_s=3.0,
)
tel = telemetry.enable(capacity=16384)
# bias the eos logit so the random model seals captions with "." — the
# eos_trunc outlier reason must stay quiet in the control phase
eos = vocabulary.word2idx["."]


def bias_eos(params):
    params["decoder"]["decode"]["fc_2"]["bias"][eos] += 4.0


init_checkpoint(config, edit=bias_eos)
state, _ = load_serving_state(config)
engine = ServeEngine(config, state, vocabulary, tel=tel)
engine.warmup()
server = CaptionServer(config, engine, port=0).start()
port = server.port


def post(timeout=90.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/caption", data=jpeg, method="POST",
        headers={"Content-Type": "image/jpeg"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def get(route):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{route}", timeout=10) as r:
        return r.status, r.read()


# phase A (control arm): steady traffic on one repeated image freezes
# the reference and must capture ZERO exemplars — unremarkable traffic
# is not an outlier
for _ in range(32):
    status, body = post()
    assert status == 200, (status, body)
stats_control = json.loads(get("/stats")[1])
qc = stats_control.get("quality") or {}
control = {
    "requests": qc.get("requests"),
    "reference": qc.get("reference"),
    "psi_max": qc.get("psi_max"),
    "exemplars_recorded": (qc.get("exemplars") or {}).get("recorded"),
    "burning": tel.gauges().get("slo/quality_drift_burning", 0),
}
compiles0 = builds(tel)

# phase B: arm the score-space fault (read per-call, so flipping the
# env mid-run works) and keep serving the SAME image — captions must
# not change, but margins/norm-logprob shift hard off the reference
os.environ["SAT_FI_QUALITY_SKEW"] = "2000"  # 20.0 nats off the top beam
for _ in range(40):
    status, body = post()
    assert status == 200, (status, body)

drift_burning = 0
deadline = time.monotonic() + 25.0
while time.monotonic() < deadline and not drift_burning:
    if tel.gauges().get("slo/quality_drift_burning") == 1:
        drift_burning = 1
    else:
        time.sleep(0.25)
# health probed AT the burn moment: drift is diagnostic — a model
# problem the router cannot route away from — so /healthz stays ok
health_status = json.loads(get("/healthz")[1]).get("status")
stats = json.loads(get("/stats")[1])
q = stats.get("quality") or {}
metrics_raw = get("/metrics")[1]

# replay one captured exemplar through the engine directly (no batcher,
# no skew in that path): the caption must come back bitwise identical
rows, torn = read_exemplars(exdir)
replayable = [r for r in rows if r.get("image")]
replay = {"rows": len(rows), "torn": torn, "replayable": len(replayable)}
if replayable:
    row = replayable[-1]
    data = load_image(exdir, row)
    batch, _b = engine.pad_batch([engine.preprocess(data)])
    out = engine.dispatch(batch)
    res = engine.decode_output(out, 1)
    replay["captured"] = row.get("caption")
    replay["replayed"] = res[0]["captions"][0]["caption"]
    replay["bitwise"] = replay["captured"] == replay["replayed"]
    replay["reasons"] = row.get("reasons")

result = {
    "control": control,
    "drift_burning": drift_burning,
    "health_status": health_status,
    "psi_max": q.get("psi_max"),
    "outliers": q.get("outliers"),
    "exemplars_recorded": (q.get("exemplars") or {}).get("recorded"),
    "compile_delta": builds(tel) - compiles0,
    "metrics_has_quality": b"quality/psi_max" in metrics_raw,
    "replay": replay,
    **kernel_counts(json.loads(get("/stats")[1])),
}
server.shutdown()
print(json.dumps(result))
'''


@scenario
def quality_drift(ctx: Ctx):
    """Acceptance: a score-space fault (SAT_FI_QUALITY_SKEW)
    shifts beam scores under load on a quality-on server.  The control
    phase (same traffic, no skew) freezes the reference and captures
    ZERO exemplars; under skew the ``quality_drift`` SLO lane burns
    while /healthz stays ok (drift is diagnostic, not routable), the
    flight recorder captures drift exemplars, one replays bitwise
    through a skew-free engine, and the whole episode costs zero
    steady-state recompiles."""
    workdir = os.path.join(ctx.root, "quality_drift")
    os.makedirs(workdir, exist_ok=True)
    result = _child_result(run_child(_QUALITY_DRIFT_CHILD, workdir),
                           "quality drift")
    control = result["control"]
    check(control["reference"] == "warmup",
          f"reference never froze from warmup traffic: {control}")
    check(control["exemplars_recorded"] == 0,
          f"control arm captured exemplars: {control}")
    check(control["burning"] == 0,
          f"drift lane burned before any fault: {control}")
    check(result["drift_burning"] == 1,
          f"quality_drift lane never burned under skew "
          f"(psi_max {result['psi_max']})")
    check(result["health_status"] == "ok",
          f"a quality-lane burn degraded fleet-facing health: "
          f"{result['health_status']!r}")
    check((result["exemplars_recorded"] or 0) >= 1,
          f"no exemplars captured under drift: {result}")
    check(result["compile_delta"] == 0,
          f"quality skew recompiled steady state: "
          f"{result['compile_delta']}")
    check(result["metrics_has_quality"],
          "quality/* series missing from /metrics")
    replay = result["replay"]
    check(replay.get("bitwise") is True,
          f"exemplar did not replay bitwise: {replay}")
    check(any(str(r).startswith("drift_") for r in
              (replay.get("reasons") or [])),
          f"captured exemplar carries no drift reason: {replay}")
    return {
        "psi_max": result["psi_max"],
        "outliers": result["outliers"],
        "exemplars_recorded": result["exemplars_recorded"],
        "replayed_bitwise": replay.get("bitwise"),
        "compile_delta": result["compile_delta"],
        **_kernels(result),
    }


# -- orchestration ----------------------------------------------------------


def write_summary(path: str, argv: List[str], rows: List[dict]) -> None:
    """``summary.md``: the command, the device, each scenario's verdict,
    seconds and readings, and the pass rate."""
    stamp = rows[-1]
    device = stamp["device"]
    where = device.get("kind") or "cpu"
    if device.get("power_limit"):
        where += f", power limit {device['power_limit']}"
    lines = [
        "# Chaos campaign",
        "",
        f"`{' '.join(['python -m sat_tpu_torch.tools.chaos_campaign', *argv])}` on {where} "
        f"(host {device['host']}, git {stamp['git_sha']}).",
        "",
        "| Scenario | Verdict | Seconds | Readings |",
        "|---|---|---|---|",
    ]
    skip = set(stamp) | {"metric", "value", "unit", "vs_baseline", "seconds"}
    for row in rows[:-1]:
        readings = ", ".join(f"{k} {json.dumps(v)}" for k, v in row.items() if k not in skip)
        lines.append(f"| {row['metric'][len('chaos_'):]} | {'PASS' if row['value'] == 1.0 else 'FAIL'} | "
                     f"{row['seconds']} | {readings} |")
    lines += [
        "",
        f"Pass rate {stamp['value']} over {stamp['scenarios']} scenarios"
        + (f"; failed: {', '.join(stamp['failed'])}." if stamp["failed"] else "."),
        "",
    ]
    with open(path, "w") as f:
        f.write("\n".join(lines))


def main(argv=None) -> int:
    global _TIMEOUT, _CPU, _EXTRA_SET
    ap = argparse.ArgumentParser(prog="python -m sat_tpu_torch.tools.chaos_campaign",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--list", action="store_true",
                    help="print scenario names and exit")
    ap.add_argument("--only", default="",
                    help="comma-separated scenario subset")
    ap.add_argument("--out", default="",
                    help="write the campaign-report JSON array here too "
                    "(and summary.md beside it)")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--keep", action="store_true",
                    help="keep the workdir for inspection")
    ap.add_argument("--timeout", type=int, default=420,
                    help="per-child-run timeout, seconds")
    ap.add_argument("--cpu", action="store_true",
                    help="run every child on the CPU (default: the card)")
    ap.add_argument("--extra-set", action="append", default=[], metavar="KEY=VALUE",
                    help="Config overrides applied to every scenario's config, "
                    "the embedded children's too, after the small model")
    args = ap.parse_args(argv)
    _TIMEOUT = args.timeout
    _CPU = args.cpu
    _EXTRA_SET = list(args.extra_set)

    if args.list:
        for fn in SCENARIOS:
            print(f"{fn.__name__}: {' '.join(fn.__doc__.split())}")
        return 0

    selected = SCENARIOS
    if args.only:
        want = {s.strip() for s in args.only.split(",") if s.strip()}
        unknown = want - {fn.__name__ for fn in SCENARIOS}
        if unknown:
            print(f"unknown scenario(s): {sorted(unknown)}", file=sys.stderr)
            return 1
        selected = [fn for fn in SCENARIOS if fn.__name__ in want]

    # the card unless asked for the CPU: without one this raises here,
    # before any child runs (and the report rows then name the card)
    from ..device import resolve_device

    dev = resolve_device("cpu" if _CPU else None)
    for item in _EXTRA_SET:
        if "=" not in item:
            ap.error(f"--extra-set expects KEY=VALUE, got {item!r}")
    from ..config import Config

    extra_overrides(Config())   # an unknown field fails here, not in every scenario

    workdir = args.workdir or tempfile.mkdtemp(prefix="chaos_campaign_")
    made_workdir = args.workdir is None
    log(f"campaign of {len(selected)} scenario(s) under {workdir} on {dev}")
    rows, failed = [], []
    try:
        ctx = Ctx(workdir)
        for fn in selected:
            t0 = time.perf_counter()
            try:
                extras = fn(ctx) or {}
                ok = True
                detail = "ok"
            except Failure as e:
                ok, extras, detail = False, {}, str(e)
            except subprocess.TimeoutExpired as e:
                ok, extras = False, {}
                detail = f"child run timed out after {e.timeout}s"
            dt = time.perf_counter() - t0
            status = "PASS" if ok else "FAIL"
            log(f"{status} {fn.__name__} ({dt:.1f}s)"
                + ("" if ok else f" — {detail.splitlines()[0]}"))
            if not ok:
                failed.append(fn.__name__)
                print(f"--- {fn.__name__} failure detail ---\n{detail}",
                      file=sys.stderr, flush=True)
            rows.append({
                "metric": f"chaos_{fn.__name__}",
                "value": 1.0 if ok else 0.0,
                "unit": "pass",
                "vs_baseline": 1.0,
                "seconds": round(dt, 1),
                **extras,
                **telemetry.bench_stamp(),
            })
        rows.append({
            "metric": "chaos_pass_rate",
            "value": round(1.0 - len(failed) / max(1, len(selected)), 4),
            "unit": "fraction",
            "vs_baseline": 1.0,
            "scenarios": len(selected),
            "failed": failed,
            **telemetry.bench_stamp(),
        })
        report = json.dumps(rows, indent=1)
        print(report, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                f.write(report + "\n")
            write_summary(os.path.join(os.path.dirname(args.out) or ".", "summary.md"),
                          argv if argv is not None else sys.argv[1:], rows)
            log(f"report written to {args.out}")
        if failed:
            log(f"{len(failed)}/{len(selected)} scenario(s) FAILED: "
                + ", ".join(failed))
            return 1
        log(f"all {len(selected)} scenario(s) passed")
        return 0
    finally:
        if made_workdir and not args.keep:
            shutil.rmtree(workdir, ignore_errors=True)
        elif args.keep:
            log(f"workdir kept: {workdir}")


if __name__ == "__main__":
    sys.exit(main())
