"""The port's copies of sat_tpu's serve telemetry modules held to sat_tpu
on the same inputs: request ids, the Prometheus render, the metering
ledger, the capacity model and encode-cache sketch, the SLO engine, the
Chrome trace, the request tracer, the rotating sink, the flight recorder
— and the port's own torch.profiler latch, whose JAX twin needs
``jax.profiler``."""

import json
import os

import numpy as np
import pytest

from sat_tpu import telemetry as jtel
from sat_tpu.config import Config as JaxConfig
from sat_tpu.telemetry import blackbox as jblackbox
from sat_tpu.telemetry import capacity as jcapacity
from sat_tpu.telemetry import exporters as jexporters
from sat_tpu.telemetry import metering as jmetering
from sat_tpu.telemetry import promtext as jpromtext
from sat_tpu.telemetry import slo as jslo
from sat_tpu.telemetry import tracectx as jtracectx
from sat_tpu_torch import telemetry as ttel
from sat_tpu_torch.config import Config
from sat_tpu_torch.telemetry import blackbox as tblackbox
from sat_tpu_torch.telemetry import capacity as tcapacity
from sat_tpu_torch.telemetry import exporters as texporters
from sat_tpu_torch.telemetry import metering as tmetering
from sat_tpu_torch.telemetry import profwin as tprofwin
from sat_tpu_torch.telemetry import promtext as tpromtext
from sat_tpu_torch.telemetry import slo as tslo
from sat_tpu_torch.telemetry import tracectx as ttracectx

PACKAGES = {
    "jax": dict(tel=jtel, tracectx=jtracectx, promtext=jpromtext, metering=jmetering,
                capacity=jcapacity, slo=jslo, exporters=jexporters, blackbox=jblackbox),
    "torch": dict(tel=ttel, tracectx=ttracectx, promtext=tpromtext, metering=tmetering,
                  capacity=tcapacity, slo=tslo, exporters=texporters, blackbox=tblackbox),
}

# the run id and wall clocks are each package's own
VOLATILE = {"run_id", "wall_time", "t_unix", "time_unix", "os_pid", "pid", "mono_ns"}


def strip(obj):
    if isinstance(obj, dict):
        return {k: strip(v) for k, v in obj.items() if k not in VOLATILE}
    if isinstance(obj, (list, tuple)):
        return [strip(v) for v in obj]
    return obj


def feed(pkg, seed=0):
    """A registry of ``pkg``'s Telemetry fed counters, gauges and spans
    drawn from ``seed`` (the same for both packages)."""
    tel = PACKAGES[pkg]["tel"].Telemetry(capacity=1024)
    tel.anchor_ns, tel.anchor_unix = 1_000_000, 1.7e9
    rng = np.random.default_rng(seed)
    for name in ("serve/request", "serve/queue_wait", "serve/encode", "serve/step",
                 "serve/decode_window", "serve/steps_per_dispatch"):
        for k in range(int(rng.integers(3, 40))):
            tel.record(name, 1_000_000 + 10_000 * k, int(rng.integers(1, 3_000_000_000)))
    for name in ("serve/completed", "serve/http_5xx", "metering/default/device_ms", 'odd"name\\x'):
        tel.count(name, float(rng.integers(1, 100)) if "ms" in name else int(rng.integers(1, 100)))
    tel.gauge("serve/queue_depth", 3)
    tel.gauge("capacity/headroom_pct", 87.5)
    tel.gauge("serve/ready", True)
    return tel


@pytest.mark.parametrize(
    "raw", [None, "", "abc-123", "  a b\r\nc!! ", "x" * 500, "\r\n\r\n", "req:1.2_x-y"],
    ids=["none", "empty", "plain", "dirty", "long", "garbage", "charset"],
)
def test_ensure_id_matches(raw):
    got = {p: PACKAGES[p]["tracectx"].ensure_id(raw) for p in PACKAGES}
    minted = raw is None or not jtracectx._ID_RE.sub("", raw.strip())
    if minted:
        for rid in got.values():
            assert len(rid) == 16
            int(rid, 16)
        assert got["jax"] != got["torch"]
    else:
        assert got["jax"] == got["torch"]
    assert ttracectx.TRACE_HEADER == jtracectx.TRACE_HEADER and ttracectx.PHASES == jtracectx.PHASES


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_promtext_render_is_byte_identical(seed):
    from sat_tpu.serve.server import _HISTOGRAMS as jhist
    from sat_tpu_torch.serve.server import _HISTOGRAMS as thist

    assert thist == jhist
    extra = {"steps_per_s": 1.5, "phase": "serve", "uptime_s": 12, "queue_depth": 99}
    out = {p: PACKAGES[p]["promtext"].render(feed(p, seed), extra=extra, histograms=thist) for p in PACKAGES}
    assert out["torch"] == out["jax"]
    assert out["torch"].endswith("sat_up 1\n")
    assert tpromtext.CONTENT_TYPE == jpromtext.CONTENT_TYPE


def _charges(pkg, ledger):
    rng = np.random.default_rng(3)
    for i in range(17):
        cost = PACKAGES[pkg]["metering"].RequestCost()
        cost.add_encode(int(rng.integers(1, 10**7)))
        for _ in range(int(rng.integers(0, 4))):
            cost.add_decode(int(rng.integers(1, 10**7)), steps=int(rng.integers(1, 9)))
        cost.set_occupancy(int(rng.integers(1, 10**8)))
        ledger.charge(["a", "b", "default"][i % 3], cost=cost if i % 5 else None,
                      queue_ms=float(rng.random()), detok_ms=float(rng.random()), error=i % 4 == 0)


def test_metering_ledger_rows_and_totals_match(tmp_path):
    rows, snaps, attributed = {}, {}, {}
    for pkg in PACKAGES:
        mod = PACKAGES[pkg]["metering"]
        now = [0.0]
        path = str(tmp_path / pkg / "metering.jsonl")
        tel = PACKAGES[pkg]["tel"].Telemetry(capacity=256)
        ledger = mod.MeteringLedger(path=path, cap_bytes=0, tel=tel, flush_interval_s=5.0,
                                    clock=lambda: now[0])
        _charges(pkg, ledger)
        now[0] = 6.0
        ledger.maybe_flush()
        ledger.maybe_flush(force=True)  # nothing new: no rows
        with open(path, "a") as f:
            f.write('{"tenant": "a", "requests": 99')  # a torn tail (kill -9 mid append)
        rows[pkg] = strip(mod.read_ledger(path))
        snaps[pkg] = (ledger.snapshot(), mod.latest_totals(mod.read_ledger(path)))
        attributed[pkg] = (ledger.attributed_device_ms(), tel.counters())
        assert [r["tenant"] for r in rows[pkg]] == ["a", "b", "default"]
    assert rows["torch"] == rows["jax"]
    assert strip(snaps["torch"]) == strip(snaps["jax"])
    assert attributed["torch"] == attributed["jax"]
    assert tmetering.BUSY_SPANS == jmetering.BUSY_SPANS
    assert tmetering.measured_busy_ms(feed("torch")) == jmetering.measured_busy_ms(feed("jax"))


def test_capacity_model_and_sketch_match():
    gauges = {}
    for pkg in PACKAGES:
        mods = PACKAGES[pkg]
        tel = mods["tel"].Telemetry(capacity=256)
        ledger = mods["metering"].MeteringLedger(tel=tel)
        now = [0.0]
        sketch = mods["capacity"].EncodeCacheSketch(window=8)
        model = mods["capacity"].CapacityModel(tel, ledger, slots=4, interval_s=1.0, sketch=sketch,
                                               clock=lambda: now[0])
        rng = np.random.default_rng(5)
        trail = []
        for t in range(12):
            for _ in range(int(rng.integers(0, 6))):
                cost = mods["metering"].RequestCost()
                cost.set_occupancy(int(rng.integers(1e7, 9e8)))
                ledger.charge("default", cost=cost)
                trail.append(sketch.observe(int(rng.integers(0, 12))))
            tel.record("serve/steps_per_dispatch", 0, int(rng.integers(1, 9)))
            tel.count("serve/encode_images", int(rng.integers(1, 4)))
            tel.count("serve/encode_lane_slots", 4)
            now[0] = t * 0.7
            model.maybe_update()
            trail.append(dict(tel.gauges()))
        gauges[pkg] = (trail, sketch.lookups, sketch.hits, sketch.ratio())
    assert gauges["torch"] == gauges["jax"]


def test_slo_engine_verdicts_and_log_match(tmp_path):
    settings = dict(slo_serve_p99_ms=5.0, slo_error_ratio=0.2, slo_capacity_headroom_pct=40.0,
                    slo_window_fast_s=2.0, slo_window_slow_s=4.0)
    assert [o.__dict__ for o in tslo.objectives_from_config(Config(**settings), "serve")] == [
        o.__dict__ for o in jslo.objectives_from_config(JaxConfig(**settings), "serve")
    ]
    verdicts = {}
    for pkg in PACKAGES:
        mods = PACKAGES[pkg]
        tel = mods["tel"].Telemetry(capacity=1024)
        clock = [10**12]
        objectives = mods["slo"].objectives_from_config(
            (Config if pkg == "torch" else JaxConfig)(**settings), "serve")
        path = str(tmp_path / pkg / "slo.jsonl")
        engine = mods["slo"].SLOEngine(tel, objectives, jsonl_path=path, fast_s=2.0, slow_s=4.0,
                                       clock_ns=lambda: clock[0], wall_clock=lambda: 1.7e9)
        rng = np.random.default_rng(7)
        ticks = []
        for t in range(30):
            for _ in range(3):
                tel.record("serve/request", clock[0] - 10**6, int(rng.integers(1e6, 2e7 if t < 15 else 3e6)))
                tel.count("serve/http_requests")
                if t < 12 and rng.random() < 0.5:
                    tel.count("serve/http_5xx")
            tel.gauge("capacity/headroom_pct", 20.0 if 8 < t < 20 else 90.0)
            ticks.append(engine.tick())
            ticks.append(engine.burning())
            clock[0] += 250_000_000
        with open(path) as f:
            log = [json.loads(line) for line in f]
        verdicts[pkg] = (ticks, strip(log), engine.snapshot(), tel.gauges())
        assert {e["event"] for e in log} == {"burning", "ok"}
    assert verdicts["torch"] == verdicts["jax"]


def test_chrome_trace_and_request_lanes_match(tmp_path):
    docs = {}
    for pkg in PACKAGES:
        mods = PACKAGES[pkg]
        tel = feed(pkg, seed=4)
        tracer = mods["tracectx"].RequestTracer(path=str(tmp_path / pkg / "access.jsonl"), keep=4)
        records = []
        for i in range(6):
            trace = mods["tracectx"].RequestTrace(f"req{i}", t_start_ns=2_000_000 + i)
            for j, phase in enumerate(mods["tracectx"].PHASES[: 2 + i % 4]):
                trace.mark(phase, 2_000_000 + 1000 * j, 700 * (j + 1) - (1500 if i == 5 else 0))
            cost = mods["metering"].RequestCost()
            cost.add_encode(12345 * i)
            records.append(tracer.finish(trace, 200 if i % 3 else 500, 5_000_000 + i, bucket=4,
                                         error=None if i % 3 else "boom", cost=cost if i % 2 else None))
        events = tracer.trace_events(tel.anchor_ns, pid=0)
        path = str(tmp_path / pkg / "trace.json")
        assert mods["exporters"].export_chrome_trace(tel, path, extra_events=events) == path
        with open(path) as f:
            doc = json.load(f)
        with open(tmp_path / pkg / "access.jsonl") as f:
            log = [json.loads(line) for line in f]
        docs[pkg] = strip((doc, records, log, tracer.finished(),
                           mods["exporters"].chrome_trace(tel, extra_events=events)))
    assert docs["torch"] == docs["jax"]


def test_rotating_append_and_snapshot_rows_match(tmp_path):
    out = {}
    for pkg in PACKAGES:
        ex = PACKAGES[pkg]["exporters"]
        path = str(tmp_path / pkg / "x.jsonl")
        landed = [ex.rotating_append(path, json.dumps({"i": i, "pad": "y" * 40}), cap_bytes=200) for i in range(9)]
        tel = feed(pkg, seed=6)
        ex.append_jsonl(tel, str(tmp_path / pkg / "t.jsonl"), step=3)
        with open(path) as f, open(path + ".1") as g, open(tmp_path / pkg / "t.jsonl") as h:
            out[pkg] = (landed, f.read(), g.read(), strip(json.loads(h.read())),
                        strip(ex.snapshot_row(tel, step=7)))
        blocked = str(tmp_path / pkg / "file")
        open(blocked, "w").close()
        assert ex.rotating_append(os.path.join(blocked, "under.jsonl"), "{}", tel=tel) is False
        assert tel.counters()["telemetry/export_errors"] == 1
    assert out["torch"] == out["jax"]


def test_blackbox_ring_and_postmortem_match(tmp_path):
    bundles = {}
    for pkg in PACKAGES:
        bb_mod = PACKAGES[pkg]["blackbox"]
        bb_mod._reset_for_tests()
        tdir = tmp_path / pkg / "telemetry"
        tel = feed(pkg, seed=8)
        bb = bb_mod.BlackBox(str(tdir / "blackbox"), tel, segment_bytes=4096, segments=2)
        bb_mod.install(bb, telemetry_dir=str(tdir), config_snapshot={"phase": "serve", "seed": 8})
        flushed = []
        bb_mod.register_finalizer("probe", lambda: flushed.append(1))
        bb.event("serve_start", port=8700, model_step=5)
        for step in range(60):
            bb.journal(step)
        with open(tdir / "blackbox" / "seg_000.jsonl", "a") as f:
            f.write("{torn\n")
        (tdir / "slo.jsonl").write_text('{"event": "burning"}\n')
        records, torn = bb.read_all()
        path = bb_mod.dump("uncaught_exception", error="RuntimeError('x')")
        files = sorted(os.listdir(path))
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = strip(json.load(f))
        with open(os.path.join(path, "config.json")) as f:
            config = json.load(f)
        records = [{k: v for k, v in strip(r).items() if k != "t"} for r in records]  # wall clock
        bundles[pkg] = (files, manifest, config, torn, records, flushed,
                        sorted(os.listdir(os.path.join(path, "blackbox"))))
        bb_mod._reset_for_tests()
    # the dump's wall-clock-dependent fields were dropped by strip()
    bundles = {p: (b[0], {k: v for k, v in b[1].items() if k != "last_phase"}, *b[2:]) for p, b in bundles.items()}
    assert bundles["torch"] == bundles["jax"]
    assert bundles["torch"][5] == [1]  # the finalizer chain ran before the bundle was read


def test_profile_latch_contract(tmp_path):
    """One capture at a time, a clamped window, ``profiles/<ts>/trace.json``
    written, ``stop_now`` ending a capture early (the CPU capture; a card
    adds device activity)."""
    import torch

    latch = tprofwin.ProfileLatch(str(tmp_path), device=torch.device("cpu"))
    ok, out_dir = latch.start(60_000_000)  # clamped to the hard cap
    assert ok and out_dir.startswith(str(tmp_path / "profiles"))
    assert latch.start(10) == (False, "capture already in progress")
    assert latch.busy and latch.captures == 1
    torch.randn(32, 32) @ torch.randn(32, 32)
    latch.stop_now()  # early: the hard cap is a minute
    assert not latch.busy
    with open(os.path.join(out_dir, tprofwin.TRACE_FILE)) as f:
        assert "traceEvents" in json.load(f)
    ok, second = latch.start(1)
    assert ok and second != out_dir
    latch.wait(timeout=60)
    assert os.path.exists(os.path.join(second, tprofwin.TRACE_FILE)) and latch.captures == 2
    assert tprofwin.HARD_CAP_MS == 60_000.0
