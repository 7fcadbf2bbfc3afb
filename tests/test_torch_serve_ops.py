"""The port's serve operations layer on the CPU: the wedge watchdog with
degraded health and re-warm, request tracing and ``access.jsonl``,
``/metrics``, ``/profile``, metering and capacity, SLOs, the heartbeat,
the flight recorder and the trace export — held to sat_tpu's server on
the same float32 checkpoint (buckets 1 and 2), then the port's own
end-to-end cases, mirroring the JAX package's tests."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from sat_tpu_torch import telemetry
from sat_tpu_torch.data.vocabulary import Vocabulary
from sat_tpu_torch.serve.engine import ServeEngine, load_serving_state
from sat_tpu_torch.serve.server import CaptionServer
from sat_tpu_torch.telemetry.metering import measured_busy_ms
from tests.test_observability import parse_prometheus
from tests.test_torch_serve import _jpegs, make_checkpoint, serve_in_process

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GENEROUS_MS = 5000.0  # a real step on a loaded runner stays far inside it
POOL = dict(serve_slot_pages=2, serve_page_width=2)


def http(port, method, path, body=None, headers=None, timeout=120):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def post(port, body, headers=None):
    status, hdrs, raw = http(port, "POST", "/caption", body, {"Content-Type": "image/jpeg", **(headers or {})})
    return status, json.loads(raw), hdrs


def get_json(port, path):
    status, _, raw = http(port, "GET", path)
    return status, json.loads(raw)


def wait_for(predicate, timeout=60.0, poll=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(poll)
    return predicate()


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_ops")
    jc, tc, variables, vocab = make_checkpoint(root, serve_buckets=(1, 2), serve_max_batch=2, **POOL)
    tel = telemetry.enable()
    state, _ = load_serving_state(tc, device="cpu")
    vocabulary = Vocabulary(tc.vocabulary_size, tc.vocabulary_file)
    engine = ServeEngine(tc, state, vocabulary, device="cpu")
    engine.warmup()
    yield dict(root=root, jc=jc, tc=tc, engine=engine, tel=tel, jpegs=_jpegs(4, seed=11))
    telemetry.disable()


def boot(stack, tmp_path, **overrides):
    config = stack["tc"].replace(telemetry_dir=str(tmp_path / "telemetry"), **overrides)
    return CaptionServer(config, stack["engine"], port=0, host="127.0.0.1").start()


# ---------------------------------------------------------------------------
# the slice against sat_tpu's server
# ---------------------------------------------------------------------------

# /stats fields of sat_tpu's server with no counterpart: the XLA compile
# ledger (nothing is compiled ahead here).  /healthz has them all since the
# lifecycle plane was ported.
JAX_ONLY_STATS = {"warm_compiles", "compiles_since_ready"}
JAX_ONLY_HEALTHZ = set()
# the port's own /stats fields: the kernel launch counts and the device
PORT_ONLY_STATS = {"kernels", "device"}


def test_ops_layer_matches_jax_server(stack, tmp_path):
    """The same requests to sat_tpu's CaptionServer and the port's on one
    float32 checkpoint: captions bitwise, the key sets of /healthz,
    /stats and an access.jsonl record equal but for the named fields,
    and the same /metrics families."""
    from sat_tpu import telemetry as jtelemetry
    from sat_tpu.data.vocabulary import Vocabulary as JaxVocabulary
    from sat_tpu.serve.engine import ServeEngine as JaxEngine
    from sat_tpu.serve.engine import load_serving_state as jax_load
    from sat_tpu.serve.server import CaptionServer as JaxServer

    jc = stack["jc"].replace(telemetry_dir=str(tmp_path / "jax"))
    jtel = jtelemetry.enable()
    try:
        jstate, _ = jax_load(jc)
        jengine = JaxEngine(jc, jstate, JaxVocabulary(jc.vocabulary_size, jc.vocabulary_file), tel=jtel)
        jengine.warmup()
        servers = {"jax": JaxServer(jc, jengine, port=0).start(), "torch": boot(stack, tmp_path / "torch")}
        out = {}
        try:
            for name, server in servers.items():
                replies = [post(server.port, b)[1] for b in stack["jpegs"][:3]]
                wait_for(lambda: server.heartbeat is not None and os.path.exists(server.heartbeat.path))
                out[name] = dict(
                    replies=replies,
                    healthz=get_json(server.port, "/healthz")[1],
                    stats=get_json(server.port, "/stats")[1],
                    access=server.tracer.finished()[-1],
                    metrics=http(server.port, "GET", "/metrics")[2].decode(),
                )
        finally:
            for server in servers.values():
                server.shutdown()
    finally:
        jtelemetry.disable()
    for j, t in zip(out["jax"]["replies"], out["torch"]["replies"]):
        assert [c["caption"] for c in t["captions"]] == [c["caption"] for c in j["captions"]]
        np.testing.assert_allclose([c["log_prob"] for c in t["captions"]],
                                   [c["log_prob"] for c in j["captions"]], rtol=0, atol=1e-5)
        assert set(t) == set(j) and (t["slot"], t["model_step"]) == (j["slot"], j["model_step"])
    assert set(out["torch"]["healthz"]) == set(out["jax"]["healthz"]) - JAX_ONLY_HEALTHZ
    assert set(out["torch"]["stats"]) - PORT_ONLY_STATS == set(out["jax"]["stats"]) - JAX_ONLY_STATS
    assert set(out["torch"]["stats"]["latency_ms"]) == set(out["jax"]["stats"]["latency_ms"])
    assert set(out["torch"]["stats"]["tenants_cost"]["default"]) == set(out["jax"]["stats"]["tenants_cost"]["default"])
    assert set(out["torch"]["access"]) == set(out["jax"]["access"])
    assert set(out["torch"]["access"]["phases"]) == set(out["jax"]["access"]["phases"])

    def families(text):
        return {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE")}

    assert families(out["torch"]["metrics"]) == families(out["jax"]["metrics"])


def test_default_wait_matches_jax():
    from sat_tpu.serve.server import CaptionServer as JaxServer

    assert CaptionServer.DEFAULT_WAIT_S == JaxServer.DEFAULT_WAIT_S == 120.0


# ---------------------------------------------------------------------------
# the wedge watchdog
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["batch", "continuous"])
def test_wedge_fails_fast_degrades_then_rewarms(stack, tmp_path, monkeypatch, mode):
    """SAT_FI_WEDGE_SERVE_BATCH=1: the first batch (window) wedges, its
    request gets a fast 500, /healthz degrades to 503 while the engine
    (pool) re-warms, then ok; the next request serves the same words as
    a server without the fault, and no slot stays bound."""
    engine, tel = stack["engine"], stack["tel"]
    jpeg = stack["jpegs"][0]
    clean = boot(stack, tmp_path / "clean", serve_mode=mode)
    try:
        want = post(clean.port, jpeg)[1]["captions"]
    finally:
        clean.shutdown()
    if mode == "batch":
        real_warmup = engine.warmup

        def slow_warmup(*a, **k):  # hold the degraded window open to see it
            time.sleep(0.5)
            return real_warmup(*a, **k)

        monkeypatch.setattr(engine, "warmup", slow_warmup)
    wedged0 = tel.counters().get("serve/wedged_batches", 0)
    rewarms0 = tel.counters().get("serve/rewarms", 0)
    monkeypatch.setenv("SAT_FI_WEDGE_SERVE_BATCH", "1")  # read at construction
    server = boot(stack, tmp_path, serve_mode=mode, serve_wedge_timeout_ms=2500.0)
    if mode == "continuous":
        pool_warmup = server.pool.warmup

        def slow_pool_warmup(*a, **k):
            time.sleep(0.5)
            return pool_warmup(*a, **k)

        monkeypatch.setattr(server.pool, "warmup", slow_pool_warmup)
    try:
        t0 = time.monotonic()
        status, payload, hdrs = post(server.port, jpeg)
        assert status == 500 and "wedged" in payload["error"], payload
        assert time.monotonic() - t0 < 30.0 and hdrs["X-Request-Id"] == payload["request_id"]
        assert tel.counters()["serve/wedged_batches"] == wedged0 + 1
        # the hook flips health just after the 500s go out (as in sat_tpu)
        saw = wait_for(lambda: get_json(server.port, "/healthz")[1]["status"] == "degraded"
                       or tel.counters().get("serve/rewarms", 0) > rewarms0, timeout=10)
        assert saw, get_json(server.port, "/healthz")
        assert wait_for(lambda: get_json(server.port, "/healthz")[0] == 200, timeout=60)
        assert tel.counters()["serve/rewarms"] == rewarms0 + 1
        status, payload, _ = post(server.port, jpeg)
        assert status == 200 and payload["captions"] == want
        if mode == "continuous":
            assert server.pool.occupancy() == 0
            assert get_json(server.port, "/stats")[1]["slot_pool"]["busy"] == 0
    finally:
        server.shutdown()


@pytest.mark.parametrize("mode", ["batch", "continuous"])
def test_watchdog_without_a_fault_is_bitwise(stack, tmp_path, mode):
    """A server with the watchdog armed and no fault captions bitwise
    like one without it (the bounded region runs the same code on a
    helper thread)."""
    replies = {}
    for wedge_ms in (0.0, GENEROUS_MS):
        server = boot(stack, tmp_path / str(wedge_ms), serve_mode=mode, serve_wedge_timeout_ms=wedge_ms)
        try:
            replies[wedge_ms] = [post(server.port, b)[1]["captions"] for b in stack["jpegs"]]
        finally:
            server.shutdown()
    assert replies[GENEROUS_MS] == replies[0.0]


def test_real_stall_is_bounded_while_healthz_answers(stack, tmp_path):
    """A device region that stalls (here the host sleeps inside it) past
    the timeout fails with 500 while /healthz keeps answering."""
    engine = stack["engine"]
    encode_batch = engine.encode_batch
    armed = [True]

    def stalled(images, *args, **kwargs):
        if armed[0]:
            armed[0] = False
            time.sleep(3.0)
        return encode_batch(images, *args, **kwargs)

    engine.encode_batch = stalled
    try:
        server = boot(stack, tmp_path, serve_wedge_timeout_ms=1000.0)
        try:
            box = {}
            th = threading.Thread(target=lambda: box.update(reply=post(server.port, stack["jpegs"][1])))
            th.start()
            polls = []
            while th.is_alive():
                t = time.monotonic()
                polls.append((get_json(server.port, "/healthz")[0], time.monotonic() - t))
                time.sleep(0.1)
            assert box["reply"][0] == 500 and polls and max(p[1] for p in polls) < 2.0
            assert wait_for(lambda: get_json(server.port, "/healthz")[0] == 200, timeout=60)
        finally:
            server.shutdown()
    finally:
        engine.encode_batch = encode_batch


# ---------------------------------------------------------------------------
# tracing, /metrics, /profile
# ---------------------------------------------------------------------------


def test_request_ids_phases_metrics_and_profile(stack, tmp_path):
    server = boot(stack, tmp_path)
    try:
        port = server.port
        status, payload, hdrs = post(port, stack["jpegs"][0], {"X-Request-Id": "client-42"})
        assert status == 200 and hdrs["X-Request-Id"] == "client-42" == payload["request_id"]
        status, payload, hdrs = post(port, stack["jpegs"][1])
        minted = hdrs["X-Request-Id"]
        assert status == 200 and len(minted) == 16 and payload["request_id"] == minted
        status, payload, hdrs = post(port, b"not an image", {"X-Request-Id": "bad\r\n one"})
        assert status == 400 and hdrs["X-Request-Id"] == "badone"
        for method, path in (("GET", "/nope"), ("POST", "/nope"), ("GET", "/healthz"), ("GET", "/metrics")):
            _, hdrs, _ = http(port, method, path)
            assert len(hdrs["X-Request-Id"]) == 16
        records = [json.loads(line) for line in open(tmp_path / "telemetry" / "access.jsonl")]
        assert [r["status"] for r in records] == [200, 200, 400]
        assert records[0]["trace_id"] == "client-42" and records[1]["trace_id"] == minted
        for r in records[:2]:
            assert set(r["phases"]) == {f"{p}_ms" for p in ("queue_wait", "batch_form", "dispatch", "drain", "detok")}
            assert sum(r["phases"].values()) <= r["total_ms"] + 1e-3
            assert r["cost"]["device_ms"] > 0 and r["bucket"] == 1
        samples = parse_prometheus(http(port, "GET", "/metrics")[2].decode())
        assert samples[("sat_up", "")] == 1.0
        assert samples[("sat_counter_total", 'name="serve/completed"')] >= 2
        assert samples[("sat_request_latency_seconds_count", "")] >= 2
        status, _, raw = http(port, "POST", "/profile?duration_ms=200")
        assert status == 200
        out_dir = json.loads(raw)["profile_dir"]
        assert http(port, "POST", "/profile?duration_ms=200")[0] == 409
        assert http(port, "POST", "/profile?duration_ms=soon")[0] == 400
        server.profiles.wait(timeout=60)
        assert os.path.exists(os.path.join(out_dir, "trace.json"))
        stats = get_json(port, "/stats")[1]
        assert stats["profile_captures"] == 1 and stats["latency_ms"]["serve/request"]["count"] >= 2
    finally:
        server.shutdown()


def test_draining_and_shed_replies_carry_ids_and_retry_after(stack, tmp_path):
    server = boot(stack, tmp_path, serve_queue_depth=1)
    try:
        server._ready = False  # the first step of the drain sequence
        status, payload, hdrs = post(server.port, stack["jpegs"][0], {"X-Request-Id": "late-1"})
        assert status == 503 and hdrs["X-Request-Id"] == "late-1"
        assert int(hdrs["Retry-After"]) >= 1 and hdrs["X-Shed-Scope"] == "global"
        assert payload["shed_scope"] == "global" and payload["retry_after_ms"] >= 50
        status, health = get_json(server.port, "/healthz")
        assert status == 503 and health["status"] == "draining" and not health["ready"]
    finally:
        server.shutdown()


# ---------------------------------------------------------------------------
# SLOs, metering, capacity
# ---------------------------------------------------------------------------


def test_slo_burn_degrades_health(stack, tmp_path, monkeypatch):
    monkeypatch.setenv("SAT_FI_SLOW_SERVE_MS", "50")  # read at construction
    server = boot(stack, tmp_path, slo_serve_p99_ms=5.0, slo_window_fast_s=2.0, slo_window_slow_s=4.0)
    try:
        deadline = time.monotonic() + 60.0
        burning = []
        while time.monotonic() < deadline and not burning:
            assert post(server.port, stack["jpegs"][0])[0] == 200
            burning = server.slo.burning()
        assert burning == ["serve_p99_ms"]
        status, health = get_json(server.port, "/healthz")
        assert (status, health["status"], health["slo_burning"]) == (503, "degraded", ["serve_p99_ms"])
        events = [json.loads(line) for line in open(tmp_path / "telemetry" / "slo.jsonl")]
        assert any(e["event"] == "burning" and e["name"] == "serve_p99_ms" for e in events)
        assert server.tracer.finished()[-1]["phases"]["drain_ms"] >= 50.0
    finally:
        server.shutdown()


@pytest.mark.parametrize("mode", ["batch", "continuous"])
def test_metering_identity_ledger_and_capacity(stack, tmp_path, mode):
    """Attributed device-ms ≈ the measured busy spans within 5% (exact
    up to integer division) over a burst; the ledger, /stats and
    /metrics carry the costs."""
    tel = stack["tel"]
    server = boot(stack, tmp_path, serve_mode=mode)
    try:
        busy0, attr0 = measured_busy_ms(tel), server.metering.attributed_device_ms()
        threads = [threading.Thread(target=post, args=(server.port, stack["jpegs"][i % 4])) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        attributed = server.metering.attributed_device_ms() - attr0
        measured = measured_busy_ms(tel) - busy0
        assert measured > 0 and abs(attributed - measured) <= 0.05 * measured
        stats = get_json(server.port, "/stats")[1]
        assert stats["tenants_cost"]["default"]["requests"] == 6
        assert stats["capacity"]["headroom_pct"] <= 100.0 and "ceiling_captions_per_s" in stats["capacity"]
        text = http(server.port, "GET", "/metrics")[2].decode()
        assert 'sat_counter_total{name="metering/default/device_ms"}' in text
        assert 'sat_gauge{name="capacity/headroom_pct"}' in text
    finally:
        server.shutdown()
    from sat_tpu_torch.telemetry.metering import latest_totals, read_ledger

    totals = latest_totals(read_ledger(str(tmp_path / "telemetry" / "metering.jsonl")))
    assert totals["default"]["requests"] == 6 and totals["default"]["schema"] == 1


def test_metering_off_writes_no_ledger(stack, tmp_path):
    server = boot(stack, tmp_path, serve_metering=False)
    try:
        assert server.metering is None and server.capacity is None
        assert post(server.port, stack["jpegs"][0])[0] == 200
        stats = get_json(server.port, "/stats")[1]
        assert "tenants_cost" not in stats and "capacity" not in stats
    finally:
        server.shutdown()
    assert not (tmp_path / "telemetry" / "metering.jsonl").exists()
    assert (tmp_path / "telemetry" / "access.jsonl").exists()


# each serve knob of the operations layer acts (none is accepted and ignored)
KNOBS = {
    "heartbeat_interval": (dict(heartbeat_interval=0.0), lambda s, d: s.heartbeat is None),
    "serve_metering": (dict(serve_metering=False), lambda s, d: s.metering is None),
    "slo_serve_p99_ms": (dict(slo_serve_p99_ms=200.0), lambda s, d: [o.name for o in s.slo.objectives] == ["serve_p99_ms"]),
    "slo_error_ratio": (dict(slo_error_ratio=0.1), lambda s, d: s.slo.objectives[0].source == "serve/http_5xx"),
    "slo_capacity_headroom_pct": (dict(slo_capacity_headroom_pct=20.0),
                                  lambda s, d: s.slo.objectives[0].name == "capacity_headroom"),
    "slo_window_fast_s": (dict(slo_window_fast_s=7.0), lambda s, d: s.slo.fast_s == 7.0),
    "slo_window_slow_s": (dict(slo_window_slow_s=70.0), lambda s, d: s.slo.slow_s == 70.0),
    "telemetry_dir": (dict(), lambda s, d: os.path.exists(os.path.join(d, "heartbeat.json"))),
    "telemetry_log_cap_mb": (dict(telemetry_log_cap_mb=0.000001), lambda s, d: s.tracer.cap_bytes == 1),
}


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_serve_knob_acts(stack, tmp_path, knob):
    overrides, check = KNOBS[knob]
    overrides = dict(overrides)
    server = boot(stack, tmp_path, heartbeat_interval=overrides.pop("heartbeat_interval", 0.2), **overrides)
    try:
        wait_for(lambda: server.heartbeat is None or os.path.exists(server.heartbeat.path), timeout=10)
        assert check(server, str(tmp_path / "telemetry"))
    finally:
        server.shutdown()


# ---------------------------------------------------------------------------
# serve(): the flight recorder, SIGTERM through the CLI
# ---------------------------------------------------------------------------


def test_flight_recorder_bundle_on_uncaught_exception(stack, tmp_path, monkeypatch):
    from sat_tpu_torch.serve import server as server_mod
    from sat_tpu_torch.serve.server import serve
    from sat_tpu_torch.telemetry import blackbox

    def boom(self, *a, **k):
        self.shutdown()
        raise RuntimeError("listener died")

    monkeypatch.setattr(server_mod.CaptionServer, "serve_until_shutdown", boom)
    tdir = tmp_path / "telemetry"
    config = stack["tc"].replace(blackbox=True, telemetry_dir=str(tdir), heartbeat_interval=0.0)
    try:
        with pytest.raises(RuntimeError, match="listener died"):
            serve(config, device="cpu")
    finally:
        blackbox.uninstall()
        telemetry.disable()
        stack["tel"] = telemetry.enable()
        stack["engine"]._tel = stack["tel"]
    bundles = list(tdir.glob("postmortem_*"))
    assert len(bundles) == 1
    manifest = json.loads((bundles[0] / "manifest.json").read_text())
    assert manifest["reason"] == "uncaught_exception" and "listener died" in manifest["error"]
    events = [json.loads(line)["event"] for line in (tdir / "blackbox" / "seg_000.jsonl").read_text().splitlines()]
    assert events == ["serve_start", "uncaught_exception"]
    assert json.loads((bundles[0] / "config.json").read_text())["blackbox"] is True


def test_sigterm_in_process_drains_and_writes_every_artifact(stack, tmp_path):
    """serve() at the defaults with a trace export: SIGTERM drains, exit
    0, and heartbeat.json (final), access.jsonl, metering.jsonl and
    trace.json are written."""
    tdir = tmp_path / "telemetry"
    config = stack["tc"].replace(telemetry_dir=str(tdir), trace_export=str(tmp_path / "trace.json"))
    try:
        rc, status = serve_in_process(config, until=lambda port: post(port, stack["jpegs"][0])[0])
    finally:
        stack["tel"] = telemetry.enable()
        stack["engine"]._tel = stack["tel"]
    assert (rc, status) == (0, 200)
    beat = json.loads((tdir / "heartbeat.json").read_text())
    assert beat["serve"]["ready"] == 0 and beat["counters"]["serve/completed"] == 1
    assert len((tdir / "access.jsonl").read_text().splitlines()) == 1
    assert (tdir / "metering.jsonl").exists() and not list(tdir.glob("postmortem_*"))
    assert json.loads((tmp_path / "trace.json").read_text())["traceEvents"]


SERVE_CLI = r"""
import sys, torch
torch.set_num_threads(2)
import sat_tpu_torch.serve.engine as engine
engine.resolve_device = lambda device=None: torch.device("cpu")
from sat_tpu_torch import cli
sys.exit(cli.main(sys.argv[1:]))
"""


def test_sigterm_drains_through_the_cli(stack, tmp_path):
    """``python -m sat_tpu_torch.cli --phase serve`` (the device resolved
    to the CPU): a request, then SIGTERM → exit 0, "serve drained
    cleanly", the flight recorder's clean journal and no bundle."""
    tdir = tmp_path / "telemetry"
    cfg = tmp_path / "config.json"
    stack["tc"].replace(telemetry_dir=str(tdir)).save(str(cfg))
    proc = subprocess.Popen(
        [sys.executable, "-c", SERVE_CLI, "--config", str(cfg), "--phase", "serve", "--port", "0",
         "--heartbeat_interval", "0.2", "--blackbox", "--trace_export", str(tmp_path / "trace.json")],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        def ready_beat():
            # the heartbeat starts before the server turns ready, and a
            # request before that gets 503: wait for a beat that says ready
            if not (tdir / "heartbeat.json").exists():
                return None
            beat = json.loads((tdir / "heartbeat.json").read_text() or "{}")
            return beat if beat.get("serve", {}).get("ready") else None

        beat = wait_for(ready_beat, timeout=120)
        assert beat and beat["port"], proc.stderr
        status, payload, _ = post(beat["port"], stack["jpegs"][2])
        assert status == 200, payload
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert "serve drained cleanly" in err
    events = [json.loads(line)["event"] for line in (tdir / "blackbox" / "seg_000.jsonl").read_text().splitlines()]
    assert events == ["serve_start", "serve_drained"]
    assert not list(tdir.glob("postmortem_*"))
    lanes = [e for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
             if e.get("cat") == "request" and e["name"].startswith("request ")]
    assert len(lanes) == 1


# ---------------------------------------------------------------------------
# the CLI flags and what stays refused
# ---------------------------------------------------------------------------

OPS_ARGV = ["--phase", "serve", "--heartbeat_interval", "2.5", "--trace_export", "/tmp/t.json", "--blackbox",
            "--serve_metering", "off", "--slo_capacity_headroom_pct", "15"]
OPS_FIELDS = ("heartbeat_interval", "trace_export", "blackbox", "telemetry", "serve_metering",
              "slo_capacity_headroom_pct")


def test_cli_takes_the_ops_flags_as_jax_does():
    from sat_tpu.cli import build_config as jax_build
    from sat_tpu_torch.cli import build_config

    config, _ = build_config(OPS_ARGV)
    jax_config = jax_build(OPS_ARGV)[0]
    got = {f: getattr(config, f) for f in OPS_FIELDS}
    assert got == {f: getattr(jax_config, f) for f in OPS_FIELDS}
    assert got == dict(heartbeat_interval=2.5, trace_export="/tmp/t.json", blackbox=True, telemetry=True,
                       serve_metering=False, slo_capacity_headroom_pct=15.0)
    assert build_config(["--phase", "serve", "--telemetry"])[0].telemetry is True


@pytest.mark.parametrize(
    "knob", [{"serve_wedge_timeout_ms": 250.0}, {"blackbox": True}, {"trace_export": "t.json"}],
    ids=lambda k: next(iter(k)),
)
def test_ops_knobs_pass_the_serve_check(stack, tmp_path, knob):
    """Serve has no knob check left: a server on each knob boots, answers
    a request and drains (``trace_export`` writes its trace then)."""
    from sat_tpu_torch.serve import engine as engine_mod

    assert not hasattr(engine_mod, "check_ported")
    if "trace_export" in knob:
        knob = {"trace_export": str(tmp_path / knob["trace_export"])}
    server = boot(stack, tmp_path, **knob)
    try:
        assert post(server.port, stack["jpegs"][0])[0] == 200
    finally:
        server.shutdown()
    if "trace_export" in knob:
        assert os.path.isfile(knob["trace_export"])


def _acting_server(stack, tmp_path, knob):
    """A server on a fresh engine built with ``knob`` (the cache, the
    quality plane and the alphas are fixed at engine construction)."""
    config = stack["tc"].replace(telemetry_dir=str(tmp_path / "telemetry"), **knob)
    state, _ = load_serving_state(config, device="cpu")
    engine = ServeEngine(config, state, Vocabulary(config.vocabulary_size, config.vocabulary_file), device="cpu")
    engine.warmup()
    return CaptionServer(config, engine, port=0, host="127.0.0.1").start()


@pytest.mark.parametrize(
    "knob",
    [{"encode_cache": "on"}, {"serve_quality": "on"}, {"serve_tier": "encode"}, {"tenants": "a:1"},
     {"model_reload": 1.0}],
    ids=lambda k: next(iter(k)),
)
def test_later_serve_items_stay_refused(stack, tmp_path, knob):
    """The five serve knobs the earlier slices refused are accepted now,
    and each acts: its /stats block shows it, or its counter moves."""
    name = next(iter(knob))
    server = _acting_server(stack, tmp_path, knob)
    try:
        jpeg = stack["jpegs"][0]
        statuses = [post(server.port, jpeg)[0] for _ in range(2)]
        if name == "serve_tier":
            status, hdrs, _ = http(server.port, "POST", "/encode", jpeg, {"Content-Type": "image/jpeg"})
            assert status == 200 and hdrs["Content-Type"] == "application/x-sat-grid"
        stats = get_json(server.port, "/stats")[1]
        healthz = get_json(server.port, "/healthz")[1]
        reloader = server.lifecycle.reloader
        polling = reloader is not None and reloader._thread.is_alive()
    finally:
        server.shutdown()
    assert statuses == [200, 200]
    if name == "encode_cache":
        assert (stats["encode_cache"]["misses"], stats["encode_cache"]["hits"]) == (1, 1)
    elif name == "serve_quality":
        assert stats["quality"]["requests"] == 2
    elif name == "serve_tier":
        assert healthz["tier"] == stats["tier"] == "encode" and stats["counters"]["serve/encode_http"] == 1
    elif name == "tenants":
        assert stats["tenants"]["a"]["requests"] == 2 and healthz["tenants"] == ["a"]
    else:
        # the LAST_GOOD poller runs (its step is the one serving: no cycle)
        assert stats["lifecycle"]["reload_poll_s"] == 1.0 and polling and server.lifecycle.reloader is None
        assert healthz["lifecycle_state"] == "IDLE"


def stack_free_config(**kw):
    from tests.torch_port_helpers import configs

    return configs(**kw)[1]
