"""The port's fleet router (``sat_tpu_torch.serve.router``) held to
sat_tpu's (``tests/test_router.py``).

* The pure routing math — ``replica_weight``, ``effective_load``,
  ``pick_replica``, ``merge_fleet`` and ``straggler_verdict`` — returns
  exactly what sat_tpu's returns on the JAX tests' inputs.
* Config validation, ``parse_endpoints`` and the CLI's route flags.
* Scripted stub replicas (``tests/test_router.py``'s): pick, burst
  balance, the single retry, the 502 hint, the coherent shed, drain
  sequencing, the proactive shed and the tiered two-hop proxy, against
  real sockets.
* End to end on the CPU: two in-process port ``CaptionServer``s behind the
  port's ``Router`` (request ids stitched across the hop, replies
  bitwise those of one port server alone, words those of sat_tpu's
  server on the same checkpoint, ``/stats`` and ``/metrics`` with the key
  sets of sat_tpu's router over sat_tpu's replicas), and both mixed
  fleets (sat_tpu's router over the port's replicas, the port's router
  over sat_tpu's).
* One spawn: ``python -m sat_tpu_torch.cli --phase route --num_replicas
  2`` with ``SAT_TORCH_DEVICE=cpu`` — ready, one caption, SIGTERM, exit 0,
  both children gone.
"""

import copy
import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from sat_tpu.serve import router as jax_router
from sat_tpu.telemetry import fleet as jax_fleet
from sat_tpu_torch import telemetry
from sat_tpu_torch.config import Config
from sat_tpu_torch.serve import router
from sat_tpu_torch.serve.replica import Endpoint, free_port, parse_endpoints
from sat_tpu_torch.serve.router import Router
from sat_tpu_torch.telemetry import fleet, tracectx
from tests.test_router import StubReplica, _snap
from tests.test_torch_serve import _jpegs, make_checkpoint
from tests.test_torch_serve_ops import get_json, http
from tests.torch_planes_helpers import boot, jax_engine, port_engine, registries

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---------------------------------------------------------------------------
# Pure routing math: the same answers as sat_tpu's on the JAX tests' inputs
# ---------------------------------------------------------------------------

_FLEETS = {
    "degraded": (
        {"r0": _snap(status="degraded", degraded=True), "r1": _snap(queue_depth=5)},
        {"r0": "in", "r1": "in"}, 2.0, 0.25,
    ),
    "straggler": (
        {"r0": _snap(p50_ms=100.0, p99_ms=100.0), "r1": _snap(p50_ms=110.0, p99_ms=120.0),
         "r2": _snap(p50_ms=150.0, p99_ms=900.0)},
        {"r0": "in", "r1": "in", "r2": "in"}, 2.0, 0.5,
    ),
    "drain_unreachable": (
        {"r0": _snap(), "r1": _snap(reachable=False, ready=False, status="unreachable"), "r2": _snap()},
        {"r0": "in", "r1": "in", "r2": "draining"}, 2.0, 0.25,
    ),
    "tiers": (
        {"r0": _snap(tier="encode", p50_ms=20.0, p99_ms=30.0), "r1": _snap(tier="decode", in_flight=2),
         "r2": _snap(tier="both", tenants_cost={"a": {"requests": 2, "device_ms": 3.5}},
                     capacity_headroom_pct=40.0)},
        {"r0": "in", "r1": "in", "r2": "in"}, 2.0, 0.25,
    ),
}

_CASES = [
    ("replica_weight", (False, False, 0.25), 1.0),
    ("replica_weight", (True, False, 0.25), 0.25),
    ("replica_weight", (False, True, 0.25), 0.25),
    ("replica_weight", (True, True, 0.25), 0.0625),
    ("effective_load", (0, 0, 1.0), 1.0),
    ("effective_load", (0, 0, 0.25), 4.0),
    ("effective_load", (3, 2, 1.0), 6.0),
    ("effective_load", (-5, -5, 1.0), 1.0),
    ("effective_load", (0, 0, 0.0), float("inf")),
    ("pick_replica", ({"r0": 2.0, "r1": 1.0}, None, 0.25), "r1"),
    ("pick_replica", ({"r0": 1.2, "r1": 1.0}, "r0", 0.25), "r0"),
    ("pick_replica", ({"r0": 1.3, "r1": 1.0}, "r0", 0.25), "r1"),
    ("pick_replica", ({"r0": 2.0, "r1": 1.0}, "gone", 0.25), "r1"),
    ("pick_replica", ({}, None, 0.25), None),
]


@pytest.mark.parametrize("fn,args,want", _CASES, ids=[f"{c[0]}-{i}" for i, c in enumerate(_CASES)])
def test_routing_math_returns_what_jax_returns(fn, args, want):
    got = getattr(router, fn)(*copy.deepcopy(args))
    assert got == getattr(jax_router, fn)(*copy.deepcopy(args))
    assert got == pytest.approx(want) if isinstance(want, float) else got == want


@pytest.mark.parametrize("name", sorted(_FLEETS))
def test_merge_fleet_returns_what_jax_returns(name):
    snaps, drains, factor, down = _FLEETS[name]
    got = router.merge_fleet(copy.deepcopy(snaps), dict(drains), straggler_factor=factor, down_weight=down)
    want = jax_router.merge_fleet(copy.deepcopy(snaps), dict(drains), straggler_factor=factor, down_weight=down)
    assert got == want
    assert router.fleet_tenants_cost(got["replicas"]) == jax_router.fleet_tenants_cost(want["replicas"])
    assert router.fleet_quality(got["replicas"]) == jax_router.fleet_quality(want["replicas"])
    if name == "degraded":
        assert got["routable"] == ["r0", "r1"]
        assert got["replicas"]["r0"]["effective_load"] == pytest.approx(4.0)
    if name == "straggler":
        assert got["straggler"]["name"] == "r2" and got["replicas"]["r2"]["weight"] == pytest.approx(0.5)
        assert got["fleet_p50_ms"] == pytest.approx(110.0)
    if name == "drain_unreachable":
        assert got["routable"] == ["r0"] and got["replicas"]["r2"]["effective_load"] is None


@pytest.mark.parametrize("values,factor", [
    ({}, 2.0),
    ({"r0": 100.0}, 2.0),
    ({"r0": 100.0, "r1": 120.0, "r2": 900.0}, 2.0),
    ({"r0": 100.0, "r1": 200.0}, 1.0),
    ({"r0": 100.0, "r1": 300.0}, 2.0),  # worst == median x factor: keeping up
    ({"r0": 0.0, "r1": 0.0}, 2.0),
])
def test_straggler_verdict_returns_what_jax_returns(values, factor):
    assert fleet.straggler_verdict(dict(values), factor) == jax_fleet.straggler_verdict(dict(values), factor)


def test_config_validates_route_knobs():
    Config(phase="route")
    for bad in (dict(route_num_replicas=0), dict(route_hysteresis=-0.1), dict(route_down_weight=0.0),
                dict(route_down_weight=1.5), dict(route_poll_interval_s=0.0),
                dict(route_upstream_timeout_s=0.0)):
        with pytest.raises(ValueError):
            Config(**bad)


def test_parse_endpoints_names_tiers_and_failfast():
    from sat_tpu.serve.replica import parse_endpoints as jax_parse

    spec = "127.0.0.1:9000, 127.0.0.1:9001=decode"
    eps = parse_endpoints(spec)
    assert [(e.name, e.address, e.tier) for e in eps] == [
        (e.name, e.address, e.tier) for e in jax_parse(spec)
    ] == [("r0", "127.0.0.1:9000", "both"), ("r1", "127.0.0.1:9001", "decode")]
    for bad in ("127.0.0.1", "host:notaport", ",", "h:1=gpu"):
        with pytest.raises(ValueError):
            parse_endpoints(bad)


class _FakePopen:
    """A replica process that lives until it is killed."""

    def __init__(self, argv, **kwargs):
        self.argv, self.rc = argv, None

    def poll(self):
        return self.rc

    def kill(self):
        self.rc = -9


def test_local_fleet_respawns_a_dead_replica_with_its_command(tmp_path, monkeypatch):
    from sat_tpu_torch.serve import replica

    monkeypatch.setattr(replica.subprocess, "Popen", _FakePopen)
    root = str(tmp_path / "fleet")
    fleet = replica.LocalFleet(Config(phase="route"), 2, root, base_port=9100, tiers=["both", "decode"])
    first = fleet.by_name("r1")
    assert first.popen.argv == replica.LocalFleet.replica_argv(root, 1)
    assert first.popen.argv[1:4] == ["-m", "sat_tpu_torch.cli", "--config"]
    saved = Config.load(first.popen.argv[-1])
    assert (saved.phase, saved.serve_port, saved.serve_tier) == ("serve", 9101, "decode")
    with pytest.raises(RuntimeError):
        fleet.respawn("r1")  # still running
    first.kill()
    again = fleet.respawn("r1")
    assert again is fleet.by_name("r1") and again is not first and again.alive
    assert again.popen.argv == first.popen.argv
    assert (again.endpoint.port, again.endpoint.tier) == (9101, "decode")
    with pytest.raises(KeyError):
        fleet.respawn("r9")


def test_cli_route_flags():
    from sat_tpu_torch.cli import build_config

    config, _ = build_config(["--phase=route", "--num_replicas=3", "--port=0"])
    assert (config.phase, config.route_num_replicas, config.route_port) == ("route", 3, 0)
    config, _ = build_config(["--replicas=127.0.0.1:9000,127.0.0.1:9001", "--port=8801"])
    assert (config.phase, config.route_replicas, config.route_port) == (
        "route", "127.0.0.1:9000,127.0.0.1:9001", 8801)


# ---------------------------------------------------------------------------
# Scripted stub replicas: retry / shed / drain against real sockets
# ---------------------------------------------------------------------------


def _ep(stub):
    return Endpoint(stub.name, "127.0.0.1", stub.port)


def _router_config(tmp_path, **kw):
    return Config(
        phase="route", summary_dir=str(tmp_path / "summary"), route_poll_interval_s=60.0,
        route_stats_every=1, route_hysteresis=0.25, route_down_weight=0.25, **kw,
    )


@pytest.fixture()
def stub_pair(tmp_path):
    tel = telemetry.get()
    was_enabled = tel.enabled
    if not was_enabled:
        tel = telemetry.enable(capacity=8192)
    a, b = StubReplica("r0"), StubReplica("r1")
    rt = Router(_router_config(tmp_path), [_ep(a), _ep(b)])
    rt.poll_once()
    yield {"a": a, "b": b, "router": rt, "tel": tel}
    a.stop()
    b.stop()
    rt.shutdown()
    if not was_enabled:
        telemetry.disable()


def test_pick_follows_load_and_downweights_degraded(stub_pair):
    a, b, rt = stub_pair["a"], stub_pair["b"], stub_pair["router"]
    first = rt.pick()
    assert first in ("r0", "r1") and rt.pick() == first
    (a if first == "r0" else b).health["queue_depth"] = 9
    rt.poll_once()
    flipped = rt.pick()
    assert flipped != first
    (a if flipped == "r0" else b).health["status"] = "degraded"
    rt.poll_once()
    assert rt.pick() == flipped


def test_burst_picks_stay_balanced_despite_hysteresis(stub_pair):
    rt = stub_pair["router"]
    counts = {"r0": 0, "r1": 0}
    for _ in range(16):
        name = rt.pick()
        rt._note_outstanding(name, +1)
        counts[name] += 1
    assert abs(counts["r0"] - counts["r1"]) <= 1, counts


def test_single_retry_on_refused_lands_on_other_replica(stub_pair):
    a, b, rt, tel = stub_pair["a"], stub_pair["b"], stub_pair["router"], stub_pair["tel"]
    a.health["queue_depth"] = 9
    rt.poll_once()
    assert rt.pick() == "r1"
    b.stop()
    before = tel.counters().get("route/retries", 0)
    status, data, _, headers = rt.proxy_caption(b"img", "rid-retry-1")
    assert status == 200 and json.loads(data)["caption"] == "stub from r0"
    assert (headers.get("X-Routed-Retry"), headers.get("X-Routed-Replica")) == ("1", "r0")
    assert tel.counters().get("route/retries", 0) == before + 1
    assert a.seen_rids == ["rid-retry-1"]
    assert rt.view()["replicas"]["r1"]["reachable"] is False


def test_both_replicas_refused_is_502_with_hint(stub_pair):
    a, b, rt = stub_pair["a"], stub_pair["b"], stub_pair["router"]
    a.stop()
    b.stop()
    status, data, _, headers = rt.proxy_caption(b"img", "rid-down-1")
    assert status == 502 and int(headers["Retry-After"]) >= 1
    assert json.loads(data)["request_id"] == "rid-down-1"
    rt.poll_once()
    status, _, _, headers = rt.proxy_caption(b"img", "rid-down-2")
    assert status == 503 and int(headers["Retry-After"]) >= 1


def test_coherent_shed_uses_fleet_p50_not_replica_hint(stub_pair):
    a, b, rt = stub_pair["a"], stub_pair["b"], stub_pair["router"]
    for stub in (a, b):
        stub.caption_status = 429
        stub.retry_after = "19"
        stub.stats["latency_ms"]["serve/request"] = {"p50": 2400.0, "p99": 3000.0}
    rt.poll_once()
    status, data, _, headers = rt.proxy_caption(b"img", "rid-shed-1")
    assert status == 429 and headers["Retry-After"] == "3"
    payload = json.loads(data)
    assert (payload["retry_after_ms"], payload["request_id"]) == (3000, "rid-shed-1")
    assert len(a.seen_rids) + len(b.seen_rids) == 2


def test_drain_sequencing_one_at_a_time(stub_pair):
    a, b, rt = stub_pair["a"], stub_pair["b"], stub_pair["router"]
    status, payload = rt.start_drain("r1")
    assert status == 200 and payload["mechanism"] == "hold-out"
    status, payload = rt.start_drain("r0")
    assert status == 409 and payload["draining"] == "r1"
    assert rt.view()["routable"] == ["r0"]
    assert rt.start_drain("r1")[0] == 409
    assert rt.start_drain("nope")[0] == 404
    b.health.update(ready=False, queue_depth=0, in_flight=0)
    rt.poll_once()
    assert rt.view()["replicas"]["r1"]["drain_state"] == "drained"
    b.health["ready"] = True
    rt.poll_once()
    assert rt.view()["replicas"]["r1"]["drain_state"] == "in"
    assert rt.view()["routable"] == ["r0", "r1"]
    assert rt.undrain("r1")[0] == 409


def test_proactive_shed_at_configured_depth(stub_pair, tmp_path):
    a, b = stub_pair["a"], stub_pair["b"]
    rt = Router(_router_config(tmp_path / "shed", route_shed_depth=4), [_ep(a), _ep(b)])
    try:
        a.health["queue_depth"] = 4
        b.health["queue_depth"] = 5
        rt.poll_once()
        status, _, _, headers = rt.proxy_caption(b"img", "rid-depth-1")
        assert status == 429 and int(headers["Retry-After"]) >= 1
        assert a.seen_rids == [] and b.seen_rids == []
        a.health["queue_depth"] = 0
        rt.poll_once()
        assert rt.proxy_caption(b"img", "rid-depth-2")[0] == 200
    finally:
        rt.shutdown()


def test_tiered_fleet_two_hops_passthrough_and_starved_shed(tmp_path):
    from sat_tpu_torch.serve.handoff import GRID_CONTENT_TYPE

    enc, dec = StubReplica("r0"), StubReplica("r1")
    enc.health["tier"] = "encode"
    dec.health["tier"] = "decode"
    rt = Router(_router_config(tmp_path), [_ep(enc), _ep(dec)])
    try:
        rt.poll_once()
        view = rt.view()
        assert (view["routable_encode"], view["routable_decode"]) == (["r0"], ["r1"])
        status, _, _, headers = rt.proxy_caption(b"img", "rid-tier-1", content_type="image/jpeg")
        assert status == 200
        assert (enc.seen_paths, dec.seen_paths, dec.seen_ctypes) == (["/encode"], ["/caption"], [GRID_CONTENT_TYPE])
        assert (headers.get("X-Routed-Encode-Replica"), headers.get("X-Routed-Replica")) == ("r0", "r1")
        assert enc.seen_rids == dec.seen_rids == ["rid-tier-1"]
        assert rt.proxy_caption(b"frame", "rid-tier-2", content_type=GRID_CONTENT_TYPE)[0] == 200
        assert enc.seen_paths == ["/encode"] and dec.seen_paths == ["/caption", "/caption"]
        enc.health["ready"] = False
        rt.poll_once()
        status, _, _, headers = rt.proxy_caption(b"img", "rid-tier-3", content_type="image/jpeg")
        assert status == 429 and headers["X-Shed-Scope"] == "tier"
        assert rt.proxy_caption(b"frame", "rid-tier-4", content_type=GRID_CONTENT_TYPE)[0] == 200
        payload, _ = rt.healthz()
        assert (payload["replicas_encode"], payload["replicas_decode"]) == (0, 1)
        assert rt.stats()["routable_decode"] == ["r1"]
    finally:
        rt.shutdown()
        enc.stop()
        dec.stop()


# ---------------------------------------------------------------------------
# End to end: real servers of both packages behind both routers
# ---------------------------------------------------------------------------

# the fields only a replica that compiles ahead reports
_COMPILE_FIELDS = {"compiles_since_ready", "warm_compiles"}


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    """One step-5 checkpoint; two port replicas and two sat_tpu replicas
    (in-process, each with its own summary dir), and four routers: each
    package over its own replicas, and each over the other's."""
    from sat_tpu.serve.replica import Endpoint as JaxEndpoint
    from sat_tpu.serve.router import Router as JaxRouter

    root = tmp_path_factory.mktemp("route")
    jc, tc, _, _ = make_checkpoint(root, heartbeat_interval=0.0)
    servers = {"torch": [], "jax": []}
    with registries():
        try:
            for i in range(2):
                rtc = tc.replace(summary_dir=str(root / f"t{i}" / "summary"))
                servers["torch"].append(boot("torch", rtc, port_engine(rtc)))
                rjc = jc.replace(summary_dir=str(root / f"j{i}" / "summary"))
                servers["jax"].append(boot("jax", rjc, jax_engine(rjc)))
            routers = {}
            for front in ("torch", "jax"):
                for back in ("torch", "jax"):
                    Ep, cls, cfg = (Endpoint, Router, tc) if front == "torch" else (JaxEndpoint, JaxRouter, jc)
                    rcfg = cfg.replace(phase="route", summary_dir=str(root / f"{front}_{back}" / "summary"),
                                       route_poll_interval_s=0.1, route_stats_every=2)
                    eps = [Ep(f"r{i}", "127.0.0.1", s.port) for i, s in enumerate(servers[back])]
                    routers[front, back] = cls(rcfg, eps, port=0).start()
            yield {"root": root, "servers": servers, "routers": routers, "jpegs": _jpegs(4, seed=21)}
        finally:
            for rt in locals().get("routers", {}).values():
                rt.shutdown()
            for group in servers.values():
                for s in group:
                    s.shutdown()


def _post(port, body, rid=None):
    headers = {"Content-Type": "image/jpeg"}
    if rid:
        headers[tracectx.TRACE_HEADER] = rid
    status, hdrs, raw = http(port, "POST", "/caption", body, headers)
    return status, json.loads(raw), hdrs


def _records(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_e2e_port_fleet_stitches_request_ids(fleets):
    rt, root = fleets["routers"]["torch", "torch"], fleets["root"]
    status, health = get_json(rt.port, "/healthz")
    assert status == 200 and health["role"] == "router" and health["replicas_routable"] == 2
    assert health["serve_mode"] == "batch"
    rids = [f"rid-port-{i}" for i in range(4)]
    for rid, body in zip(rids, fleets["jpegs"]):
        status, payload, headers = _post(rt.port, body, rid)
        assert status == 200
        assert headers[tracectx.TRACE_HEADER] == rid and payload["request_id"] == rid
        assert headers["X-Routed-Replica"] in ("r0", "r1")
    router_log = _records(str(root / "torch_torch" / "summary" / "telemetry" / "access.jsonl"))
    replica_logs = {f"r{i}": _records(str(root / f"t{i}" / "summary" / "telemetry" / "access.jsonl"))
                    for i in range(2)}
    for rid in rids:
        hops = [r for r in router_log if r["trace_id"] == rid]
        assert len(hops) == 1 and hops[0]["hop"] == "route" and hops[0]["status"] == 200
        served_by = [n for n, recs in replica_logs.items() if any(r.get("trace_id") == rid for r in recs)]
        assert served_by == [hops[0]["replica"]]


@pytest.mark.parametrize("front,back", [("torch", "torch"), ("jax", "torch"), ("torch", "jax"), ("jax", "jax")])
def test_e2e_replies_are_those_of_one_server_alone(fleets, front, back):
    """Through any router the reply's beams are bitwise those of one
    replica of its package asked directly; the port's words are sat_tpu's."""
    rt = fleets["routers"][front, back]
    alone = fleets["servers"][back][0]
    other = fleets["servers"]["jax" if back == "torch" else "torch"][0]
    for body in fleets["jpegs"]:
        status, routed, _ = _post(rt.port, body)
        assert status == 200
        direct = _post(alone.port, body)[1]
        assert routed["captions"] == direct["captions"]
        assert [c["caption"] for c in routed["captions"]] == [
            c["caption"] for c in _post(other.port, body)[1]["captions"]]


def _metric_names(text):
    out = set()
    for line in text.splitlines():
        if line.startswith("#") or 'name="' not in line:
            continue
        out.add(line.split('name="', 1)[1].split('"', 1)[0])
    return out


def test_e2e_stats_and_metrics_keys_match_jax(fleets):
    ours, theirs = fleets["routers"]["torch", "torch"], fleets["routers"]["jax", "jax"]
    for rt in (ours, theirs):
        for body in fleets["jpegs"]:
            _post(rt.port, body)
        # two ticks: one of them folds /stats in (route_stats_every=2)
        rt.poll_once()
        rt.poll_once()
    stats = {pkg: get_json(rt.port, "/stats")[1] for pkg, rt in (("torch", ours), ("jax", theirs))}
    assert set(stats["torch"]) == set(stats["jax"])
    assert stats["torch"]["role"] == "router" and set(stats["torch"]["replicas"]) == {"r0", "r1"}
    for name in ("r0", "r1"):
        assert set(stats["torch"]["replicas"][name]) - _COMPILE_FIELDS == \
            set(stats["jax"]["replicas"][name]) - _COMPILE_FIELDS
        assert stats["torch"]["replicas"][name]["compiles_since_ready"] is None
        # every field the router reads off a port replica is there under its name
        snap = stats["torch"]["replicas"][name]
        assert snap["p50_ms"] is not None and snap["p99_ms"] is not None
        assert (snap["serve_mode"], snap["tier"]) == ("batch", "both")
        assert "capacity_headroom_pct" in snap and "default" in snap["tenants_cost"]
    assert set(stats["torch"]["counters"]) == set(stats["jax"]["counters"])
    assert set(stats["torch"]["latency_ms"]) == set(stats["jax"]["latency_ms"])
    names = {pkg: {n for n in _metric_names(http(rt.port, "GET", "/metrics")[2].decode()) if n.startswith("route/")}
             for pkg, rt in (("torch", ours), ("jax", theirs))}
    assert names["torch"] == names["jax"]
    assert "route/replicas_routable" in names["torch"] and "route/requests" in names["torch"]


# ---------------------------------------------------------------------------
# The CLI spawns a fleet of its own children
# ---------------------------------------------------------------------------


def _children(pid):
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid:
            out.append(int(entry))
    return out


def _gone(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except OSError:
        return True


def test_cli_route_spawns_replicas_and_stops_them(tmp_path):
    jc, tc, _, _ = make_checkpoint(tmp_path, heartbeat_interval=0.0, summary_dir=str(tmp_path / "summary"))
    cfg_path = str(tmp_path / "route.json")
    tc.replace(phase="route", route_poll_interval_s=0.2).save(cfg_path)
    port = free_port()
    env = {**os.environ, "SAT_TORCH_DEVICE": "cpu", "OMP_NUM_THREADS": "2"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "sat_tpu_torch.cli", "--config", cfg_path, "--num_replicas", "2",
         "--port", str(port)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        deadline = time.monotonic() + 120
        health = None
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                status, health = get_json(port, "/healthz")
                if status == 200 and health["replicas_routable"] == 2:
                    break
            except OSError:
                pass
            time.sleep(0.2)
        assert proc.poll() is None, proc.stdout.read()
        assert health and health["replicas_routable"] == 2, health
        children = _children(proc.pid)
        assert len(children) == 2
        status, payload, headers = _post(port, _jpegs(1, seed=3)[0], "rid-spawn-1")
        assert status == 200 and payload["captions"][0]["caption"]
        assert headers["X-Routed-Replica"] in ("r0", "r1")
        stats = get_json(port, "/stats")[1]
        assert sorted(stats["replicas"]) == ["r0", "r1"]
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
        assert "router drained cleanly" in out
        assert all(_gone(pid) for pid in children)
        for i in range(2):
            assert os.path.isfile(str(tmp_path / "summary" / "fleet" / f"replica_{i}" / "serve_config.json"))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)


def test_a_burst_beyond_the_listen_backlog_is_answered(stub_pair, tmp_path):
    """64 connections at once: every one answered 200 (with socketserver's
    default backlog of 5 the kernel resets part of such a burst)."""
    import threading

    a, b = stub_pair["a"], stub_pair["b"]
    rt = Router(_router_config(tmp_path / "burst"), [_ep(a), _ep(b)], port=0).start()
    codes = []
    try:
        def one():
            try:
                codes.append(http(rt.port, "POST", "/caption", b"x" * 40000, {"Content-Type": "image/jpeg"})[0])
            except OSError as e:
                codes.append(repr(e))

        for _ in range(3):
            threads = [threading.Thread(target=one) for _ in range(64)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        rt.shutdown()
    assert codes == [200] * 192, [c for c in codes if c != 200][:4]
