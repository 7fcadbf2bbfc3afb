"""The port's tenant plane held to sat_tpu's on the CPU: the registry's
description of sat_tpu's own test specs, the deficit-round-robin order
and the token buckets on one seeded sequence; and, end to end on one
float32 checkpoint, ``X-Model`` routing to a resident model with
sat_tpu's words (and the words of a server booted on that checkpoint
alone), the quota's 429 with sat_tpu's status, headers and scope, and
the tenant blocks of /stats and /healthz."""

import json
import os
import queue

import numpy as np
import pytest
import torch

from sat_tpu_torch.serve.scheduler import DeficitRoundRobin
from sat_tpu_torch.serve.tenants import TenantRegistry
from tests.torch_planes_helpers import (
    boot, both_servers, caption, close_beams, get_json, port_engine, registries, stage_candidate, words, world,
)

torch.set_num_threads(2)

INLINE_SPECS = ["", "alpha:4:10:20, beta, gamma:0.5", "a:2:5,b:1", "free:4,capped:1:0.2:2", "main:2,side:1",
                "a:1,b:1:2:2"]


def _doc_spec(tmp_path):
    path = str(tmp_path / "tenants.json")
    with open(path, "w") as f:
        json.dump({"default": "big", "models": {"v2": "/ckpts/100.npz"},
                   "tenants": [{"name": "big", "weight": 4.0, "slo_p99_ms": 250.0},
                               {"name": "small", "weight": 1.0, "rps": 2.0, "model": "v2"}]}, f)
    return path


@pytest.mark.parametrize("spec", INLINE_SPECS + ["<doc>"])
def test_registry_describe_matches_jax(spec, tmp_path):
    """sat_tpu's own test specs (inline lists and a JSON document with a
    model and an SLO target): the same description, weights, lanes and
    resolution in both packages."""
    from sat_tpu.serve.tenants import TenantRegistry as JaxRegistry

    if spec == "<doc>":
        spec = _doc_spec(tmp_path)
    ours, theirs = TenantRegistry.parse(spec), JaxRegistry.parse(spec)
    assert ours.describe() == theirs.describe()
    assert (ours.multi, ours.default, ours.models, ours.weights()) == (
        theirs.multi, theirs.default, theirs.models, theirs.weights())
    assert ours.slo_lanes(900.0, 0.25) == theirs.slo_lanes(900.0, 0.25)
    for header in (None, "beta", "nosuch", "small", "capped"):
        assert ours.resolve(header).name == theirs.resolve(header).name


def test_token_buckets_match_jax():
    """One frozen-then-stepped clock: the same admissions and retry hints."""
    from sat_tpu.serve.tenants import TenantRegistry as JaxRegistry

    now = [0.0]
    regs = [cls.parse("a:1,b:1:2:2,c:1:0.2:1", clock=lambda: now[0]) for cls in (TenantRegistry, JaxRegistry)]
    rng = np.random.default_rng(5)
    for _ in range(200):
        now[0] += float(rng.exponential(0.3))
        name = "abc"[int(rng.integers(0, 3))]
        got = [(r.try_admit(name), r.retry_after_s(name), r.tokens(name)) for r in regs]
        assert got[0] == got[1]


class _Item:
    def __init__(self, tenant, tag):
        self.tenant, self.tag = tenant, tag


def test_deficit_round_robin_order_matches_jax():
    """One seeded sequence of puts (three weighted tenants, a bounded
    lane) interleaved with pops: the same pop order, the same Full
    refusals, depths and admissions."""
    from sat_tpu.serve.scheduler import DeficitRoundRobin as JaxDRR

    weights = {"big": 3.0, "mid": 1.0, "tiny": 0.25}
    queues = [DeficitRoundRobin(maxsize=6, weights=weights), JaxDRR(maxsize=6, weights=weights)]
    rng = np.random.default_rng(11)
    logs = [[], []]
    for step in range(600):
        if rng.random() < 0.6:
            item = ("big", "mid", "tiny", "default")[int(rng.integers(0, 4))]
            for q, log in zip(queues, logs):
                try:
                    q.put_nowait(_Item(item, step))
                    log.append(("put", item, step))
                except queue.Full:
                    log.append(("full", item, step))
        else:
            for q, log in zip(queues, logs):
                try:
                    got = q.get_nowait()
                    log.append(("pop", got.tenant, got.tag))
                except queue.Empty:
                    log.append(("empty",))
    assert logs[0] == logs[1]
    assert queues[0].depths() == queues[1].depths() and queues[0].admitted() == queues[1].admitted()
    assert queues[0].multi and sum(1 for e in logs[0] if e[0] == "full") > 0


@pytest.fixture(scope="module")
def tenanted(tmp_path_factory):
    w = world(tmp_path_factory.mktemp("tenants"))
    alt = stage_candidate(w["tc"], 1005, seed=3)
    # the lineage pointer back on the incumbent: the resident is a model
    # a tenant names, not a candidate
    from sat_tpu.resilience import lineage as jax_lineage

    jax_lineage.mark_last_good(w["tc"].save_dir, 5)
    spec = str(w["root"] / "tenants.json")
    with open(spec, "w") as f:
        json.dump({"tenants": [{"name": "pro", "weight": 2}, {"name": "free", "rps": 1, "burst": 1}],
                   "models": {"alt": alt}}, f)
    w.update(alt=alt, spec=spec)
    return w


@pytest.mark.parametrize("mode", ["batch", "continuous"])
def test_x_model_and_quota_match_jax(tenanted, tmp_path, mode):
    """``X-Model: alt`` replies carry sat_tpu's words, tenant, model and
    step, and the words of a port server booted on that checkpoint alone;
    a bare request keeps the incumbent's; the free tenant's third quick
    request is a 429 with sat_tpu's status, Retry-After and scope; the
    tenant blocks of /stats and /healthz have sat_tpu's keys."""
    w = tenanted
    tc = w["tc"].replace(serve_mode=mode, tenants=w["spec"], telemetry_dir=str(tmp_path / "t"))
    jc = w["jc"].replace(serve_mode=mode, tenants=w["spec"], telemetry_dir=str(tmp_path / "j"))
    alt_headers = {"X-Tenant": "pro", "X-Model": "alt"}
    out = {}
    with both_servers(jc, tc) as servers:
        for name, server in servers.items():
            server.tenants.use_clock(lambda: 0.0)  # no refill: the shed is deterministic
            alt = [caption(server.port, body, alt_headers)[1] for body in w["jpegs"][:3]]
            bare = caption(server.port, w["jpegs"][0])[1]
            quick = [caption(server.port, w["jpegs"][0], {"X-Tenant": "free"}) for _ in range(3)]
            unknown = caption(server.port, w["jpegs"][0], {"X-Model": "ghost"})
            if name == "torch" and mode == "continuous":
                assert server.batcher._model_pools["alt"].engine is server.engine
            out[name] = dict(alt=alt, bare=bare, quick=quick, unknown=unknown,
                             stats=get_json(server.port, "/stats")[1], healthz=get_json(server.port, "/healthz")[1])
    with registries():
        alone_cfg = w["tc"].replace(serve_mode=mode, telemetry_dir=str(tmp_path / "a"))
        alone = boot("torch", alone_cfg, port_engine(alone_cfg, model_file=w["alt"]))
        try:
            solo = [caption(alone.port, body)[1] for body in w["jpegs"][:3]]
        finally:
            alone.shutdown()
    ours, theirs = out["torch"], out["jax"]
    for a, b, s in zip(ours["alt"], theirs["alt"], solo):
        close_beams(a, b)
        assert words(a) == words(s) and a["captions"] == s["captions"]
        assert (a["model"], a["model_step"], a["tenant"], a["slot"]) == ("alt", 1005, "pro", "alt")
        assert {k for k in a if k != "request_id"} == {k for k in b if k != "request_id"}
    close_beams(ours["bare"], theirs["bare"])
    assert (ours["bare"]["model_step"], ours["bare"]["tenant"]) == (5, "pro")
    for (s1, p1, h1), (s2, p2, h2) in zip(ours["quick"], theirs["quick"]):
        assert s1 == s2
        if s1 == 429:
            assert (p1["shed_scope"], p1["retry_after_ms"]) == (p2["shed_scope"], p2["retry_after_ms"])
            assert (h1["Retry-After"], h1["X-Shed-Scope"]) == (h2["Retry-After"], h2["X-Shed-Scope"])
    assert [q[0] for q in ours["quick"]] == [200, 429, 429] and ours["quick"][2][2]["X-Shed-Scope"] == "tenant"
    assert ours["unknown"][0] == theirs["unknown"][0] == 400
    assert ours["unknown"][1]["models"] == theirs["unknown"][1]["models"] == ["alt"]
    assert set(ours["stats"]["tenants"]) == set(theirs["stats"]["tenants"]) == {"pro", "free"}
    for name in ("pro", "free"):
        mine, jax_block = ours["stats"]["tenants"][name], theirs["stats"]["tenants"][name]
        assert set(mine) == set(jax_block)
        for key in ("weight", "rps", "requests", "shed", "429", "5xx", "admitted"):
            assert mine.get(key) == jax_block.get(key), (name, key)
    assert ours["healthz"]["tenants"] == theirs["healthz"]["tenants"] == ["free", "pro"]
    assert os.path.isfile(w["alt"])
