"""The port's continuous serving end to end on the CPU: a checkpoint in
sat_tpu's format → load_serving_state → ServeEngine(device="cpu") →
CaptionServer with ``serve_mode="continuous"`` (a 2x2 slot pool) on an
ephemeral port, JPEGs POSTed over HTTP.  Captions must equal sat_tpu's
encode + beam_search words on the same images and weights."""

import threading

import numpy as np
import pytest
import torch

from sat_tpu_torch.ops.fused_attend import fused_attend
from sat_tpu_torch.serve.batcher import ContinuousBatcher, Rejected
from sat_tpu_torch.serve.engine import ServeEngine, load_serving_state
from sat_tpu_torch.serve.server import CaptionServer
from sat_tpu_torch.serve.slot_pool import PagedSlotPool
from tests.test_torch_serve import _get, _jax_captions, _jpegs, _post, make_checkpoint

torch.set_num_threads(2)

POOL = dict(serve_mode="continuous", serve_slot_pages=2, serve_page_width=2)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    jc, tc, variables, vocab = make_checkpoint(tmp_path_factory.mktemp("continuous"), **POOL)

    from sat_tpu_torch.data.vocabulary import Vocabulary

    state, _ = load_serving_state(tc, device="cpu")
    engine = ServeEngine(tc, state, Vocabulary(tc.vocabulary_size, tc.vocabulary_file), device="cpu")
    server = CaptionServer(tc, engine, port=0, host="127.0.0.1").start()
    yield dict(jc=jc, tc=tc, variables=variables, vocab=vocab, engine=engine, server=server)
    server.shutdown()


def test_http_captions_match_jax(served):
    """Six requests at once into four slots: every one is admitted (two
    wait for a harvested slot) and captions like sat_tpu's beam search."""
    server = served["server"]
    jpegs = _jpegs(6, seed=3)
    replies = [None] * len(jpegs)

    def post(i):
        replies[i] = _post(server, jpegs[i])

    threads = [threading.Thread(target=post, args=(i,)) for i in range(len(jpegs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    want = _jax_captions(served, jpegs)
    for (status, payload), expect in zip(replies, want):
        assert status == 200, payload
        assert payload["model_step"] == 5 and payload["bucket"] == 2  # the page width
        got = [(c["caption"], c["log_prob"]) for c in payload["captions"]]
        assert [g[0] for g in got] == [e[0] for e in expect]
        np.testing.assert_allclose([g[1] for g in got], [e[1] for e in expect], rtol=0, atol=1e-5)


def test_stats_has_the_slot_pool_block(served):
    server = served["server"]
    status, _ = _post(server, _jpegs(1, seed=4)[0])
    assert status == 200
    status, stats = _get(server, "/stats")
    assert status == 200
    pool = stats["slot_pool"]
    assert (pool["slots"], pool["pages"], pool["page_width"], pool["occupancy"]) == (4, 2, 2, 0)
    assert pool["dispatches"] >= 1 and pool["steps"] >= pool["dispatches"]
    assert set(pool["dispatches_per_k"]) == {"1", "2", "4", "8"}
    assert sum(pool["dispatches_per_k"].values()) == pool["dispatches"]
    assert pool["dispatches_per_k"]["8"] >= 1  # a window with nothing queued runs deep
    # CPU tensors: the plain versions, no kernel launch
    assert stats["kernels"]["fused_attend"] == {"launches": 0, "masked_launches": 0}
    assert fused_attend.masked_launches == 0
    assert stats["counters"]["completed"] == stats["counters"]["admitted"] >= 1


def test_more_requests_than_slots_are_admitted_and_drained(served):
    """Nine requests queued before the loop starts, four slots: the first
    windows run at K=1 while requests wait, the last at K=8, and every
    request completes with the captions it gets alone."""
    engine = served["engine"]
    images = [engine.preprocess(b) for b in _jpegs(9, seed=5)]
    batcher = ContinuousBatcher(engine, pool=PagedSlotPool(engine), queue_depth=16)
    reqs = [batcher.submit(im) for im in images]
    batcher.start()
    try:
        for r in reqs:
            assert r.done.wait(timeout=120) and r.error is None, r.error
    finally:
        batcher.drain(timeout=60)
    counters = batcher.counter_snapshot()
    assert counters["admitted"] == counters["completed"] == 9
    assert counters["dispatch_k1"] >= 1 and counters["dispatch_k8"] >= 1
    alone = ContinuousBatcher(engine, pool=PagedSlotPool(engine)).start()
    try:
        req = alone.submit(images[8])
        assert req.done.wait(timeout=120) and req.error is None
    finally:
        alone.drain(timeout=60)
    assert req.result == reqs[8].result


def test_full_queue_sheds_429_and_expired_deadline_504(served):
    engine = served["engine"]
    image = engine.preprocess(_jpegs(1)[0])
    batcher = ContinuousBatcher(engine, pool=PagedSlotPool(engine), queue_depth=1)
    late = batcher.submit(image, deadline_unix=0.0)
    with pytest.raises(Rejected) as e:
        batcher.submit(image)
    assert e.value.status == 429
    batcher.start()
    try:
        assert late.done.wait(timeout=60)
        assert late.error[0] == 504
        ok = batcher.submit(image)
        assert ok.done.wait(timeout=120) and ok.error is None
    finally:
        batcher.drain(timeout=60)
    with pytest.raises(Rejected) as e:
        batcher.submit(image)
    assert e.value.status == 503
    assert batcher.counter_snapshot()["expired"] == 1


def test_continuous_server_needs_a_card_unless_cpu_is_asked(served, monkeypatch):
    from sat_tpu_torch.serve.server import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tc = served["tc"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_serving_state(tc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve(tc)


def test_cli_takes_the_continuous_flags():
    from sat_tpu_torch.cli import build_config

    config, _ = build_config(
        ["--phase", "serve", "--serve_mode", "continuous", "--serve_decode_depth", "1,4",
         "--set", "serve_slot_pages=2"]
    )
    assert (config.serve_mode, config.serve_decode_depth, config.serve_slot_pages) == (
        "continuous", (1, 4), 2
    )
