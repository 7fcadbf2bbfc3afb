"""The port's batch-mode serving slice end to end on the CPU: a checkpoint
in sat_tpu's format → load_serving_state → ServeEngine(device="cpu") →
CaptionServer on an ephemeral port, with JPEGs POSTed over HTTP.  Captions
and log-probs must equal sat_tpu's encode + beam_search on the same images
and weights."""

import json
import os
import threading
import urllib.error
import urllib.request

import cv2
import jax
import numpy as np
import pytest
import torch

from sat_tpu.data.images import ImageLoader as JaxImageLoader
from sat_tpu.data.vocabulary import Vocabulary as JaxVocabulary
from sat_tpu.data.vocabulary import vocab_fingerprint as jax_vocab_fingerprint
from sat_tpu.models.captioner import encode as jax_encode
from sat_tpu.ops.beam_search import beam_search as jax_beam_search
from sat_tpu.resilience import lineage as jax_lineage
from sat_tpu_torch.ops.fused_attend import fused_attend
from sat_tpu_torch.serve.batcher import MicroBatcher, Rejected
from sat_tpu_torch.serve.engine import ServeEngine, load_serving_state
from sat_tpu_torch.serve.server import CaptionServer
from tests.torch_port_helpers import configs, flat_params, jax_variables

torch.set_num_threads(2)

WORDS = "a man dog cat riding sitting on the grass horse with two red of in".split()


def _jpegs(n, size=48, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        img = rng.integers(0, 256, size=(size, size, 3), dtype=np.uint8)
        ok, buf = cv2.imencode(".jpg", img)
        assert ok
        out.append(buf.tobytes())
    return out


def make_checkpoint(root, **overrides):
    """A vocabulary and a step-5 checkpoint with LAST_GOOD under ``root``
    in sat_tpu's format; returns (jax config, port config, variables,
    jax vocabulary)."""
    settings = dict(
        save_dir=str(root / "models"),
        vocabulary_file=str(root / "vocabulary.csv"),
        serve_buckets=(1, 4),
        serve_max_batch=4,
        serve_max_wait_ms=20.0,
        beam_size=2,
    )
    jc, tc = configs(**{**settings, **overrides})
    vocab = JaxVocabulary(size=jc.vocabulary_size)
    vocab.build([f"{a} {b} {c}." for a in WORDS for b in WORDS[:3] for c in WORDS[:2]])
    vocab.save(jc.vocabulary_file)
    variables = jax_variables(jc)
    flat = dict(flat_params(variables), global_step=np.asarray(5, np.int32))
    path = os.path.join(jc.save_dir, "5.npz")
    os.makedirs(jc.save_dir)
    np.savez(path, **flat)
    jax_lineage.write_sidecar(
        path, vocab=jax_vocab_fingerprint(jc.vocabulary_file, jc.vocabulary_size)
    )
    jax_lineage.mark_last_good(jc.save_dir, 5)
    return jc, tc, variables, vocab


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    jc, tc, variables, vocab = make_checkpoint(tmp_path_factory.mktemp("serve"))

    from sat_tpu_torch.data.vocabulary import Vocabulary

    state, _ = load_serving_state(tc, device="cpu")
    engine = ServeEngine(tc, state, Vocabulary(tc.vocabulary_size, tc.vocabulary_file), device="cpu")
    engine.warmup()
    server = CaptionServer(tc, engine, port=0, host="127.0.0.1").start()
    yield dict(jc=jc, tc=tc, variables=variables, vocab=vocab, engine=engine, server=server)
    server.shutdown()


def _post(server, body, path="/caption"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{server.port}{path}", data=body, method="POST",
        headers={"Content-Type": "image/jpeg"},
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(server, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}{path}", timeout=30) as r:
        return r.status, json.loads(r.read())


def _jax_captions(served, jpegs):
    """sat_tpu's own path on the same bytes: decode, encode, beam search."""
    jc, vocab = served["jc"], served["vocab"]
    loader = JaxImageLoader(size=jc.image_size, raw=True)
    images = np.stack([loader.load_bytes(b) for b in jpegs])
    ctx = jax.jit(lambda v, x: jax_encode(v, jc, x)[0])(served["variables"], images)
    res = jax_beam_search(
        served["variables"]["params"]["decoder"], jc, ctx,
        vocab.word2idx["."], valid_size=len(vocab.words),
    )
    words, lengths, scores = map(np.asarray, (res.words, res.lengths, res.log_scores))
    return [
        [
            (vocab.get_sentence(words[i, k, : max(1, int(lengths[i, k]))]), float(scores[i, k]))
            for k in range(words.shape[1])
        ]
        for i in range(len(jpegs))
    ]


def test_http_captions_match_jax(served):
    server = served["server"]
    jpegs = _jpegs(3)
    before = fused_attend.launches
    replies = [None] * 3

    def post(i):
        replies[i] = _post(server, jpegs[i])

    threads = [threading.Thread(target=post, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert fused_attend.launches == before  # CPU tensors: the plain version
    want = _jax_captions(served, jpegs)
    for (status, payload), expect in zip(replies, want):
        assert status == 200, payload
        assert payload["model_step"] == 5 and payload["bucket"] in (1, 4)
        got = [(c["caption"], c["log_prob"]) for c in payload["captions"]]
        assert [g[0] for g in got] == [e[0] for e in expect]
        np.testing.assert_allclose([g[1] for g in got], [e[1] for e in expect], rtol=0, atol=1e-5)
        for c in payload["captions"]:
            assert c["prob"] == pytest.approx(np.exp(c["log_prob"]))


def test_pad_rows_never_perturb_real_rows(served):
    engine = served["engine"]
    images = [engine.preprocess(b) for b in _jpegs(4, seed=1)]
    alone = engine.decode_output(engine.dispatch(engine.pad_batch(images[:1])[0]), 1)[0]
    batch, bucket = engine.pad_batch(images)
    assert bucket == 4
    together = engine.decode_output(engine.dispatch(batch), 4)[0]
    assert [c["caption"] for c in alone["captions"]] == [c["caption"] for c in together["captions"]]
    np.testing.assert_allclose(
        [c["log_prob"] for c in alone["captions"]],
        [c["log_prob"] for c in together["captions"]],
        rtol=0, atol=1e-6,
    )


def test_http_errors_and_stats(served):
    server = served["server"]
    status, payload = _post(server, b"not an image")
    assert status == 400 and payload["error"] == "bad image"
    status, _ = _post(server, b"")
    assert status == 400
    assert _get(server, "/healthz") == (200, {"status": "ok", "model_step": 5})
    status, stats = _get(server, "/stats")
    assert status == 200
    assert stats["queue_depth"] == 0 and stats["requests_served"] >= 3
    assert stats["kernels"]["fused_attend"]["launches"] == fused_attend.launches
    assert stats["counters"]["batches"] >= 1


def test_full_queue_sheds_429(served):
    """A batcher whose queue holds one request refuses the second with
    429; after drain() it refuses with 503."""
    engine = served["engine"]
    batcher = MicroBatcher(engine, queue_depth=1)
    image = engine.preprocess(_jpegs(1)[0])
    first = batcher.submit(image)
    with pytest.raises(Rejected) as e:
        batcher.submit(image)
    assert e.value.status == 429
    batcher.start()
    try:
        assert first.done.wait(timeout=120) and first.error is None
    finally:
        batcher.drain(timeout=60)
    with pytest.raises(Rejected) as e:
        batcher.submit(image)
    assert e.value.status == 503


def test_bucket_overflow_sheds_429(served):
    engine = served["engine"]
    image = engine.preprocess(_jpegs(1)[0])
    batcher = MicroBatcher(engine, max_batch=8, max_wait_ms=200.0)
    reqs = [batcher.submit(image) for _ in range(5)]
    batcher.start()
    try:
        for r in reqs:
            assert r.done.wait(timeout=120)
        assert {r.error[0] for r in reqs} == {429}
    finally:
        batcher.drain(timeout=60)
