"""The port's quality plane held to sat_tpu's on the CPU: the signals of
one drained request within 1e-12 on seeded arrays, quality references
crossing between the packages both ways, exemplar files sat_tpu reads;
and, end to end on one float32 checkpoint, the /stats quality block and
/quality_reference of both servers, the terminal exemplar of a shed, and
bulk's quality rows within 1e-6 of sat_tpu's."""

import json
import os
import time

import numpy as np
import pytest
import torch

from sat_tpu_torch.telemetry import quality
from sat_tpu_torch.telemetry.exemplar import ExemplarRecorder
from tests.torch_planes_helpers import both_servers, caption, close_beams, get_json, http, world

torch.set_num_threads(2)

VOCAB, EOS = 50, 1


def _drained(rng, K=3, T=8, N=4, with_alphas=True):
    """One request's drained beam arrays, as a detok loop holds them."""
    words = rng.integers(0, VOCAB + 3, size=(K, T)).astype(np.int32)
    lengths = rng.integers(1, T + 1, size=(K,)).astype(np.int32)
    for k in range(K):
        if rng.random() < 0.7:
            words[k, lengths[k] - 1] = EOS
    scores = np.sort(rng.normal(-6.0, 2.0, size=(K,)).astype(np.float32))[::-1].copy()
    alphas = None
    if with_alphas:
        alphas = rng.random((K, T, N)).astype(np.float32)
        alphas /= alphas.sum(-1, keepdims=True)
    return words, lengths, scores, alphas


def test_extract_signals_matches_jax():
    """200 seeded requests (1-3 beams, with and without alphas): every
    signal within 1e-12 of sat_tpu's."""
    from sat_tpu.telemetry.quality import extract_signals as jax_extract

    rng = np.random.default_rng(21)
    for i in range(200):
        words, lengths, scores, alphas = _drained(rng, K=1 + i % 3, with_alphas=bool(i % 2))
        kw = dict(vocab_size=VOCAB, eos_id=EOS, alphas=None if alphas is None else alphas[0])
        ours = quality.extract_signals(words, lengths, scores, **kw)
        theirs = jax_extract(words, lengths, scores, **kw)
        assert set(ours) == set(theirs)
        for key in ours:
            assert abs(ours[key] - theirs[key]) <= 1e-12, key


def _monitor(module, rng):
    mon = module.QualityMonitor(window=16, margin_min=0.5, unk_max=0.5)
    for _ in range(40):
        words, lengths, scores, alphas = _drained(rng)
        mon.observe(module.extract_signals(words, lengths, scores, vocab_size=VOCAB, eos_id=EOS,
                                           alphas=alphas[0]), tenant="default")
    return mon


def test_quality_references_cross_both_ways(tmp_path):
    """The same 40 observations freeze the same reference payload in both
    packages; each package loads the other's file and exports it
    unchanged, and scores drift against it as the other does."""
    from sat_tpu.telemetry import quality as jax_quality

    ours = _monitor(quality, np.random.default_rng(4))
    theirs = _monitor(jax_quality, np.random.default_rng(4))
    payload = ours.reference_payload()
    assert payload is not None and payload == theirs.reference_payload()
    assert ours.snapshot() == theirs.snapshot()
    for src, dst in ((quality, jax_quality), (jax_quality, quality)):
        path = str(tmp_path / f"{src.__name__}.json")
        src.QualityReference.from_payload(payload).save(path)
        loaded = dst.QualityReference.load(path)
        assert loaded.to_payload() == payload


def test_exemplar_files_are_read_by_jax(tmp_path):
    """An exemplar the port records (signals, beams, image bytes, alphas)
    reads back through sat_tpu's reader, image and all."""
    from sat_tpu.telemetry import exemplar as jax_exemplar

    rec = ExemplarRecorder(str(tmp_path / "ex"), budget_mb=1, min_interval_s=0.0)
    rec.write_meta({"model_step": 5})
    words, lengths, scores, alphas = _drained(np.random.default_rng(2))
    sig = quality.extract_signals(words, lengths, scores, vocab_size=VOCAB, eos_id=EOS, alphas=alphas[0])
    assert rec.record(reasons=["low_margin"], request_id="r1", tenant="default", caption="a dog .",
                      beams=[{"caption": "a dog .", "log_prob": -1.5, "prob": 0.22}], signals=sig,
                      image_bytes=b"jpeg-bytes", alphas=alphas[0])
    rows, torn = jax_exemplar.read_exemplars(rec.dir)
    assert torn == 0 and len(rows) == 1 and rows[0]["request_id"] == "r1"
    assert rows[0]["reasons"] == ["low_margin"] and rows[0]["caption"] == "a dog ."
    assert jax_exemplar.load_image(rec.dir, rows[0]) == b"jpeg-bytes"
    assert rows[0]["alphas_digest"] == jax_exemplar.alphas_digest(alphas[0])
    assert jax_exemplar.read_meta(rec.dir) == {"model_step": 5}


@pytest.fixture(scope="module")
def qworld(tmp_path_factory):
    return world(tmp_path_factory.mktemp("quality"), serve_quality="on", serve_quality_window=8)


@pytest.mark.parametrize("mode", ["batch", "continuous"])
def test_serve_quality_matches_jax(qworld, tmp_path, mode):
    """10 requests to both packages' servers with the quality plane on
    (window 8): the same words, /quality_reference 200 with sat_tpu's
    payload shape and counts, /stats quality blocks with sat_tpu's keys
    and request counts; a quota shed; a shed's terminal exemplar in
    sat_tpu's row shape, readable by sat_tpu."""
    tc = qworld["tc"].replace(serve_mode=mode, tenants="main,capped:1:1:1", telemetry_dir=str(tmp_path / "t"))
    jc = qworld["jc"].replace(serve_mode=mode, tenants="main,capped:1:1:1", telemetry_dir=str(tmp_path / "j"))
    out = {}
    with both_servers(jc, tc) as servers:
        for name, server in servers.items():
            server.tenants.use_clock(lambda: 0.0)
            replies = [caption(server.port, qworld["jpegs"][i % 6])[1] for i in range(10)]
            status, _, raw = http(server.port, "GET", "/quality_reference")
            sheds = [caption(server.port, qworld["jpegs"][0], {"X-Tenant": "capped"})[0] for _ in range(2)]
            # a queue-full shed's terminal exemplar, past the recorder's rate limit
            time.sleep(server.exemplars.min_interval_s + 0.05)
            recorded = server.exemplars.stats()["recorded"]
            server._record_terminal_exemplar(type("T", (), {"trace_id": f"shed-{name}"})(), 429, "shed", "capped",
                                             qworld["jpegs"][0])
            out[name] = dict(replies=replies, ref=(status, json.loads(raw)), stats=get_json(server.port, "/stats")[1],
                             sheds=sheds, recorded=(recorded, server.exemplars.stats()["recorded"]),
                             exdir=server.exemplars.dir)
    ours, theirs = out["torch"], out["jax"]
    for a, b in zip(ours["replies"], theirs["replies"]):
        close_beams(a, b)
    assert ours["ref"][0] == theirs["ref"][0] == 200
    ref, jref = ours["ref"][1], theirs["ref"][1]
    assert set(ref["signals"]) == set(jref["signals"])
    for name, entry in ref["signals"].items():
        assert (entry["lo"], entry["hi"], entry["count"]) == (jref["signals"][name]["lo"],
                                                              jref["signals"][name]["hi"],
                                                              jref["signals"][name]["count"])
    q, jq = ours["stats"]["quality"], theirs["stats"]["quality"]
    assert set(q) == set(jq) and q["requests"] == jq["requests"] == 11 and q["reference"] == jq["reference"]
    assert ours["sheds"] == theirs["sheds"] == [200, 429]
    assert ours["recorded"][1] == ours["recorded"][0] + 1
    from sat_tpu.telemetry import exemplar as jax_exemplar

    rows, _ = jax_exemplar.read_exemplars(ours["exdir"])
    jrows, _ = jax_exemplar.read_exemplars(theirs["exdir"])
    assert (rows[-1]["reasons"], rows[-1]["status"], rows[-1]["tenant"]) == (["shed"], 429, "capped")
    assert set(rows[-1]) == set(jrows[-1])
    assert jax_exemplar.load_image(ours["exdir"], rows[-1]) == qworld["jpegs"][0]


def test_bulk_quality_rows_match_jax(qworld, tmp_path):
    """``--phase bulk`` with the quality plane on, both packages, one
    corpus of 5 JPEGs in shards of 2: the same files and words, every
    row's quality block within 1e-6 of sat_tpu's; the port's rerun is
    bitwise its first run."""
    from sat_tpu.bulk.runner import run_bulk as jax_bulk
    from sat_tpu_torch import telemetry
    from sat_tpu_torch.bulk.runner import run_bulk

    corpus = tmp_path / "corpus"
    corpus.mkdir()
    for i, body in enumerate(qworld["jpegs"][:5]):
        (corpus / f"img_{i}.jpg").write_bytes(body)

    def rows(out_dir):
        names = sorted(n for n in os.listdir(out_dir) if n.startswith("captions_") and n.endswith(".jsonl"))
        return [json.loads(line) for n in names for line in open(os.path.join(out_dir, n))]

    def config(c, name):
        return c.replace(phase="bulk", bulk_input=str(corpus), bulk_output=str(tmp_path / name), bulk_shard_rows=2,
                         shard_cache="off", summary_dir=str(tmp_path / (name + "_summary")))

    assert jax_bulk(config(qworld["jc"], "jax")) == 0
    try:
        assert run_bulk(config(qworld["tc"], "torch"), device="cpu") == 0
        assert run_bulk(config(qworld["tc"], "again"), device="cpu") == 0
    finally:
        telemetry.disable()
    ours, theirs = rows(tmp_path / "torch"), rows(tmp_path / "jax")
    assert [r["file"] for r in ours] == [r["file"] for r in theirs] and len(ours) == 5
    for a, b in zip(ours, theirs):
        assert [c["caption"] for c in a["captions"]] == [c["caption"] for c in b["captions"]]
        assert set(a["quality"]) == set(b["quality"]) == {"margin", "norm_logprob", "unk_rate", "coverage_dev"}
        for key, value in a["quality"].items():
            assert abs(value - b["quality"][key]) <= 1e-6, key
    assert rows(tmp_path / "again") == ours
