"""sat_tpu_torch's caption scorers, tokenizer, COCO index and attention
exporters against sat_tpu's on the same inputs.

The scorers are pure Python in both packages, with one difference: the
JAX package's METEOR (and its stem and tokenizer) run on its C++ library
where it is built, the port's on the Python copies.  BLEU, ROUGE_L and
CIDEr must agree within 1e-12 and METEOR within 1e-6.
"""

import json
import re

import numpy as np
import pytest

import tests.test_evalcap as jax_evalcap_tests
from sat_tpu import evalcap as jax_evalcap
from sat_tpu.data import tokenizer as jax_tokenizer
from sat_tpu.data.coco import CocoCaptions as JaxCoco
from sat_tpu.evalcap import meteor_data as jax_meteor_data
from sat_tpu.evalcap.meteor import meteor_single as jax_meteor_single
from sat_tpu.telemetry import exporters as jax_exporters
from sat_tpu_torch import evalcap
from sat_tpu_torch.data import tokenizer
from sat_tpu_torch.data.coco import CocoCaptions
from sat_tpu_torch.evalcap.meteor import meteor_single
from sat_tpu_torch.evalcap.porter import stem
from sat_tpu_torch.telemetry import exporters
from tests.fixtures import CAPTIONS

# Caption pairs written to exercise each METEOR stage (exact, stem,
# synonym, paraphrase spans, function words, fragmentation), beside the
# golden and adversarial cases of tests/test_evalcap.py.
HAND_PAIRS = [
    ("a man riding a horse on the beach", "a man riding a horse on the beach"),
    ("a big dog runs across the field", "a large dog runs across the meadow"),
    ("a man is riding a horse", "a man is riding a brown horse"),
    ("the dog ran", "the cat ran"),
    ("two airplanes in the blue sky", "a man riding a horse on the beach"),
    ("dog runs quick", "dogs running quickly"),
    ("f e d c b a", "a b c d e f"),
    ("a dog sleeping beside a fence", "a dog sleeping next to a fence"),
    ("the dog stood before the door", "the dog stood in front of the door"),
    ("a cat atop a car", "a cat on top of a car"),
    ("several people near a bus", "a group of people next to a bus"),
    ("a man rides a horse", "a man is riding a horse"),
    ("", "a man walks"),
    ("man", "a man walks"),
]

METEOR_PAIRS = (
    HAND_PAIRS
    + [(c[0], c[1]) for c in jax_evalcap_tests.TestMeteorGoldenFixtures.CASES]
    + [(c[1], c[2]) for c in jax_evalcap_tests.TestMeteorAlignmentResolution.CASES]
    + [(CAPTIONS[i].rstrip("."), CAPTIONS[(i + 1) % len(CAPTIONS)].rstrip("."))
       for i in range(len(CAPTIONS))]
)


def _fixture_corpus():
    """(gts, res) over the fixture captions: two references an image, the
    hypothesis a caption of another image with a word changed, so every
    n-gram order has partial matches."""
    gts, res = {}, {}
    n = len(CAPTIONS)
    for i in range(n):
        gts[i + 1] = [CAPTIONS[i], CAPTIONS[(i + 1) % n]]
        words = CAPTIONS[(i + 1) % n].split()
        words[len(words) // 2] = "dog"
        res[i + 1] = [" ".join(words)]
    return gts, res


CORPORA = {
    "fixture": _fixture_corpus(),
    **{f"golden{k}": case for k, case in enumerate(jax_evalcap_tests.CASES)},
}


@pytest.mark.parametrize("corpus", sorted(CORPORA))
@pytest.mark.parametrize("scorer", ["Bleu", "Cider", "Meteor", "Rouge"])
def test_scorer_matches_jax(scorer, corpus):
    gts, res = CORPORA[corpus]
    gts = {i: jax_tokenizer.tokenize_captions(c) for i, c in gts.items()}
    res = {i: jax_tokenizer.tokenize_captions(c) for i, c in res.items()}
    got_score, got_each = getattr(evalcap, scorer)().compute_score(gts, res)
    want_score, want_each = getattr(jax_evalcap, scorer)().compute_score(gts, res)
    tol = 1e-6 if scorer == "Meteor" else 1e-12
    np.testing.assert_allclose(np.asarray(got_score), np.asarray(want_score), rtol=0, atol=tol)
    np.testing.assert_allclose(np.asarray(got_each), np.asarray(want_each), rtol=0, atol=tol)


@pytest.mark.parametrize("pair", METEOR_PAIRS, ids=lambda p: f"{p[0][:24]}|{p[1][:24]}")
def test_meteor_matches_jax(pair):
    """Each pair alone and with a second, unrelated reference (the best
    reference wins)."""
    hyp, ref = pair
    for refs in ([ref], [ref, "an unrelated line of words"]):
        assert meteor_single(hyp, refs) == pytest.approx(jax_meteor_single(hyp, refs), abs=1e-6)


def test_porter_stem_matches_the_jax_stemmer():
    from nltk.stem.porter import PorterStemmer

    from sat_tpu import native

    words = set()
    for text in CAPTIONS + [p for pair in METEOR_PAIRS for p in pair]:
        words |= set(text.lower().replace(".", " ").split())
    with open(jax_meteor_data.__file__) as f:
        words |= set(re.findall(r"[a-z]+", f.read()))
    words |= {"caresses", "ponies", "agreed", "hopping", "filing", "happy", "relational",
              "conditional", "digitizer", "generalization", "hopefulness", "electrical",
              "revival", "adjustable", "adoption", "controll", "roll", "y", "sky"}
    nltk_stem = PorterStemmer(mode="ORIGINAL_ALGORITHM").stem
    assert len(words) > 1000
    bad = [(w, stem(w), nltk_stem(w)) for w in sorted(words) if stem(w) != nltk_stem(w)]
    assert not bad, bad[:10]
    if native.available():
        assert [stem(w) for w in sorted(words)] == [native.stem(w) for w in sorted(words)]


TOKENIZER_CASES = CAPTIONS + [
    "A Man's dog doesn't run, can't it?",
    'He said "hello" (twice) -- then left...',
    "a dog. runs. fast.",
    "prices: 3,000 dollars; 5:30 pm!",
    "gonna wanna gotta lemme cannot",
    "",
]


@pytest.mark.parametrize("text", TOKENIZER_CASES)
def test_tokenizer_matches_jax(text):
    assert tokenizer.tokenize(text) == jax_tokenizer.tokenize(text)
    assert tokenizer.tokenize_no_punct(text) == jax_tokenizer.tokenize_no_punct(text)
    assert tokenizer.tokenize_captions([text]) == jax_tokenizer.tokenize_captions([text])


def test_coco_index_and_results_match_jax(coco_fixture):
    path = coco_fixture["val_json"]
    for cap in (None, 5):
        got, want = CocoCaptions(path, cap), JaxCoco(path, cap)
        assert got.dataset == want.dataset
        assert got.anns == want.anns and got.img_to_anns == want.img_to_anns
        assert got.imgs == want.imgs
        assert got.all_captions() == want.all_captions()
    got, want = CocoCaptions(path), JaxCoco(path)
    got.filter_by_cap_len(8)
    want.filter_by_cap_len(8)
    assert got.dataset == want.dataset and got.imgs == want.imgs and len(got.imgs) < 12

    payload = [{"image_id": 1, "caption": "a dog."}, {"image_id": 3, "caption": "a cat."}]
    got_res, want_res = CocoCaptions(path).load_results(payload), JaxCoco(path).load_results(payload)
    assert got_res.dataset == want_res.dataset and got_res.anns == want_res.anns
    assert "id" not in payload[0]
    for bad in ([], [{"image_id": 1}], [{"image_id": 999, "caption": "x."}]):
        with pytest.raises(ValueError) as got_err:
            CocoCaptions(path).load_results(bad)
        with pytest.raises(ValueError) as want_err:
            JaxCoco(path).load_results(bad)
        assert str(got_err.value) == str(want_err.value)
    # every fixture image is on disk: download fetches nothing
    assert CocoCaptions(path).download(coco_fixture["val_img_dir"]) == 0


def test_coco_eval_cap_matches_jax(coco_fixture):
    """The orchestrator end to end: same tokenization, same corpus and
    per-image scores."""
    path = coco_fixture["val_json"]
    payload = [{"image_id": i, "caption": CAPTIONS[(i + 3) % len(CAPTIONS)]} for i in range(1, 9)]
    got = evalcap.CocoEvalCap(CocoCaptions(path), CocoCaptions(path).load_results(payload))
    want = jax_evalcap.CocoEvalCap(JaxCoco(path), JaxCoco(path).load_results(payload))
    got_scores, want_scores = got.evaluate(verbose=False), want.evaluate(verbose=False)
    assert list(got_scores) == list(want_scores)
    for k in want_scores:
        assert got_scores[k] == pytest.approx(want_scores[k], abs=1e-6 if k == "METEOR" else 1e-12)
    assert got.img_to_eval.keys() == want.img_to_eval.keys()
    for i, row in want.img_to_eval.items():
        for k, v in row.items():
            assert got.img_to_eval[i][k] == pytest.approx(v, abs=1e-6 if k == "METEOR" else 1e-12)


def _attention_rows(rng, n=3, N=16):
    rows = []
    for i in range(n):
        L = i + 2
        a = rng.random((L, N)).astype(np.float32)
        rows.append({
            "image_id": i + 1, "image_file": f"/data/img{i}.jpg", "caption": "a dog runs.",
            "words": ["a", "dog", "runs", "."][:L], "alphas": a / a.sum(-1, keepdims=True),
        })
    rows.append({"image_id": 9, "image_file": "/data/none.jpg", "caption": "x."})  # no alphas
    return rows


def test_attention_exporters_match_jax(tmp_path, rng):
    """attn.jsonl records equal the JAX package's but for the run id, and
    the contact sheet is the same HTML but for the run id."""
    rows = _attention_rows(rng)
    got_n = exporters.export_attention_jsonl(rows, str(tmp_path / "got" / "attn.jsonl"))
    want_n = jax_exporters.export_attention_jsonl(rows, str(tmp_path / "want" / "attn.jsonl"))
    assert got_n == want_n == 3
    read = lambda p: [json.loads(line) for line in open(p)]  # noqa: E731
    got, want = read(tmp_path / "got" / "attn.jsonl"), read(tmp_path / "want" / "attn.jsonl")
    for g, w in zip(got, want):
        assert g.pop("run_id") and w.pop("run_id")
        assert g == w
    sheets = [
        mod.render_attention_sheet(rows, str(tmp_path / name / "attn.html"))
        for mod, name in ((exporters, "got"), (jax_exporters, "want"))
    ]
    from sat_tpu.telemetry import run_id as jax_run_id
    from sat_tpu_torch.telemetry import run_id

    html = [open(s).read() for s in sheets]
    assert html[0].replace(run_id(), "RUN") == html[1].replace(jax_run_id(), "RUN")
    assert exporters.render_attention_sheet(rows[-1:], str(tmp_path / "none.html")) is None
