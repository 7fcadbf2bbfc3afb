"""The plain reference agrees with the program at a tiny size on the CPU,
in float32: the encoders' contexts, the beam search's words and scores,
and three training steps' losses, gradients and changes."""

import time

import pytest
import torch

from capbench import compare, inputs
from capbench.drivers import offline, train
from capbench.reference import model as ref
from conftest import tiny_cell


@pytest.mark.parametrize("cell", ["vgg16.offline_b512", "resnet50.offline_b512"])
def test_offline_reference_equals_the_program_in_float32(cell):
    c = tiny_cell(cell, compute_dtype="float32")
    out = offline.run(c, 2 ** 31 + 5, 0.5, False, torch.device("cpu"), time.perf_counter())
    assert out["readings"]["contexts_off10"] <= 1e-4
    assert out["readings"]["score_err"] <= 1e-4
    assert out["failed"] == 0


@pytest.mark.parametrize("cell", ["vgg16.offline_b512", "resnet50.offline_b512"])
def test_reference_beam_search_finds_the_programs_captions(cell):
    from sat_tpu_torch.ops.beam_search import beam_search
    from sat_tpu_torch.train.checkpoint import params_from_flat

    from capbench.bench import program_config

    c = tiny_cell(cell, compute_dtype="float32")
    config = program_config(c.config)
    flat = inputs.make_weights(c.config, 3, "cpu")
    contexts = torch.rand((6, c.config["num_ctx"], c.config["dim_ctx"]), generator=torch.Generator().manual_seed(1))
    params = params_from_flat({k: v for k, v in flat.items()}, config, "cpu")
    got = beam_search(params["decoder"], config, contexts, c.config["eos_id"], valid_size=c.config["vocabulary_size"])
    words, scores, lengths = ref.beam_search(ref.Decoder(c.config, flat), contexts, c.config["beam_size"],
                                             c.config["max_caption_length"], c.config["eos_id"])
    assert torch.equal(got.words, words) and torch.equal(got.lengths, lengths)
    torch.testing.assert_close(got.log_scores, scores, rtol=0, atol=1e-4)


def test_reference_finds_finished_captions_as_the_program_does():
    """An end token favoured by its bias: captions finish early and the
    finished-first ranking decides the result."""
    from sat_tpu_torch.ops.beam_search import beam_search
    from sat_tpu_torch.train.checkpoint import params_from_flat

    from capbench.bench import program_config

    c = tiny_cell("vgg16.offline_b512", compute_dtype="float32")
    config = program_config(c.config)
    flat = inputs.make_weights(c.config, 4, "cpu")
    flat["params/decoder/decode/fc_2/bias"][c.config["eos_id"]] = 2.5
    contexts = torch.rand((6, c.config["num_ctx"], c.config["dim_ctx"]), generator=torch.Generator().manual_seed(2))
    got = beam_search(params_from_flat(flat, config, "cpu")["decoder"], config, contexts, c.config["eos_id"],
                      valid_size=c.config["vocabulary_size"])
    words, scores, lengths = ref.beam_search(ref.Decoder(c.config, flat), contexts, c.config["beam_size"],
                                             c.config["max_caption_length"], c.config["eos_id"])
    assert (lengths < c.config["max_caption_length"]).any()
    assert torch.equal(got.words, words) and torch.equal(got.lengths, lengths)
    torch.testing.assert_close(got.log_scores, scores, rtol=0, atol=1e-4)


def test_score_words_reads_the_programs_scores():
    c = tiny_cell("vgg16.offline_b512", compute_dtype="float32")
    flat = inputs.make_weights(c.config, 5, "cpu")
    images = inputs.make_images(4, c.config["image_size"], 5, "cpu")
    dec = ref.Decoder(c.config, flat)
    contexts = ref.encode(c.config, flat, images)
    words, scores, lengths = ref.beam_search(dec, contexts, 3, c.config["max_caption_length"], c.config["eos_id"])
    readings, _ = compare.caption_checks(c.config, flat, images, words, scores, lengths, contexts=contexts)
    assert readings["score_err"] <= 1e-4 and readings["contexts_off10"] == 0.0


def test_train_reference_follows_the_programs_first_steps_in_float32():
    c = tiny_cell("vgg16.train_b1024", compute_dtype="float32")
    out = train.run(c, 2 ** 31 + 6, 0.5, False, torch.device("cpu"), time.perf_counter())
    assert out["readings"]["loss_err"] <= 1e-5
    assert out["readings"]["grad_err"] <= 1e-4
    assert out["readings"]["change_err"] <= 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_run_whose_captions_finish_is_judged_correct(dtype, monkeypatch):
    """The cells' seed-made weights never end a caption (every beam runs
    T steps), so the end-token rules of the search run only here: an end
    token favoured by its bias, captions of several lengths, judged
    through the whole offline run."""
    c = tiny_cell("vgg16.offline_b512", compute_dtype=dtype)
    make = inputs.make_weights

    def favoured(cfg, seed, device):
        flat = make(cfg, seed, device)
        flat["params/decoder/decode/fc_2/bias"][cfg["eos_id"]] = 0.85
        return flat

    seen = {}
    checks = compare.caption_checks

    def keep(cfg, flat, images, words, scores, lengths, **k):
        seen["lengths"] = lengths
        return checks(cfg, flat, images, words, scores, lengths, **k)

    monkeypatch.setattr(inputs, "make_weights", favoured)
    monkeypatch.setattr(compare, "caption_checks", keep)
    out = offline.run(c, 2 ** 31 + 7, 0.5, False, torch.device("cpu"), time.perf_counter())
    T = c.config["max_caption_length"]
    assert (seen["lengths"] < T).any() and len(seen["lengths"].unique()) >= 3, seen["lengths"]
    if dtype == "float32":
        assert out["readings"]["score_err"] <= 1e-4 and out["readings"]["search_slack"] <= 1e-4
    assert all(v["value"] <= v["limit"] for v in out["checks"].values()), out["checks"]


@pytest.mark.parametrize("bias", [None, 0.85])
def test_search_slack_holds_the_reference_search_and_catches_its_breaches(bias):
    """The reference's own beam search reads no slack; beams swapped, one
    returned twice, or a kept word swapped for a dropped one read above 0."""
    c = tiny_cell("vgg16.offline_b512")
    cfg, K, T, eos = c.config, c.config["beam_size"], c.config["max_caption_length"], c.config["eos_id"]
    flat = inputs.make_weights(cfg, 9, "cpu")
    if bias is not None:
        flat["params/decoder/decode/fc_2/bias"][eos] = bias
    dec = ref.Decoder(cfg, flat)
    contexts = torch.rand((16, cfg["num_ctx"], cfg["dim_ctx"]), generator=torch.Generator().manual_seed(3))
    words, scores, lengths = ref.beam_search(dec, contexts, K, T, eos)

    def slack(w, n, s=scores):
        logp = ref.step_logps(dec, ref.tile(contexts, K), w.reshape(-1, T)).view(16, K, T, -1)
        return compare.search_slack(logp, w, n, s, eos)

    assert slack(words, lengths).max() <= 1e-5
    swapped = slack(words[:, [1, 0, 2]], lengths[:, [1, 0, 2]], scores[:, [1, 0, 2]])
    assert (swapped > 1e-3).sum() >= 12
    twice = slack(words[:, [0, 0, 2]], lengths[:, [0, 0, 2]], scores[:, [0, 0, 2]])
    assert torch.isinf(twice).all()
    live = lengths[:, 0] == T
    dropped = words.clone()
    second = ref.step_logps(dec, contexts, words[:, 0]).topk(2, dim=-1).indices[:, T - 1, 1]
    dropped[:, 0, T - 1] = torch.where(second == words[:, 0, T - 1], dropped[:, 0, T - 1], second)
    worse = slack(dropped, lengths)[live & (dropped[:, 0, T - 1] != words[:, 0, T - 1])]
    assert len(worse) and (worse > 0).all()
