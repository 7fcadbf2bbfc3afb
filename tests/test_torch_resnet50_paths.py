"""ResNet50 through the port's decoding paths on the CPU, held against
sat_tpu's on one checkpoint: batch serving (``ServeEngine.dispatch``),
continuous serving (the slot pool), ``--phase eval`` and ``--phase bulk``.

The checkpoint is sat_tpu's ``<step>.npz`` of the small model with
ResNet50 at 64 px (N = 4, D = 2048) and float32: ``init_variables``'s
weights with the batch-norm scales and running statistics redrawn from a
numpy seed (so every batch norm does real work) and the terminator's bias
lowered by 2 (so captions run full length), written by sat_tpu's
``save_checkpoint`` with its ``batch_stats/`` and LAST_GOOD.  Held: the
same words as JAX's encode + beam search; eval's results.json rows
equal; bulk rows with equal captions.  Log-scores are held relative to
their size: these 12-word captions score about −41, where a float32 ulp
is 3.8e-6 and the two packages' sums (2048-wide contexts, 12 steps) land
up to 6 ulps apart; so log-scores within 1e-6 relative (about 10 ulps),
and bulk's ``prob`` = exp(log_prob) within 5e-5 relative, which is the
log-prob's absolute error.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sat_tpu import runtime as jrt
from sat_tpu import telemetry as jax_telemetry
from sat_tpu.bulk.runner import run_bulk as jax_run_bulk
from sat_tpu.data import dataset as jax_dataset
from sat_tpu.data.images import ImageLoader as JaxImageLoader
from sat_tpu.models.captioner import encode as jax_encode
from sat_tpu.ops.beam_search import beam_search as jax_beam_search
from sat_tpu.train.checkpoint import save_checkpoint
from sat_tpu.train.step import TrainState as JaxTrainState
from sat_tpu_torch import runtime, telemetry
from sat_tpu_torch.bulk import runner
from sat_tpu_torch.data.vocabulary import Vocabulary
from sat_tpu_torch.ops.fused_attend import fused_attend
from sat_tpu_torch.serve.engine import ServeEngine, load_serving_state
from sat_tpu_torch.serve.slot_pool import PagedSlotPool
from tests.test_torch_bulk import rows
from tests.test_torch_eval import _outputs, _settings, _snapshot
from tests.test_torch_serve import _jpegs
from tests.torch_port_helpers import configs, jax_variables

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def world(coco_fixture, tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_resnet50_paths")
    corpus = str(root / "corpus")
    shutil.copytree(coco_fixture["train_img_dir"], corpus)
    settings = dict(
        _settings(coco_fixture, root), cnn="resnet50", image_size=64, beam_size=2,
        save_attention_maps=False, serve_buckets=(1, 4), serve_max_batch=4,
        serve_slot_pages=2, serve_page_width=2, shard_cache="off", heartbeat_interval=0.0,
        bulk_input=corpus, bulk_shard_rows=5, temp_annotation_file=str(root / "anns.csv"),
        temp_data_file=str(root / "data.npy"),
    )
    jc, _ = configs(**settings, **_outputs({"root": root / "jax"}))
    _, tc = configs(**settings, **_outputs({"root": root / "port"}))
    vocab = jax_dataset.build_vocabulary(jc)
    variables = jax_variables(jc)
    rng = np.random.default_rng(11)

    def redraw(path, leaf):
        name = path[-1].key
        if name == "mean":
            return jnp.asarray(rng.normal(0, 0.1, leaf.shape), jnp.float32)
        if name in ("var", "scale"):
            return jnp.asarray(rng.uniform(0.5, 1.5, leaf.shape), jnp.float32)
        return leaf

    params = jax.tree_util.tree_map_with_path(redraw, variables["params"])
    batch_stats = jax.tree_util.tree_map_with_path(redraw, variables["batch_stats"])
    fc_2 = params["decoder"]["decode"]["fc_2"]
    fc_2 = {**fc_2, "bias": fc_2["bias"].at[vocab.word2idx["."]].add(-2.0)}
    params = {**params, "decoder": {**params["decoder"], "decode": {**params["decoder"]["decode"], "fc_2": fc_2}}}
    jstate = JaxTrainState(params=params, batch_stats=batch_stats, opt_state=(),
                           step=jnp.asarray(5, jnp.int32))
    path = save_checkpoint(jstate, jc)
    return {"jc": jc, "tc": tc, "vocab": vocab, "path": path, "root": root,
            "variables": {"params": params, "batch_stats": batch_stats}, "jstate": jstate}


def _jax_captions(world, images):
    jc, vocab = world["jc"], world["vocab"]
    ctx = jax.jit(lambda v, x: jax_encode(v, jc, x)[0])(world["variables"], images)
    res = jax_beam_search(world["variables"]["params"]["decoder"], jc, ctx, vocab.word2idx["."],
                          valid_size=len(vocab.words))
    words, lengths, scores = map(np.asarray, (res.words, res.lengths, res.log_scores))
    return words, lengths, scores


@pytest.fixture(scope="module")
def engine(world):
    tc = world["tc"]
    state, source = load_serving_state(tc, device="cpu")
    assert source == world["path"] and state.batch_stats
    return ServeEngine(tc, state, Vocabulary(tc.vocabulary_size, tc.vocabulary_file), device="cpu")


@pytest.fixture(scope="module")
def images(world):
    loader = JaxImageLoader(size=world["jc"].image_size, raw=True)
    return np.stack([loader.load_bytes(b) for b in _jpegs(4, seed=3)])


def test_batch_serve_captions_match_jax(world, engine, images):
    """A bucket-4 dispatch: the same words as JAX's encode + beam search,
    log-scores within 1e-6 relative; the ResNet50 grid (N=4, D=2048) reaches the
    search, whose attention on the CPU is the plain version."""
    want_words, want_lengths, want_scores = _jax_captions(world, images)
    batch, bucket = engine.pad_batch(list(images))
    assert bucket == 4
    before = fused_attend.launches
    words, lengths, scores, alphas = engine.drain_output(engine.dispatch(batch), 4)
    assert alphas is None  # serve_quality off
    assert fused_attend.launches == before
    assert engine.encode_images(batch).shape == (4, 4, 2048)
    np.testing.assert_array_equal(lengths, want_lengths)
    for i in range(4):
        for k in range(2):
            n = int(want_lengths[i, k])
            np.testing.assert_array_equal(words[i, k, :n], want_words[i, k, :n])
    np.testing.assert_allclose(scores, want_scores, rtol=1e-6, atol=0)
    assert len({tuple(w[0]) for w in want_words}) > 1


def test_continuous_serve_captions_match_jax(world, engine, images):
    """The same four images through a 2 × 2 slot pool (two admissions,
    decode steps of depth 1 until every slot is harvested): JAX's words,
    log-scores within 1e-6 relative."""
    want_words, want_lengths, want_scores = _jax_captions(world, images)
    pool = PagedSlotPool(engine)
    pool.reset()
    assert pool.admit([(images[i], i) for i in range(4)]) == 4
    got = {}
    for _ in range(4 * world["tc"].max_caption_length):
        done, _ = pool.multi_step(1)
        payloads, words, lengths, scores, _steps, _alphas = pool.harvest(done.cpu().numpy())
        got.update({p: (w, n, s) for p, w, n, s in zip(payloads, words, lengths, scores)})
        if len(got) == 4:
            break
    assert sorted(got) == [0, 1, 2, 3]
    for i, (words, lengths, scores) in got.items():
        np.testing.assert_array_equal(lengths, want_lengths[i])
        for k in range(2):
            n = int(lengths[k])
            np.testing.assert_array_equal(words[k, :n], want_words[i, k, :n])
        np.testing.assert_allclose(scores, want_scores[i], rtol=1e-6, atol=0)


def test_eval_results_match_jax(world):
    """``evaluate`` on the fixture's eval split: results.json rows equal
    (the same ids, in order, and the same captions)."""
    jrt.evaluate(world["jc"], state=world["jstate"])
    runtime.evaluate(world["tc"], model_file=world["path"], device="cpu")
    want, got = _snapshot(world["jc"])["results"], _snapshot(world["tc"])["results"]
    assert got == want
    assert len(want) == 5 and len({r["caption"] for r in want}) > 1


def test_bulk_rows_match_jax(world):
    """``--phase bulk`` over the 12 fixture JPEGs in shards of 5 through the
    2 × 2 slot pool: the same rows and captions, ``log_prob`` within 1e-6
    relative and ``prob`` within 5e-5 relative."""
    root = world["root"]
    jcfg = world["jc"].replace(phase="bulk", bulk_output=str(root / "bulk_jax"),
                               quarantine_ledger=str(root / "bulk_jax.jsonl"))
    tcfg = world["tc"].replace(phase="bulk", bulk_output=str(root / "bulk_port"),
                               quarantine_ledger=str(root / "bulk_port.jsonl"))
    try:
        assert jax_run_bulk(jcfg, model_file=world["path"]) == 0
    finally:
        jax_telemetry.disable()
    try:
        assert runner.run_bulk(tcfg, model_file=world["path"], device="cpu") == 0
    finally:
        telemetry.disable()
    jrows, trows = rows(jcfg.bulk_output), rows(tcfg.bulk_output)
    assert len(trows) == len(jrows) == 12
    for a, b in zip(jrows, trows):
        assert a["file"] == b["file"]
        assert [c["caption"] for c in a["captions"]] == [c["caption"] for c in b["captions"]]
        for x, y in zip(a["captions"], b["captions"]):
            assert y["log_prob"] == pytest.approx(x["log_prob"], rel=1e-6, abs=0)
            assert y["prob"] == pytest.approx(x["prob"], rel=5e-5, abs=0)
    assert os.path.exists(os.path.join(tcfg.bulk_output, "bulk_manifest.json"))
