"""The port's eval and test phases held against sat_tpu's on the CPU.

One fixture dataset (``tests/fixtures.py``: 12 JPEGs, two captions an
image), the small model at float32 and two checkpoints made by
``sat_tpu.runtime.create_train_state`` and ``save_checkpoint``, read by
both packages.  ``max_eval_ann_num=9`` gives 9 annotation ids over 5
images in batches of 4, so the decode drops repeated ids and 3 rows of
padding.  Both packages must write the same results.json rows and
captions; BLEU-1..4, ROUGE_L and CIDEr must agree within 1e-12 and
METEOR within 1e-6; results.csv's ``prob`` within 1e-5 relative; the
attention panels and ``attn.jsonl`` under the same names, alphas within
1e-5.  The JAX package compiles its search once, for the whole module.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from sat_tpu import runtime as jrt
from sat_tpu.data import dataset as jax_dataset
from sat_tpu.data.images import ImageLoader as JaxImageLoader
from sat_tpu.data.images import PrefetchLoader as JaxPrefetchLoader
from sat_tpu.data.vocabulary import vocab_fingerprint as jax_vocab_fingerprint
from sat_tpu.ops.beam_search import greedy_decode as jax_greedy_decode
from sat_tpu.train.checkpoint import restore_checkpoint, save_checkpoint
from sat_tpu_torch import cli
from sat_tpu_torch import runtime
from sat_tpu_torch.data import dataset
from sat_tpu_torch.data.images import ImageLoader, PrefetchDecodeError, PrefetchLoader
from sat_tpu_torch.ops.beam_search import greedy_decode
from sat_tpu_torch.resilience import retry
from sat_tpu_torch.utils import fileio
from tests.torch_port_helpers import configs, port_params, to_torch

torch.set_num_threads(2)

METRICS = ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr")


def assert_scores_match(got, want):
    assert list(got) == list(want) == list(METRICS)
    for k in METRICS:
        assert got[k] == pytest.approx(want[k], rel=0, abs=1e-6 if k == "METEOR" else 1e-12), k


def _settings(coco_fixture, root, **kw):
    c = coco_fixture["config"]
    return dict(
        eval_image_dir=c.eval_image_dir, eval_caption_file=c.eval_caption_file,
        train_caption_file=c.train_caption_file, test_image_dir=c.test_image_dir,
        max_train_ann_num=None, vocabulary_file=str(root / "vocabulary.csv"),
        save_dir=str(root / "models"), batch_size=4, max_eval_ann_num=9,
        num_data_workers=2, save_attention_maps=True,
        # every fixture caption fits, none is filtered out of the vocabulary
        max_caption_length=12, **kw,
    )


def _outputs(config):
    """Each package's own result paths under one root."""
    root = config["root"]
    return dict(
        eval_result_dir=str(root / "eval"), eval_result_file=str(root / "results.json"),
        test_result_dir=str(root / "test"), test_result_file=str(root / "results.csv"),
    )


def _snapshot(config):
    """What an eval or test run left behind, read before the next run."""
    out = {"files": {}}
    for d in (config.eval_result_dir, config.test_result_dir):
        if os.path.isdir(d):
            out["files"][os.path.basename(d)] = sorted(os.listdir(d))
    if os.path.exists(config.eval_result_file):
        with open(config.eval_result_file) as f:
            out["results"] = json.load(f)
    if os.path.exists(os.path.join(config.eval_result_dir, "attn.jsonl")):
        with open(os.path.join(config.eval_result_dir, "attn.jsonl")) as f:
            out["attn"] = [json.loads(line) for line in f]
    return out


@pytest.fixture(scope="module")
def world(coco_fixture, tmp_path_factory):
    """Both packages through evaluate, decode_dataset, test and
    evaluate_sweep on the same checkpoints; what each wrote."""
    root = tmp_path_factory.mktemp("torch_eval")
    jroot, troot = root / "jax", root / "port"
    jc, _ = configs(**_settings(coco_fixture, root), **_outputs({"root": jroot}))
    _, tc = configs(**_settings(coco_fixture, root), **_outputs({"root": troot}))
    vocab = jax_dataset.build_vocabulary(jc)
    init = jax.jit(jrt.create_train_state, static_argnums=1)
    paths = []
    for seed, step in ((0, 0), (1, 7)):
        state = init(jax.random.PRNGKey(seed), jc)
        # at init every caption is "" (the terminator scores first); its
        # logit lowered by 2 gives full-length captions that differ image
        # by image and score above zero
        fc_2 = state.params["decoder"]["decode"]["fc_2"]
        fc_2 = {**fc_2, "bias": fc_2["bias"].at[vocab.word2idx["."]].add(-2.0)}
        decoder = {**state.params["decoder"], "decode": {**state.params["decoder"]["decode"], "fc_2": fc_2}}
        state = state._replace(params={**state.params, "decoder": decoder},
                               step=jnp.asarray(step, jnp.int32))
        paths.append(save_checkpoint(state, jc))
    jstate, count = restore_checkpoint(
        init(jax.random.PRNGKey(2), jc), model_file=paths[0],
        expect_vocab=jax_vocab_fingerprint(jc.vocabulary_file, jc.vocabulary_size),
    )
    assert count > 0
    w = {"jc": jc, "tc": tc, "paths": paths}

    w["jax_scores"] = jrt.evaluate(jc, state=jstate)
    w["jax_eval"] = _snapshot(jc)
    _, ds, _ = jax_dataset.prepare_eval_data(jc)
    w["jax_rows"] = jrt.decode_dataset(jc, jstate, ds, vocab)
    w["jax_test"] = jrt.test(jc, state=jstate)
    w["jax_test_files"] = _snapshot(jc)["files"]["test"]
    w["jax_test_csv"] = pd.read_csv(jc.test_result_file, keep_default_na=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrt, "create_train_state", init)  # the sweep's skeleton, jitted
        w["jax_sweep"] = jrt.evaluate_sweep(jc)
    w["jax_dumps"] = {s: open(os.path.join(jc.save_dir, f"{s}.txt")).read() for s in (0, 7)}

    w["port_scores"] = runtime.evaluate(tc, model_file=paths[0], device="cpu")
    w["port_eval"] = _snapshot(tc)
    state = runtime.setup_state(tc, load=True, model_file=paths[0], device="cpu")
    _, pds, pvocab = dataset.prepare_eval_data(tc)
    w["port_rows"] = runtime.decode_dataset(tc, state, pds, pvocab, device="cpu")
    plain = tc.replace(save_attention_maps=False, eval_result_dir=str(troot / "plain"),
                       eval_result_file=str(troot / "plain.json"))
    w["port_plain_scores"] = runtime.evaluate(plain, state=state, device="cpu")
    w["port_plain"] = _snapshot(plain)
    w["port_test"] = runtime.test(tc, model_file=paths[0], device="cpu")
    w["port_test_files"] = _snapshot(tc)["files"]["test"]
    w["port_test_csv"] = pd.read_csv(tc.test_result_file, keep_default_na=False)
    w["port_sweep"] = runtime.evaluate_sweep(tc, device="cpu")
    w["port_dumps"] = {s: open(os.path.join(tc.save_dir, f"{s}.txt")).read() for s in (0, 7)}
    return w


def test_eval_results_match_jax(world):
    """Same image ids in the same order (each once, padding dropped), the
    same captions, the same scores."""
    want = world["jax_eval"]["results"]
    assert [r["image_id"] for r in want] == [1, 2, 3, 4, 5]
    assert world["port_eval"]["results"] == want
    assert world["port_plain"]["results"] == want
    assert all(len(r["caption"].split()) == 12 for r in want)
    assert len({r["caption"] for r in want}) > 1
    assert world["jax_scores"]["Bleu_1"] > 0 and world["jax_scores"]["CIDEr"] > 0
    assert_scores_match(world["port_scores"], world["jax_scores"])
    assert_scores_match(world["port_plain_scores"], world["jax_scores"])


def test_decode_rows_and_alphas_match_jax(world):
    got, want = world["port_rows"], world["jax_rows"]
    assert [(r["image_id"], r["image_file"], r["caption"], r["words"]) for r in got] == [
        (r["image_id"], r["image_file"], r["caption"], r["words"]) for r in want
    ]
    for g, w in zip(got, want):
        assert g["prob"] == pytest.approx(w["prob"], rel=1e-5)
        assert g["alphas"].shape == w["alphas"].shape == (len(w["words"]), world["tc"].num_ctx)
        np.testing.assert_allclose(g["alphas"], np.asarray(w["alphas"]), rtol=0, atol=1e-5)


def test_attention_artifacts_match_jax(world):
    """The same panel, attn.jsonl and attn.html names; records equal but
    for the run id, alphas (rounded to 4 places) within one rounding step."""
    assert world["port_eval"]["files"]["eval"] == world["jax_eval"]["files"]["eval"]
    assert "attn.jsonl" in world["jax_eval"]["files"]["eval"]
    assert world["port_plain"]["files"] == {}
    got, want = world["port_eval"]["attn"], world["jax_eval"]["attn"]
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        g, w = dict(g), dict(w)
        assert g.pop("run_id") and w.pop("run_id")
        np.testing.assert_allclose(g.pop("alphas"), w.pop("alphas"), rtol=0, atol=1e-4 + 1e-5)
        for k in ("entropy", "entropy_mean", "entropy_frac_mean", "coverage_dev", "alpha_max"):
            np.testing.assert_allclose(g.pop(k), w.pop(k), rtol=0, atol=1e-3)
        assert g == w


def test_test_phase_matches_jax(world):
    """results.csv: the same files and captions, prob within 1e-5
    relative; a captioned JPEG for every image under the JAX package's
    names."""
    got, want = world["port_test_csv"], world["jax_test_csv"]
    assert list(got.columns) == list(want.columns)
    assert list(got["image_files"]) == list(want["image_files"])
    assert list(got["caption"]) == list(want["caption"])
    np.testing.assert_allclose(got["prob"], want["prob"], rtol=1e-5, atol=0)
    assert len(world["port_test"]) == len(world["jax_test"]) == 12
    assert world["port_test_files"] == world["jax_test_files"]
    assert sum(f.endswith("_result.jpg") for f in world["port_test_files"]) == 12


def test_sweep_matches_jax(world):
    """Every checkpoint under save_dir scored as the JAX package scores
    it, with the same ``<step>.txt`` dumps."""
    assert sorted(world["port_sweep"]) == sorted(world["jax_sweep"]) == [0, 7]
    for step in (0, 7):
        assert_scores_match(world["port_sweep"][step], world["jax_sweep"][step])
    assert world["port_dumps"] == world["jax_dumps"]
    assert_scores_match(world["port_sweep"][0], world["jax_scores"])


@pytest.mark.parametrize("seed,valid_size", [(0, None), (1, 30)])
def test_greedy_decode_matches_jax(seed, valid_size):
    jc, tc = configs()
    variables, params = port_params(jc, tc, seed=seed)
    rng = np.random.default_rng(seed)
    contexts = rng.normal(size=(5, tc.num_ctx, tc.dim_ctx)).astype(np.float32)
    want = jax.jit(jax_greedy_decode, static_argnums=(1, 3, 4, 5, 6))(
        variables["params"]["decoder"], jc, jnp.asarray(contexts), 3, None, valid_size, True
    )
    got = greedy_decode(params["decoder"], tc, to_torch(contexts), 3, valid_size=valid_size,
                        return_steps=True)
    assert got.words.shape == (5, 1, tc.max_caption_length)
    np.testing.assert_array_equal(got.words.numpy(), np.asarray(want.words))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_allclose(got.log_scores.numpy(), np.asarray(want.log_scores), rtol=0, atol=1e-5)
    assert got.steps_run == int(want.steps_run)


@pytest.mark.parametrize("count,batch", [(9, 4), (8, 4), (1, 3), (5, 5), (7, 2)])
def test_dataset_batches_match_jax(count, batch):
    """The same batches, the padding included, over two passes (the
    second draws its padding from the next epoch's rng)."""
    ids = list(range(100, 100 + count))
    files = [f"img{i}.jpg" for i in ids]
    got = dataset.DataSet(ids, files, batch)
    want = jax_dataset.DataSet(ids, files, batch)
    assert (got.count, got.num_batches, got.fake_count) == (want.count, want.num_batches, want.fake_count)
    for _ in range(2):
        assert [list(b) for b in got] == [list(b) for b in want]


def test_prepared_data_matches_jax(world):
    jc, tc = world["jc"], world["tc"]
    _, got, got_vocab = dataset.prepare_eval_data(tc)
    _, want, want_vocab = jax_dataset.prepare_eval_data(jc)
    assert list(got.image_ids) == list(want.image_ids) == [1, 1, 2, 2, 3, 3, 4, 4, 5]
    assert list(got.image_files) == list(want.image_files)
    assert got_vocab.words == want_vocab.words
    got, _ = dataset.prepare_test_data(tc)
    want, _ = jax_dataset.prepare_test_data(jc)
    assert list(got.image_files) == list(want.image_files) and got.count == 12


def test_build_vocabulary_matches_jax(coco_fixture, tmp_path):
    """No vocabulary file: both build one from the training captions."""
    jc, tc = configs(**_settings(coco_fixture, tmp_path))
    got = dataset.prepare_eval_data(tc)[2]
    os.remove(tc.vocabulary_file)
    want = jax_dataset.prepare_eval_data(jc)[2]
    assert got.words == want.words and len(got.words) == jc.vocabulary_size
    np.testing.assert_allclose(got.word_frequencies, want.word_frequencies, rtol=1e-12)


@pytest.mark.parametrize("raw", [True, False])
def test_prefetch_loader_matches_jax(coco_fixture, raw):
    files = sorted(os.path.join(coco_fixture["val_img_dir"], f)
                   for f in os.listdir(coco_fixture["val_img_dir"]))[:7]
    got = list(PrefetchLoader(dataset.DataSet(range(7), files, 3), ImageLoader(32, raw=raw),
                              num_workers=2, prefetch_depth=2))
    want = list(JaxPrefetchLoader(jax_dataset.DataSet(range(7), files, 3),
                                  JaxImageLoader(size=32, raw=raw), num_workers=2, prefetch_depth=2))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["files"] == w["files"]
        assert g["images"].dtype == w["images"].dtype
        np.testing.assert_array_equal(g["images"], w["images"])


def test_prefetch_loader_names_the_file_it_cannot_decode(coco_fixture, tmp_path):
    files = sorted(os.path.join(coco_fixture["val_img_dir"], f)
                   for f in os.listdir(coco_fixture["val_img_dir"]))[:3]
    bad = str(tmp_path / "broken.jpg")
    with open(bad, "wb") as f:
        f.write(b"not a jpeg")
    loader = PrefetchLoader(dataset.DataSet(range(4), files + [bad], 2), ImageLoader(32),
                            num_workers=2, prefetch_depth=1)
    with pytest.raises(PrefetchDecodeError, match="broken.jpg") as err:
        list(loader)
    assert (err.value.batch_index, err.value.row) == (1, 1)


def test_cli_builds_eval_and_test_configs(tmp_path):
    config, opts = cli.build_config(
        ["--phase", "eval", "--sweep", "--beam_size", "2", "--shard_cache", "off",
         "--set", "batch_size=20", "--set", "max_eval_ann_num=96"]
    )
    assert (config.phase, config.beam_size, config.shard_cache) == ("eval", 2, "off")
    assert (config.batch_size, config.max_eval_ann_num) == (20, 96)
    assert opts == {"model_file": None, "load": False, "load_cnn": False,
                    "cnn_model_file": "./vgg16_no_fc.npy", "sweep": True, "repair_shards": False,
                    "print_config": False, "supervise": False, "max_restarts": None}
    _, opts = cli.build_config(["--phase", "test", "--model_file", "5.npz", "--load", "--load_cnn",
                                "--cnn_model_file", "r.npy"])
    assert opts == {"model_file": "5.npz", "load": True, "load_cnn": True,
                    "cnn_model_file": "r.npy", "sweep": False, "repair_shards": False,
                    "print_config": False, "supervise": False, "max_restarts": None}
    path = str(tmp_path / "eval.json")
    config.replace(beam_size=4).save(path)
    config, opts = cli.build_config(["--config", path, "--sweep"])
    assert (config.phase, config.beam_size, opts["sweep"]) == ("eval", 4, True)
    assert cli.build_config(["--config", path, "--beam_size", "1"])[0].beam_size == 1
    for argv, why in (
        (["--phase", "eval", "--sweep", "--model_file", "5.npz"], "conflicts"),
        (["--phase", "eval", "--sweep", "--load"], "conflicts"),
        (["--phase", "test", "--sweep"], "only applies"),
        (["--config", path, "--phase", "serve", "--sweep"], "only applies"),
    ):
        with pytest.raises(SystemExit, match=why):
            cli.build_config(argv)


def test_cli_dispatches_eval_test_and_sweep(monkeypatch, capsys):
    calls = []
    scores = {k: 0.25 for k in METRICS}
    monkeypatch.setattr(retry, "_defaults", dict(retry._defaults))
    monkeypatch.setattr(runtime, "setup_state", lambda c, load, model_file: calls.append(
        ("setup", c.phase, load, model_file)) or "state")
    monkeypatch.setattr(runtime, "evaluate", lambda c, state: calls.append(("eval", state)) or scores)
    monkeypatch.setattr(runtime, "test", lambda c, state: calls.append(("test", state)) or [])
    monkeypatch.setattr(runtime, "evaluate_sweep", lambda c: calls.append(("sweep",)) or {
        7: scores, 3: dict(scores, Bleu_4=0.5)})

    assert cli.main(["--phase", "eval", "--model_file", "5.npz", "--set", "io_retries=5"]) == 0
    assert calls == [("setup", "eval", True, "5.npz"), ("eval", "state")]
    assert retry._defaults["retries"] == 5
    assert capsys.readouterr().out.splitlines() == [f"{k}: 0.2500" for k in METRICS]

    calls.clear()
    # the JAX CLI imports a pretrained CNN only in --phase train: eval and
    # test ignore --load_cnn and its (missing) --cnn_model_file
    assert cli.main(["--phase", "test", "--load_cnn", "--cnn_model_file", "missing.npy"]) == 0
    assert calls == [("setup", "test", True, None), ("test", "state")]

    calls.clear()
    assert cli.main(["--phase", "eval", "--sweep"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert calls == [("sweep",)]
    assert [line.split(":")[0] for line in out] == ["step 3", "step 7"]
    assert "Bleu_4=0.5000" in out[0] and "CIDEr=0.2500" in out[1]
    # route and supervise reach the port's own parents (patched here)
    from sat_tpu_torch.resilience import supervisor
    from sat_tpu_torch.serve import router

    monkeypatch.setattr(router, "route", lambda config: calls.append(("route", config.phase)) or 0)
    monkeypatch.setattr(supervisor, "supervise", lambda argv, **kw: calls.append(("supervise", argv)) or 0)
    calls.clear()
    assert cli.main(["--phase", "route"]) == 0
    assert cli.main(["--phase", "eval", "--supervise"]) == 0
    assert calls == [("route", "route"), ("supervise", ["--phase", "eval", "--supervise"])]


@pytest.mark.parametrize(
    "knob",
    [
        {"mesh_shape": (2, 1)},
        {"context_parallel": 2},
        {"telemetry": True},
        {"blackbox": True},
        {"profile_dir": "prof"},
    ],
    ids=lambda k: next(iter(k)),
)
def test_unported_eval_knobs_raise(knob, tmp_path):
    _, tc = configs(**knob, save_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match="not ported"):
        runtime.check_ported(tc)
    for entry in (runtime.evaluate, runtime.test, runtime.evaluate_sweep):
        with pytest.raises(NotImplementedError, match="not ported"):
            entry(tc, device="cpu")


def test_setup_state_without_a_checkpoint_draws_random_weights(tmp_path):
    """No checkpoint to load: parameters drawn from ``config.seed`` (the
    same seed, the same weights), at step 0."""
    from sat_tpu_torch.train.checkpoint import param_shapes, params_to_flat

    _, tc = configs(save_dir=str(tmp_path))
    a, b = (runtime.setup_state(tc, device="cpu") for _ in range(2))
    assert a.step == 0
    fa, fb = params_to_flat(a.params), params_to_flat(b.params)
    assert {k: v.shape for k, v in fa.items()} == param_shapes(tc)
    assert all(np.array_equal(fa[k], fb[k]) for k in fa)


def test_eval_entry_points_need_cuda_unless_cpu_is_asked(world, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tc = world["tc"]
    for call in (
        lambda: runtime.evaluate(tc),
        lambda: runtime.test(tc),
        lambda: runtime.evaluate_sweep(tc),
        lambda: runtime.setup_state(tc, load=True),
        lambda: runtime.decode_dataset(tc, None, None, None),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_sweep_copies_score_like_their_source(world, tmp_path):
    """A copied checkpoint scores exactly as its source, and a file that
    restores no parameter is an error."""
    tc = world["tc"].replace(save_dir=str(tmp_path / "models"))
    os.makedirs(tc.save_dir)
    shutil.copy(world["paths"][1], os.path.join(tc.save_dir, "7.npz"))
    shutil.copy(world["paths"][1], os.path.join(tc.save_dir, "9.npz"))
    sweep = runtime.evaluate_sweep(tc, device="cpu")
    assert sorted(sweep) == [7, 9] and sweep[9] == sweep[7]
    assert_scores_match(sweep[7], world["jax_sweep"][7])
    np.savez(os.path.join(tc.save_dir, "11.npz"), global_step=np.int32(11))
    with pytest.raises(ValueError, match="restored 0 tensors"):
        runtime.evaluate_sweep(tc, device="cpu")


def test_read_json_retries_transient_errors_only(tmp_path, monkeypatch):
    import builtins
    import errno

    path = tmp_path / "c.json"
    fileio.atomic_write(str(path), "w", lambda f: json.dump({"a": 1}, f))
    assert os.listdir(tmp_path) == ["c.json"]
    real_open, failures = builtins.open, []

    def flaky(p, *a, **k):
        if str(p) == str(path) and len(failures) < 2:
            failures.append(p)
            raise OSError(errno.EIO, "I/O error")
        return real_open(p, *a, **k)

    monkeypatch.setattr(builtins, "open", flaky)
    monkeypatch.setattr(retry.time, "sleep", lambda s: None)
    assert fileio.read_json(str(path)) == {"a": 1} and len(failures) == 2
    with pytest.raises(FileNotFoundError):
        fileio.read_json(str(tmp_path / "missing.json"))
    with pytest.raises(ZeroDivisionError):
        fileio.atomic_write(str(tmp_path / "d.json"), "w", lambda f: 1 / 0)
    assert sorted(os.listdir(tmp_path)) == ["c.json"]
