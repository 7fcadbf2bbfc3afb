"""Context parallelism in the port, held against sat_tpu's single-device
loss, gradients and search on the CPU.

The ranks run as gloo processes (``tests/torch_dist_helpers.py``) at the
JAX package's context-parallel test size (32 px images → N = 4
positions, split 2 ways), on ``init_variables``' weights through the npz
bridge.  Held: the loss of a (1, 2) and a (2, 2) mesh within ``rtol
1e-5`` of the single-device loss and, unlike the JAX package's own
tests, its gradients too (with and without ``remat_decoder``, with the
fc activity term), for one and two attend layers; the search's words
and lengths identical and alphas within 1e-5; dropout masks on
replicated tensors bitwise equal across the model ranks and on
context-sharded tensors distinct; a few steps with dropout on learning
with the model ranks' parameters bitwise equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sat_tpu.config import Config as JaxConfig
from sat_tpu.models.captioner import compute_loss, encode
from sat_tpu.ops.beam_search import beam_search
from sat_tpu.train.checkpoint import flatten_with_names
from tests.torch_dist_helpers import run_ranks
from tests.torch_port_helpers import jax_variables

torch.set_num_threads(2)

# tests/test_context_parallel.py's _cfg
CP = dict(
    image_size=32, vocabulary_size=50, dim_embedding=8, num_lstm_units=8, dim_initialize_layer=8,
    dim_attend_layer=16, dim_decode_layer=16, max_caption_length=5, compute_dtype="float32",
    fc_drop_rate=0.0, lstm_drop_rate=0.0,
)
VARIANTS = {
    "two_layers": dict(num_attend_layers=2),
    "one_layer": dict(num_attend_layers=1),
    "activity": dict(num_attend_layers=2, fc_activity_regularizer_scale=1e-3),
}


def _flat(tree, prefix="params/"):
    return {k: np.asarray(v) for k, v in flatten_with_names(tree, prefix).items()}


def _jax_loss_and_grads(knobs):
    """JAX's single-device metrics (train=False) and, with dropout off,
    train-mode metrics and gradients of the decoder."""
    jc = JaxConfig(**{**CP, **knobs})
    variables = jax_variables(jc)
    cnn, decoder = variables["params"]["cnn"], variables["params"]["decoder"]
    rng = np.random.default_rng(0)
    B, T = 4, jc.max_caption_length
    batch = {
        "contexts": rng.normal(size=(B, jc.num_ctx, jc.dim_ctx)).astype(np.float32),
        "word_idxs": rng.integers(0, jc.vocabulary_size, size=(B, T)).astype(np.int32),
        "masks": (rng.random((B, T)) > 0.3).astype(np.float32),
    }
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def f(p, train):
        total, aux = compute_loss({"params": {"cnn": cnn, "decoder": p}}, jc, jb, rng=jax.random.PRNGKey(1),
                                  train=train)
        return total, aux["metrics"]

    _, eval_metrics = jax.jit(lambda p: f(p, False))(decoder)
    (_, train_metrics), grads = jax.jit(jax.value_and_grad(lambda p: f(p, True), has_aux=True))(decoder)
    return {
        "flat": _flat({"decoder": decoder}), "batch": batch,
        "eval": {k: float(v) for k, v in eval_metrics.items()},
        "train": {k: float(v) for k, v in train_metrics.items()},
        "grads": {k: np.asarray(v) for k, v in flatten_with_names(grads, "").items()},
    }


def _jax_search(layers):
    jc = JaxConfig(**{**CP, "num_attend_layers": layers, "beam_size": 3, "max_caption_length": 6})
    variables = jax_variables(jc)
    images = np.random.default_rng(1).integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    contexts, _ = encode(variables, jc, jnp.asarray(images), train=False)
    out = beam_search(variables["params"]["decoder"], jc, contexts, 1, valid_size=40, return_alphas=True)
    return {"flat": _flat(variables["params"]), "images": images,
            "want": {k: np.asarray(getattr(out, k)) for k in ("words", "lengths", "log_scores", "alphas")}}


@pytest.fixture(scope="module")
def jax_side():
    return {
        "loss": {name: _jax_loss_and_grads(knobs) for name, knobs in VARIANTS.items()},
        "search": {layers: _jax_search(layers) for layers in (1, 2)},
    }


def _train_batches(n):
    """``n`` copies of one batch of 32 px images (the JAX test's "same
    batch, the loss must fall")."""
    rng = np.random.default_rng(5)
    batch = {
        "images": rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8),
        "word_idxs": rng.integers(1, CP["vocabulary_size"], (4, CP["max_caption_length"])).astype(np.int32),
        "masks": np.ones((4, CP["max_caption_length"]), np.float32),
    }
    return [batch] * n


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_context_parallel_matches_single_device(jax_side, shape, tmp_path):
    mesh = {"mesh_shape": shape, "context_parallel": shape[1]}
    loss_items = [{"config": {**CP, **knobs, **mesh}, "flat": jax_side["loss"][name]["flat"],
                   "batch": jax_side["loss"][name]["batch"]} for name, knobs in VARIANTS.items()]
    search_items = [{"config": {**CP, "num_attend_layers": layers, "beam_size": 3, "max_caption_length": 6, **mesh},
                     "flat": jax_side["search"][layers]["flat"], "images": jax_side["search"][layers]["images"],
                     "eos": 1, "valid_size": 40} for layers in (1, 2)]
    train = {"config": {**CP, **mesh, "fc_drop_rate": 0.5, "lstm_drop_rate": 0.3, "initial_learning_rate": 1e-2},
             "flat": jax_side["search"][2]["flat"], "batches": _train_batches(6)}
    args = {
        "loss_grads": loss_items, "decode": search_items, "train_steps": train,
        "masks": {"config": {**CP, **mesh}, "batch": 4, "step": 3},
    }
    ranks = run_ranks(int(np.prod(shape)), ["loss_grads", "decode", "train_steps", "masks"], args, str(tmp_path))
    mp = shape[1]
    for r, res in enumerate(ranks):
        # the loss, its metrics and its gradients
        for name, got in zip(VARIANTS, res["loss_grads"]):
            want = jax_side["loss"][name]
            for k, v in want["eval"].items():
                np.testing.assert_allclose(got["eval_metrics"][k], v, rtol=1e-5, atol=1e-7, err_msg=f"{name} {k}")
            for variant in ("plain", "remat"):
                for k, v in want["train"].items():
                    np.testing.assert_allclose(got[variant]["metrics"][k], v, rtol=1e-5, atol=1e-7,
                                               err_msg=f"{name} {variant} {k}")
                assert set(got[variant]["grads"]) == set(want["grads"])
                for k, v in want["grads"].items():
                    np.testing.assert_allclose(got[variant]["grads"][k], v, rtol=1e-5, atol=1e-7,
                                               err_msg=f"{name} {variant} {k}")
        # the search over this rank's rows, alphas gathered to the grid
        rows = slice((r // mp) * (4 // shape[0]), (r // mp + 1) * (4 // shape[0]))
        for layers, got in zip((1, 2), res["decode"]):
            want = jax_side["search"][layers]["want"]
            np.testing.assert_array_equal(got["words"], want["words"][rows])
            np.testing.assert_array_equal(got["lengths"], want["lengths"][rows])
            np.testing.assert_allclose(got["log_scores"], want["log_scores"][rows], rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(got["alphas"], want["alphas"][rows], rtol=0, atol=1e-5)
        # dropout on: the model ranks stay bitwise equal, and the loss falls
        steps = res["train_steps"]
        peer = ranks[r - r % mp]
        losses = [m["total_loss"] for m in steps["metrics"]]
        assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
        assert losses == [m["total_loss"] for m in peer["train_steps"]["metrics"]]
        for k, v in steps["own"].items():
            np.testing.assert_array_equal(v, peer["train_steps"]["own"][k], err_msg=k)
        # masks: a replicated tensor's equal across the model group, a
        # context-sharded tensor's distinct from every other block's
        np.testing.assert_array_equal(res["masks"]["replicated"], peer["masks"]["replicated"])
        for other in range(r - r % mp, r - r % mp + mp):
            if other != r:
                assert not np.array_equal(res["masks"]["sharded"], ranks[other]["masks"]["sharded"])
    # data ranks draw their rows of the global batch's masks
    if shape[0] > 1:
        assert not np.array_equal(ranks[0]["masks"]["replicated"], ranks[mp]["masks"]["replicated"])


def test_context_parallel_runs_a_training_resnet50_with_global_moments(tmp_path):
    """``train_cnn`` with ResNet50 on a (2, 2) context-parallel mesh (64 px
    → 4 positions): a step runs, its loss is finite, the running
    statistics move, identically on the two model ranks of a data row."""
    from tests.torch_port_helpers import configs

    jc, tc = configs(cnn="resnet50", image_size=64)
    variables = jax_variables(jc)
    flat = {**_flat(variables["params"]), **_flat(variables["batch_stats"], "batch_stats/")}
    rng = np.random.default_rng(2)
    batch = {
        "images": rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8),
        "word_idxs": rng.integers(1, 50, (4, 8)).astype(np.int32),
        "masks": np.ones((4, 8), np.float32),
    }
    config = {k: v for k, v in tc.to_dict().items() if k in tc.__dataclass_fields__}
    config.update(train_cnn=True, mesh_shape=(2, 2), context_parallel=2)
    args = {"config": config, "flat": flat, "batches": [batch], "keep": ("batch_stats/",)}
    ranks = run_ranks(4, ["train_steps"], args, str(tmp_path))
    stats = [k for k in flat if k.startswith("batch_stats/")]
    for r, res in enumerate(ranks):
        got = res["train_steps"]
        assert np.isfinite(got["metrics"][0]["total_loss"])
        assert all(not np.array_equal(got["flat"][k], flat[k]) for k in stats)
        peer = ranks[r - r % 2]["train_steps"]["flat"]
        for k in stats:
            np.testing.assert_array_equal(got["flat"][k], peer[k], err_msg=k)
    # the data group's moments are global: both data rows hold one update
    for k in stats:
        np.testing.assert_array_equal(ranks[0]["train_steps"]["flat"][k], ranks[2]["train_steps"]["flat"][k])
