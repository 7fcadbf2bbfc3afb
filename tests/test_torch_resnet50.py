"""The port's ResNet50 held against sat_tpu's on the same weights
(sat_tpu's ``init_variables`` through the bridge, its batch-norm scales
and running statistics redrawn from a numpy seed so every batch norm does
real work) and the same numpy images, at 64 px (N = 4) and float32: the
bridge's names and round trip, the contexts in inference and training
mode, three ``--train_cnn`` steps, the eval-loss step, and checkpoints
crossing between the packages with their ``batch_stats/``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

from sat_tpu.models.captioner import encode as jax_encode
from sat_tpu.train.checkpoint import flatten_with_names
from sat_tpu.train.checkpoint import restore_checkpoint as jax_restore_checkpoint
from sat_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from sat_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from sat_tpu.train.step import TrainState as JaxTrainState
from sat_tpu.train.step import make_eval_loss_step as jax_make_eval_loss_step
from sat_tpu.train.step import make_train_step as jax_make_train_step
from sat_tpu.train.step import split_trainable as jax_split_trainable
from sat_tpu_torch.models.captioner import _preprocess, encode, init_variables
from sat_tpu_torch.models.resnet50 import resnet50
from sat_tpu_torch.train.checkpoint import (
    batch_stats_from_flat, compute_params, named_leaves, param_shapes, params_from_flat,
    params_to_flat, restore_checkpoint, save_checkpoint, state_to_flat,
)
from sat_tpu_torch.train.step import (
    create_train_state, make_eval_loss_step, make_train_step, state_from_params, step_generator,
)
from tests.test_torch_train import LOSSES, NO_DROPOUT, make_batch, torch_batch
from tests.torch_port_helpers import configs, jax_variables

torch.set_num_threads(2)

RESNET = dict(cnn="resnet50", image_size=64)


def _flat(tree, prefix):
    return {k: np.asarray(v) for k, v in flatten_with_names(tree, prefix).items()}


@pytest.fixture(scope="module")
def world():
    """(jax config, port config, the flat weights and statistics both
    packages get, JAX's nested variables)."""
    jc, tc = configs(**RESNET, **NO_DROPOUT)
    variables = jax_variables(jc)
    flat = {**_flat(variables["params"], "params/"), **_flat(variables["batch_stats"], "batch_stats/")}
    rng = np.random.default_rng(7)
    for name, value in sorted(flat.items()):
        if name.endswith("/mean"):
            flat[name] = rng.normal(0, 0.1, value.shape).astype(np.float32)
        elif name.endswith(("/var", "/scale")):
            flat[name] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
    nested = unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    return jc, tc, flat, nested


def _port(flat, tc):
    return params_from_flat(flat, tc), batch_stats_from_flat(flat, tc)


def _images(tc, B=2, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B, tc.image_size, tc.image_size, 3), dtype=np.uint8)


def test_param_shapes_are_the_jax_names_and_shapes(world):
    """``param_shapes`` gives exactly the flat names and shapes JAX's
    ``init_variables`` creates: nested blocks, conv1's bias alone among
    the convs, batch-norm scale/bias, and ``batch_stats/`` mean/var."""
    jc, tc, _, _ = world
    variables = jax_variables(jc)
    want = {k: v.shape for k, v in flatten_with_names(variables).items()}
    assert param_shapes(tc) == want
    assert "params/cnn/res2a/res2a_branch1/conv/kernel" in want
    assert "params/cnn/res2a/bn2a_branch1/scale" in want
    assert "batch_stats/res5c/bn5c_branch2c/var" in want
    assert [k for k in want if k.startswith("params/cnn/") and k.endswith("conv/bias")] == [
        "params/cnn/conv1/conv/bias"
    ]


def test_bridge_round_trip_is_bitwise(world):
    _, tc, flat, _ = world
    params, stats = _port(flat, tc)
    back = {**params_to_flat(params), **{n: t.numpy() for n, t, _ in named_leaves(stats, "batch_stats/")}}
    assert set(back) == set(flat)
    for name, value in flat.items():
        np.testing.assert_array_equal(back[name], value, err_msg=name)
    k = flat["params/cnn/res3a/res3a_branch2b/conv/kernel"]
    w = params["cnn"]["res3a"]["res3a_branch2b"]["weight"].numpy()
    np.testing.assert_array_equal(w[5, 7], k[:, :, 7, 5])
    assert set(params["cnn"]["res3a"]["res3a_branch2b"]) == {"weight"}
    with pytest.raises(KeyError, match="lacks 1"):
        batch_stats_from_flat({k: v for k, v in flat.items() if k != "batch_stats/bn_conv1/var"}, tc)


def test_inference_contexts_match_jax(world):
    """Batch norms on the running statistics: contexts within 1e-5 of JAX's
    relative to max|ctx| (float32 convs summed in another order)."""
    jc, tc, flat, nested = world
    images = _images(tc)
    want = np.asarray(jax.jit(lambda v, x: jax_encode(v, jc, x)[0])(nested, jnp.asarray(images)))
    params, stats = _port(flat, tc)
    got = encode(compute_params(params, tc, stats), tc, torch.from_numpy(images)).numpy()
    assert got.shape == want.shape == (2, 4, 2048)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale


def test_training_mode_contexts_and_statistics_match_jax(world):
    """``train_cnn``: batch norms on the batch's statistics (E[x²] − E[x]²,
    biased) and the running update ``0.99·ra + 0.01·batch``.  At batch 2
    and 64 px res5's batch norms see 8 values a channel and the fast
    variance cancels in float32: JAX's own float32 contexts sit about
    7e-4 of max|ctx| from a float64 run of the same graph.  So the
    packages are held to each other with the CNN in float64 (JAX under
    ``enable_x64``): contexts (cast to float32 at the end, in both)
    within 1e-6 of max|ctx|, new statistics within 1e-9 absolute.  At float32 the port is held to be no further
    from the float64 run than JAX's float32 contexts are."""
    jc, tc, flat, nested = world
    images = _images(tc, seed=1)
    params, stats = _port(flat, tc)
    x = _preprocess(torch.from_numpy(images))
    with jax.enable_x64(True):
        j64 = jc.replace(compute_dtype="float64")
        want, mutated = jax.jit(lambda v, im: jax_encode(v, j64, im, True))(nested, jnp.asarray(images))
        want = np.asarray(want)
        want_stats = _flat(mutated["batch_stats"], "batch_stats/")
    exact, new_stats = resnet50(params["cnn"], stats, x, torch.float64, train=True)
    exact = exact.numpy()
    assert exact.dtype == np.float32 and exact.shape == (2, 4, 2048)
    scale = np.abs(want).max()
    assert np.abs(exact - want).max() <= 1e-6 * scale
    got_stats = {n: t.numpy() for n, t, _ in named_leaves(new_stats, "batch_stats/")}
    assert set(got_stats) == set(want_stats)
    for name, value in want_stats.items():
        np.testing.assert_allclose(got_stats[name], value, rtol=0, atol=1e-9, err_msg=name)

    want32 = np.asarray(jax.jit(lambda v, im: jax_encode(v, jc, im, True)[0])(nested, jnp.asarray(images)))
    got32, _ = resnet50(params["cnn"], stats, x, torch.float32, train=True)
    assert np.abs(got32.numpy() - exact).max() <= np.abs(want32 - exact).max()
    # inference mode leaves no statistics to update
    assert resnet50(params["cnn"], stats, x, torch.float32)[1] is None


def _jax_state(jc, nested):
    params = nested["params"]
    trainable, _ = jax_split_trainable(params, jc)
    return JaxTrainState(params=params, batch_stats=nested["batch_stats"],
                         opt_state=jax_make_optimizer(jc).init(trainable), step=jnp.zeros((), jnp.int32))


def test_three_train_cnn_steps_match_jax(world):
    """Three Adam steps with ``train_cnn``, each on its own batch, dropout
    off (the port's masks are its own) and the CNN in float64 (JAX under
    ``enable_x64``): in float32 the train-mode batch norms at this size
    leave JAX's own CNN gradients up to 20% from a float64 run, while in
    float64 the two packages' gradients agree within 1e-6.  Held: each
    loss term within 1e-5 of the total loss and accuracy exactly at every
    step, then every parameter and running statistic within 1e-5
    absolute, every statistic moved."""
    jc, tc, flat, nested = world
    knobs = dict(train_cnn=True, compute_dtype="float64")
    jc, tc = jc.replace(**knobs), tc.replace(**knobs)
    params, stats = _port(flat, tc)
    state = state_from_params(params, tc, batch_stats=stats)
    step = make_train_step(tc)
    with jax.enable_x64(True):
        jstate = _jax_state(jc, nested)
        jstep = jax.jit(jax_make_train_step(jc))
        for s in range(3):
            batch = make_batch(tc, B=2, seed=10 + s)
            jstate, want = jstep(jstate, batch, jax.random.PRNGKey(s))
            state, got = step(state, torch_batch(batch), step_generator(0, s, "cpu"))
            total = float(want["total_loss"])
            for k in LOSSES:
                assert abs(float(got[k]) - float(want[k])) <= 1e-5 * total, (s, k)
            assert float(got["accuracy"]) == float(want["accuracy"])
        want_flat = {**_flat(jstate.params, "params/"), **_flat(jstate.batch_stats, "batch_stats/")}
    got_flat = {k: v for k, v in state_to_flat(state).items() if not k.startswith("optimizer/")}
    del got_flat["global_step"]
    assert set(got_flat) == set(want_flat)
    for name, value in want_flat.items():
        np.testing.assert_allclose(got_flat[name], value, rtol=0, atol=1e-5, err_msg=name)
    stat_names = [k for k in flat if k.startswith("batch_stats/")]
    assert all(not np.array_equal(flat[k], got_flat[k]) for k in stat_names)


def test_frozen_cnn_keeps_its_statistics_and_eval_loss_matches_jax(world):
    """Without ``train_cnn`` a step changes neither the CNN nor its running
    statistics; the eval-loss step (running statistics, no dropout) gives
    JAX's five metrics within 1e-5 relative."""
    jc, tc, flat, nested = world
    params, stats = _port(flat, tc)
    state = state_from_params(params, tc, batch_stats=stats)
    batch = make_batch(tc, B=2, seed=3)
    want = jax_make_eval_loss_step(jc)(_jax_state(jc, nested), batch)
    got = make_eval_loss_step(tc)(state, torch_batch(batch))
    for k in LOSSES:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    before = state_to_flat(state)
    state, _ = make_train_step(tc)(state, torch_batch(batch), step_generator(0, 0, "cpu"))
    after = state_to_flat(state)
    for name in before:
        if name.startswith(("params/cnn/", "batch_stats/")):
            np.testing.assert_array_equal(after[name], before[name], err_msg=name)


def test_init_variables_follow_the_jax_distributions():
    """Conv kernels within their glorot bound, conv1's bias and every
    batch-norm bias zero, scales one, running means zero and variances
    one."""
    _, tc = configs(**RESNET)
    params, stats = init_variables(tc, torch.Generator().manual_seed(3))
    flat = {**params_to_flat(params), **{n: t.numpy() for n, t, _ in named_leaves(stats, "batch_stats/")}}
    assert {k: v.shape for k, v in flat.items()} == param_shapes(tc)
    for k, v in flat.items():
        if not k.startswith("params/cnn/"):
            continue
        if v.ndim == 4:
            limit = np.sqrt(6.0 / (v.shape[0] * v.shape[1] * (v.shape[2] + v.shape[3])))
            assert 0.8 * limit < np.abs(v).max() <= limit, k
        elif k.endswith("/scale"):
            assert (v == 1).all(), k
        else:
            assert not v.any(), k
    for k, v in flat.items():
        if k.startswith("batch_stats/"):
            assert (v == (1.0 if k.endswith("/var") else 0.0)).all(), k
    state = create_train_state(tc, torch.Generator().manual_seed(3))
    assert set(n for n, _, _ in named_leaves(state.batch_stats, "batch_stats/")) == {
        k for k in flat if k.startswith("batch_stats/")
    }


def test_checkpoints_cross_between_the_packages(world, tmp_path):
    """A ResNet50 train state saved by JAX loads in the port (parameters and
    statistics bitwise), and the port's save loads in JAX, ``batch_stats/``
    included both ways."""
    jc, tc, flat, nested = world
    jc = jc.replace(save_dir=str(tmp_path / "jax"), vocabulary_file=str(tmp_path / "none.csv"))
    tc = tc.replace(save_dir=str(tmp_path / "port"), vocabulary_file=str(tmp_path / "none.csv"))
    jstate = _jax_state(jc, nested)._replace(step=jnp.asarray(4, jnp.int32))
    path = jax_save_checkpoint(jstate, jc)
    state = create_train_state(tc, torch.Generator().manual_seed(1))
    state, count = restore_checkpoint(state, model_file=path)
    assert state.step == 4 and count > len(flat)
    got = state_to_flat(state)
    for name, value in flat.items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)

    state = state._replace(step=9)
    path = save_checkpoint(state, tc)
    fresh = _jax_state(jc, jax_variables(jc))
    restored, count = jax_restore_checkpoint(fresh, model_file=path)
    assert int(restored.step) == 9
    back = {**_flat(restored.params, "params/"), **_flat(restored.batch_stats, "batch_stats/")}
    for name, value in flat.items():
        np.testing.assert_array_equal(back[name], value, err_msg=name)
