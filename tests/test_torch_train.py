"""The port's training loss and step held against sat_tpu's on the same
weights (sat_tpu's init_variables through the bridge) and the same numpy
batch, at float32 with dropout off unless a case says otherwise; and the
port's dropout, which cannot draw JAX's bits, held to its own contract."""

import jax
import numpy as np
import pytest
import torch

from sat_tpu.models.captioner import compute_loss as jax_compute_loss
from sat_tpu.train.checkpoint import flatten_with_names
from sat_tpu.train.step import TrainState as JaxTrainState
from sat_tpu.train.step import make_eval_loss_step as jax_make_eval_loss_step
from sat_tpu.train.step import split_trainable as jax_split_trainable
from sat_tpu_torch.models import decoder
from sat_tpu_torch.models.captioner import compute_loss, init_params
from sat_tpu_torch.nn.layers import dropout, regularization_loss
from sat_tpu_torch.train.checkpoint import named_leaves, param_shapes, params_to_flat
from sat_tpu_torch.train.step import (
    create_train_state, make_eval_loss_step, make_train_step, split_trainable, state_from_params,
    step_generator,
)
from tests.torch_port_helpers import configs, port_params

torch.set_num_threads(2)

NO_DROPOUT = dict(fc_drop_rate=0.0, lstm_drop_rate=0.0)
LOSSES = ("total_loss", "cross_entropy_loss", "attention_loss", "reg_loss", "accuracy")


def make_batch(tc, B=4, seed=0, contexts=False):
    """word_idxs in [1, V) with rows of 3..T words, masks to match, and
    uint8 images (or, with ``contexts``, a post-relu context grid)."""
    rng = np.random.default_rng(seed)
    T, V = tc.max_caption_length, tc.vocabulary_size
    lengths = rng.integers(3, T + 1, size=B)
    masks = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    words = (rng.integers(1, V, size=(B, T)) * masks).astype(np.int32)
    batch = {"word_idxs": words, "masks": masks}
    if contexts:
        batch["contexts"] = np.maximum(rng.normal(size=(B, tc.num_ctx, tc.dim_ctx)), 0).astype(np.float32)
    else:
        batch["images"] = rng.integers(0, 256, size=(B, tc.image_size, tc.image_size, 3), dtype=np.uint8)
    return batch


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def jax_loss_and_grads(jc, variables, batch, train=True):
    trainable, frozen = jax_split_trainable(variables["params"], jc)

    def loss_fn(tp):
        total, aux = jax_compute_loss({"params": {**frozen, **tp}}, jc, batch, jax.random.PRNGKey(1), train)
        return total, aux["metrics"]

    (_, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(trainable)
    return {k: float(v) for k, v in metrics.items()}, {
        k: np.asarray(v) for k, v in flatten_with_names(grads, "params/").items()
    }


def port_loss_and_grads(tc, params, batch):
    trainable, _ = split_trainable(params, tc)
    for _, leaf, _ in named_leaves(trainable, ""):
        leaf.requires_grad_(True)
    total, aux = compute_loss(params, tc, torch_batch(batch), torch.Generator().manual_seed(0))
    named = list(named_leaves(trainable, "params/"))
    grads = torch.autograd.grad(total, [leaf for _, leaf, _ in named])
    return {k: float(v.detach()) for k, v in aux["metrics"].items()}, {
        name: (g.permute(2, 3, 1, 0) if conv else g).numpy() for (name, _, conv), g in zip(named, grads)
    }


CASES = {
    "two_layers": dict(),
    "one_layer": dict(num_initialize_layers=1, num_attend_layers=1, num_decode_layers=1),
    "activity": dict(fc_activity_regularizer_scale=1e-3),
    "ce_bfloat16": dict(ce_dtype="bfloat16"),
    "train_cnn": dict(train_cnn=True, conv_activity_regularizer_scale=1e-7),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_compute_loss_and_gradients_match_jax(case):
    """The five loss terms within 1e-5 relative (accuracy exactly), and the
    gradient of every trainable leaf within 1e-5 of that leaf's largest
    gradient (train_cnn: 1e-4, through 13 float32 convs summed in another
    order).  That scale is floored at 1e-3 of the largest gradient of any
    leaf (so at 1e-8 of it, float32 rounding): without dropout ``fc_1b``'s gradient is zero up to rounding
    (t2 shifts every position's logit alike, and the softmax ignores a
    shift), so its largest value is noise.  The CNN-free cases feed a
    context grid; the train_cnn and two-layer cases run the CNN from
    images."""
    jc, tc = configs(**NO_DROPOUT, **CASES[case])
    variables, params = port_params(jc, tc)
    batch = make_batch(tc, contexts=case not in ("two_layers", "train_cnn"))
    want, want_grads = jax_loss_and_grads(jc, variables, batch)
    got, got_grads = port_loss_and_grads(tc, params, batch)
    for k in LOSSES:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert got["accuracy"] == want["accuracy"]
    if case == "activity":
        assert got["reg_loss"] > want["reg_loss"] - 1e-6 > 0
    assert sorted(got_grads) == sorted(want_grads)
    rtol = 1e-4 if case == "train_cnn" else 1e-5
    floor = 1e-3 * max(np.abs(g).max() for g in want_grads.values())
    for name, g in want_grads.items():
        scale = max(np.abs(g).max(), floor)
        np.testing.assert_allclose(got_grads[name], g, rtol=0, atol=rtol * scale, err_msg=name)
    if case == "train_cnn":
        assert any(name.startswith("params/cnn/") for name in got_grads)


def test_eval_loss_step_matches_jax():
    """``make_eval_loss_step``: no dropout, no fc L2, the inference decode;
    the five metrics within 1e-5 relative of JAX's on the CPU."""
    jc, tc = configs(**NO_DROPOUT)
    variables, params = port_params(jc, tc)
    batch = make_batch(tc, seed=3)
    jstate = JaxTrainState(params=variables["params"], batch_stats={}, opt_state=(), step=0)
    want = {k: float(v) for k, v in jax_make_eval_loss_step(jc)(jstate, batch).items()}
    got = make_eval_loss_step(tc)(state_from_params(params, tc), torch_batch(batch))
    assert not any(v.requires_grad for v in got.values())
    for k in LOSSES:
        np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-5, err_msg=k)


def test_regularization_loss_counts_kernels_only():
    """fc kernels and the embedding always, conv kernels only with
    train_cnn, never the LSTM or a bias."""
    _, tc = configs()
    params = init_params(tc, torch.Generator().manual_seed(0))
    flat = params_to_flat(params)

    def l2(pred):
        return 0.5 * sum(float((v.astype(np.float64) ** 2).sum()) for k, v in flat.items() if pred(k, v))

    fc = l2(lambda k, v: v.ndim == 2 and "lstm" not in k)
    conv = l2(lambda k, v: v.ndim == 4)
    got = float(regularization_loss(params, fc_scale=2.0, conv_scale=3.0, train_cnn=False))
    np.testing.assert_allclose(got, 2.0 * fc, rtol=1e-5)
    got = float(regularization_loss(params, fc_scale=2.0, conv_scale=3.0, train_cnn=True))
    np.testing.assert_allclose(got, 2.0 * fc + 3.0 * conv, rtol=1e-5)
    assert float(regularization_loss(params, 0.0, 0.0, True)) == 0.0


def test_init_params_follows_the_jax_distributions():
    """Every parameter of the config, biases zero, fc kernels within
    ±fc_kernel_initializer_scale, conv kernels within the glorot bound;
    the same generator seed gives the same weights."""
    _, tc = configs()
    flat = params_to_flat(init_params(tc, torch.Generator().manual_seed(5)))
    assert {k: v.shape for k, v in flat.items()} == param_shapes(tc)
    for k, v in flat.items():
        if k.endswith("bias"):
            assert not v.any(), k
        elif v.ndim == 4:
            limit = np.sqrt(6.0 / (9 * v.shape[2] + 9 * v.shape[3]))
            assert np.abs(v).max() <= limit and np.abs(v).max() > 0.8 * limit, k
        else:
            assert np.abs(v).max() <= tc.fc_kernel_initializer_scale, k
    again = params_to_flat(init_params(tc, torch.Generator().manual_seed(5)))
    assert all(np.array_equal(flat[k], again[k]) for k in flat)


def test_dropout_keeps_one_minus_rate_scaled_by_one_over_keep():
    """Over 200k draws the kept share is 1 − rate within 0.005 (more than
    6 standard deviations), kept entries are x / keep, dropped ones 0."""
    x = torch.full((200_000,), 3.0)
    for rate in (0.3, 0.5):
        y = dropout(x, rate, torch.Generator().manual_seed(1))
        kept = y != 0
        assert abs(kept.float().mean().item() - (1 - rate)) < 0.005
        torch.testing.assert_close(y[kept], torch.full_like(y[kept], 3.0 / (1 - rate)), rtol=0, atol=0)
    assert dropout(x, 0.0, torch.Generator()) is x


def _train_loss(tc, params, batch, seed):
    total, _ = compute_loss(params, tc, torch_batch(batch), torch.Generator().manual_seed(seed))
    return float(total)


def test_dropout_masks_replay_from_the_generator_and_differ_across_steps():
    """Equal generator seeds give equal losses; other seeds (other steps'
    generators) give other losses; ``step_generator`` is a function of
    (seed, step)."""
    jc, tc = configs()
    _, params = port_params(jc, tc)
    batch = make_batch(tc, contexts=True)
    a, b, c = (_train_loss(tc, params, batch, s) for s in (7, 7, 8))
    assert a == b and a != c
    draws = [torch.rand(4, generator=step_generator(0, s, "cpu")) for s in (3, 3, 4)]
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])
    assert not torch.equal(draws[0], torch.rand(4, generator=step_generator(1, 3, "cpu")))


def test_the_five_step_sites_draw_independent_masks(monkeypatch):
    """One train step draws attend's three masks (contexts, output, t1+t2),
    the DropoutWrapper's three (LSTM input, emitted h, recurrent h) and the
    decoder's two, in that order, each a fresh mask: the emitted and
    recurrent h, the same tensor, are dropped differently."""
    _, tc = configs()
    params = init_params(tc, torch.Generator().manual_seed(0))
    seen = []
    real = decoder.dropout

    def spy(x, rate, generator):
        y = real(x, rate, generator)
        seen.append((tuple(x.shape), rate, x, y))
        return y

    monkeypatch.setattr(decoder, "dropout", spy)
    B, N, D, H = 3, tc.num_ctx, tc.dim_ctx, tc.num_lstm_units
    contexts = torch.rand(B, N, D)
    state = decoder.DecoderState(*(torch.rand(B, H) for _ in range(3)))
    decoder.train_decoder_step(
        params["decoder"], tc, contexts, state, torch.tensor([1, 2, 3]), torch.Generator().manual_seed(0)
    )
    shapes = [s for s, _, _, _ in seen]
    E, da = tc.dim_embedding, tc.dim_attend_layer
    assert shapes == [(B, N, D), (B, H), (B, N, da), (B, D + E), (B, H), (B, H), (B, H + D + E),
                      (B, tc.dim_decode_layer)]
    rates = [r for _, r, _, _ in seen]
    assert rates == [tc.fc_drop_rate] * 3 + [tc.lstm_drop_rate] * 3 + [tc.fc_drop_rate] * 2
    (_, _, h, emitted), (_, _, h2, recurrent) = seen[4], seen[5]
    assert h is h2
    assert not torch.equal(emitted == 0, recurrent == 0)
    masks = [(y == 0) for _, _, _, y in seen[:2]]
    assert masks[0].float().mean() > 0 and masks[1].float().mean() > 0


def test_train_step_updates_trainable_leaves_only():
    """A frozen CNN stays bitwise; every decoder leaf moves; metrics carry
    JAX's names."""
    jc, tc = configs()
    state = create_train_state(tc, torch.Generator().manual_seed(0))
    before = {k: v.copy() for k, v in params_to_flat(state.params).items()}
    state, metrics = make_train_step(tc)(state, torch_batch(make_batch(tc)), step_generator(0, 0, "cpu"))
    after = params_to_flat(state.params)
    assert state.step == 1
    assert set(metrics) == {*LOSSES, "grad_norm", "attention/mean", "attention/std", "attention/max"}
    for k in before:
        moved = not np.array_equal(before[k], after[k])
        assert moved == k.startswith("params/decoder/"), k
