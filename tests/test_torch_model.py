"""The port's encoder and decoder functions held against sat_tpu's on the
same weights (sat_tpu's init_variables through the bridge) and the same
numpy inputs, at float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sat_tpu.models import decoder as jax_decoder
from sat_tpu.models.captioner import encode as jax_encode
from sat_tpu_torch.models import decoder
from sat_tpu_torch.models.captioner import encode
from sat_tpu_torch.nn.layers import max_pool2d, same_padding
from tests.torch_port_helpers import configs, port_params, to_torch

torch.set_num_threads(2)


@pytest.mark.parametrize("image_size", [32, 40])
def test_vgg16_encode_matches_jax(image_size):
    """uint8 NHWC in, [B, N, 512] out; 40 px gives odd maps (5 → 3) where
    SAME pooling pads asymmetrically.  rtol 1e-4: 13 float32 convs summed
    in another order by oneDNN than by XLA drift by a few ulps a layer."""
    jc, tc = configs(image_size=image_size)
    variables, params = port_params(jc, tc)
    images = np.random.default_rng(image_size).integers(
        0, 256, size=(3, image_size, image_size, 3), dtype=np.uint8
    )
    want = np.asarray(jax.jit(lambda v, x: jax_encode(v, jc, x)[0])(variables, images))
    got = encode(params, tc, torch.from_numpy(images))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, tc.num_ctx, 512)
    assert want.shape == tuple(got.shape)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * scale)


def test_same_padding_matches_xla():
    assert same_padding((5, 4), (2, 2), (2, 2)) == ((0, 1), (0, 0))
    assert same_padding((7, 7), (3, 3), (1, 1)) == ((1, 1), (1, 1))
    assert same_padding((6, 6), (3, 3), (2, 2)) == ((0, 1), (0, 1))
    x = -torch.arange(25.0).reshape(1, 1, 5, 5)  # all ≤ 0: a 0-pad would win the max
    want = jax.lax.reduce_window(
        jnp.asarray(x.numpy()), -jnp.inf, jax.lax.max, (1, 1, 2, 2), (1, 1, 2, 2), "SAME"
    )
    np.testing.assert_array_equal(max_pool2d(x).numpy(), np.asarray(want))


@pytest.mark.parametrize("layers", [1, 2])
def test_decoder_functions_match_jax(layers):
    """init_state, lstm_step, decode_logits and decoder_step (hoisted and
    not) with 1- and 2-layer MLPs; atol 1e-5 (summation order only)."""
    jc, tc = configs(
        num_initialize_layers=layers, num_attend_layers=layers, num_decode_layers=layers
    )
    variables, params = port_params(jc, tc)
    jp, pp = variables["params"]["decoder"], params["decoder"]
    rng = np.random.default_rng(layers)
    B, H = 4, tc.num_lstm_units
    contexts = rng.normal(size=(B, tc.num_ctx, tc.dim_ctx)).astype(np.float32)
    words = rng.integers(0, tc.vocabulary_size, size=(B,))
    close = dict(rtol=1e-5, atol=1e-5)

    jstate = jax_decoder.init_state(jp, jc, jnp.asarray(contexts))
    state = decoder.init_state(pp, tc, to_torch(contexts))
    for a, b in zip(state, jstate):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **close)

    x = rng.normal(size=(B, tc.dim_ctx + tc.dim_embedding)).astype(np.float32)
    c0, h0 = (rng.normal(size=(B, H)).astype(np.float32) for _ in range(2))
    jc1, jh1 = jax_decoder.lstm_step(jp["lstm"], c0, h0, x, dtype=jnp.float32)
    c1, h1 = decoder.lstm_step(pp["lstm"], *map(to_torch, (c0, h0, x)), dtype=torch.float32)
    np.testing.assert_allclose(c1.numpy(), np.asarray(jc1), **close)
    np.testing.assert_allclose(h1.numpy(), np.asarray(jh1), **close)

    expanded = rng.normal(size=(B, H + tc.dim_ctx + tc.dim_embedding)).astype(np.float32)
    np.testing.assert_allclose(
        decoder.decode_logits(pp, tc, to_torch(expanded)).numpy(),
        np.asarray(jax_decoder.decode_logits(jp, jc, jnp.asarray(expanded))),
        **close,
    )

    jproj = jax_decoder.precompute_attend(jp, jc, jnp.asarray(contexts))
    want = jax_decoder.decoder_step(
        jp, jc, jnp.asarray(contexts), jstate, jnp.asarray(words), ctx_proj=jproj
    )
    for proj in (decoder.precompute_attend(pp, tc, to_torch(contexts)), None):
        got = decoder.decoder_step(pp, tc, to_torch(contexts), state, to_torch(words), ctx_proj=proj)
        for a, b in zip(got[0], want[0]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **close)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **close)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), **close)


def test_bf16_dense_rounds_like_jax():
    """_dense at bfloat16: inputs and kernel rounded, bias added in bf16,
    then float32 — the JAX function's rounding points."""
    rng = np.random.default_rng(3)
    p = {"kernel": rng.normal(size=(8, 5)).astype(np.float32),
         "bias": rng.normal(size=(5,)).astype(np.float32)}
    x = rng.normal(size=(3, 8)).astype(np.float32)
    want = jax_decoder._dense(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), dtype=jnp.bfloat16
    )
    got = decoder._dense({k: to_torch(v) for k, v in p.items()}, to_torch(x), dtype=torch.bfloat16)
    # one bf16 ulp: the products' summation order may differ before rounding
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=8e-3, atol=8e-3)
