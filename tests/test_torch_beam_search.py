"""The port's beam search held against sat_tpu.ops.beam_search.beam_search
on the same decoder weights and context grids: words and lengths
identical, scores and attention maps within float32 summation order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sat_tpu.ops.beam_search import beam_search as jax_beam_search
from sat_tpu_torch.ops.beam_search import beam_search, top_k
from tests.torch_port_helpers import configs, port_params, to_torch

torch.set_num_threads(2)

EOS = 3


def _contexts(tc, seed, B):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, tc.num_ctx, tc.dim_ctx)).astype(np.float32)


@pytest.mark.parametrize(
    "seed,K,valid_size",
    [(0, 3, None), (1, 1, None), (2, 2, 30), (3, 3, 41)],
)
def test_beam_search_matches_jax(seed, K, valid_size):
    jc, tc = configs()
    variables, params = port_params(jc, tc, seed=seed)
    contexts = _contexts(tc, seed, B=5)
    want = jax_beam_search(
        variables["params"]["decoder"], jc, jnp.asarray(contexts), EOS,
        beam_size=K, valid_size=valid_size, return_alphas=True, return_steps=True,
    )
    got = beam_search(
        params["decoder"], tc, to_torch(contexts), EOS,
        beam_size=K, valid_size=valid_size, return_alphas=True, return_steps=True,
    )
    np.testing.assert_array_equal(got.words.numpy(), np.asarray(want.words))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_allclose(got.log_scores.numpy(), np.asarray(want.log_scores), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.alphas.numpy(), np.asarray(want.alphas), rtol=0, atol=1e-5)
    assert got.steps_run == int(want.steps_run)
    if valid_size is not None:
        assert int(got.words.max()) < valid_size


@pytest.mark.parametrize("K", [1, 2, 3])
def test_early_exit_is_exact(K):
    """Stopping once every row is sealed returns exactly what all T steps
    return (the port's twin of test_beam_search.py's test)."""
    jc, tc = configs()
    _, params = port_params(jc, tc)
    for seed in range(3):
        contexts = to_torch(_contexts(tc, seed, B=4))
        full = beam_search(params["decoder"], tc, contexts, EOS, beam_size=K,
                           early_exit=False, return_alphas=True, return_steps=True)
        fast = beam_search(params["decoder"], tc, contexts, EOS, beam_size=K,
                           early_exit=True, return_alphas=True, return_steps=True)
        for a, b in zip(fast[:4], full[:4]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert full.steps_run == tc.max_caption_length and fast.steps_run <= full.steps_run


def test_early_exit_actually_exits():
    """With eos made certain, every beam finishes at once and the search
    stops after one step."""
    jc, tc = configs()
    _, params = port_params(jc, tc)
    dec = dict(params["decoder"])
    fc = "fc_2" if "fc_2" in dec["decode"] else "fc"
    bias = dec["decode"][fc]["bias"].clone()
    bias[EOS] = 50.0
    bias[EOS + 1:EOS + 4] = 49.0  # K-1 other strong words keep eos in the top-(K+1)
    dec["decode"] = {**dec["decode"], fc: {**dec["decode"][fc], "bias": bias}}
    res = beam_search(dec, tc, to_torch(_contexts(tc, 0, B=2)), EOS, return_steps=True)
    assert res.steps_run < tc.max_caption_length
    assert (res.words[:, :, 0] != 0).all()


def test_top_k_breaks_ties_like_jax():
    rng = np.random.default_rng(0)
    for _ in range(20):
        n = int(rng.integers(2, 40))
        x = rng.choice(
            np.array([-1e30, -3.5, -0.0, 0.0, 1.25, 7.0, np.inf, -np.inf], np.float32),
            size=(6, n),
        )
        for k in (1, min(3, n), n):
            want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
            got_v, got_i = top_k(torch.from_numpy(x), k)
            np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
            np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("B", [1, 4])
def test_tile_beams_gives_contiguous_rows(B):
    """The CUDA kernel takes contiguous rows only; at B=1 a reshape of the
    expanded tensor would be a stride-0 view."""
    from sat_tpu_torch.ops.beam_search import tile_beams

    x = torch.arange(B * 6.0).reshape(B, 2, 3)
    tiled = tile_beams(x, 3)
    assert tiled.is_contiguous() and tuple(tiled.shape) == (B * 3, 2, 3)
    torch.testing.assert_close(tiled, x.repeat_interleave(3, dim=0), rtol=0, atol=0)
