"""The port's attention step held against sat_tpu's: the plain version of
``fused_attend`` against the Pallas kernel (run in interpret mode, as
tests/test_pallas.py runs it), and ``attend_with_precomputed`` with 1 and
2 layers against the JAX decoder."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sat_tpu.models import decoder as jax_decoder
from sat_tpu.ops import pallas_attention
from sat_tpu_torch.models import decoder
from sat_tpu_torch.ops.fused_attend import (
    agreement,
    fused_attend,
    fused_attend_reference,
    reference_logits,
)
from tests.torch_port_helpers import configs, port_params, to_torch

torch.set_num_threads(2)


def _inputs(rng, B, N, da, D):
    return [
        rng.normal(size=shape).astype(np.float32)
        for shape in ((B, N, da), (B, da), (da, 1), (B, N, D))
    ]


# fp32: the tolerances of test_pallas.py's kernel-vs-oracle case (only the
# summation order differs).  bf16: both sides round at the same points, so
# only order differs here too, but a sum that lands near a bf16 rounding
# boundary can round one ulp apart: held by fused_attend.agreement's rule.
TOLERANCES = {
    "float32": dict(alpha=dict(rtol=1e-6, atol=1e-6), ctx=dict(rtol=1e-5, atol=1e-5)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,N,da,D", [(3, 17, 16, 24), (5, 7, 24, 40), (1, 21, 8, 12)])
def test_plain_version_matches_the_pallas_kernel(dtype, B, N, da, D):
    rng = np.random.default_rng(B * 100 + N)
    t1, t2, w2, ctx = _inputs(rng, B, N, da, D)
    want_ctx, want_alpha = pallas_attention.fused_attend(
        jnp.asarray(t1), jnp.asarray(t2), jnp.asarray(w2), jnp.asarray(ctx),
        compute_dtype=dtype, interpret=True,
    )
    got_ctx, got_alpha = fused_attend_reference(
        *map(torch.from_numpy, (t1, t2, w2, ctx)), compute_dtype=dtype
    )
    if dtype == "float32":
        tol = TOLERANCES[dtype]
        np.testing.assert_allclose(got_alpha.numpy(), np.asarray(want_alpha), **tol["alpha"])
        np.testing.assert_allclose(got_ctx.numpy(), np.asarray(want_ctx), **tol["ctx"])
    else:
        args = [torch.from_numpy(x) for x in (t1, t2, w2, ctx)]
        rep = agreement(
            (got_ctx, got_alpha), (torch.from_numpy(np.array(want_ctx)),
                                   torch.from_numpy(np.array(want_alpha))),
            args[3], reference_logits(*args[:3], dtype), dtype,
        )
        assert rep["ok"], rep
    # on a CPU tensor the wrapper is the plain version, and launches nothing
    before = fused_attend.launches
    wrapped = fused_attend(*map(torch.from_numpy, (t1, t2, w2, ctx)), compute_dtype=dtype)
    assert fused_attend.launches == before
    torch.testing.assert_close(wrapped[0], got_ctx, rtol=0, atol=0)


def test_bf16_agreement_rule_tells_rounding_from_summation_order():
    """``agreement`` at bf16 passes the same rounding summed in another
    order, and fails the rounding left out (at any of its three places)
    or a ctx that is not alpha @ contexts."""
    g = torch.Generator().manual_seed(0)
    B, N, da, D = 16, 49, 128, 64
    t1 = torch.tanh(torch.randn((B, N, da), generator=g))
    t2 = torch.tanh(torch.randn((B, da), generator=g))
    w2 = (torch.rand((da, 1), generator=g) - 0.5) * 0.16
    ctx = torch.relu(torch.randn((B, N, D), generator=g))
    want = fused_attend_reference(t1, t2, w2, ctx, compute_dtype="bfloat16")
    logits = reference_logits(t1, t2, w2, "bfloat16")

    def from_logits(lg):
        alpha = torch.softmax(lg, dim=-1)
        return torch.bmm(alpha.unsqueeze(1), ctx).squeeze(1), alpha

    bf = lambda x: x.to(torch.bfloat16).float()  # noqa: E731
    temp, w = t1 + t2.unsqueeze(1), w2.reshape(-1)
    reordered = (bf(temp) * bf(w)).flip(-1).reshape(B, N, 4, -1).sum(-1).sum(-1)
    assert agreement(from_logits(bf(reordered)), want, ctx, logits, "bfloat16")["ok"]
    for wrong in (
        (temp * w).sum(-1),               # no rounding at all
        (bf(temp) * bf(w)).sum(-1),       # the logit not rounded
        bf((bf(temp) * w).sum(-1)),       # w2 not rounded
    ):
        assert not agreement(from_logits(wrong), want, ctx, logits, "bfloat16")["ok"]
    off = (want[0] * 1.001, want[1])
    assert not agreement(off, want, ctx, logits, "bfloat16")["ok"]


def test_masked_plain_version_matches_the_masked_kernel():
    """Dead rows hold NaN/Inf garbage: they come out zero, and live rows
    match the masked Pallas body."""
    rng = np.random.default_rng(7)
    B, N, da, D = 5, 13, 16, 24
    t1, t2, w2, ctx = _inputs(rng, B, N, da, D)
    mask = np.array([True, False, True, False, True])
    t1[1] = np.nan
    t2[3] = np.inf
    ctx[1] = np.nan
    want_ctx, want_alpha = pallas_attention.fused_attend(
        *map(jnp.asarray, (t1, t2, w2, ctx)), row_mask=jnp.asarray(mask), interpret=True
    )
    got_ctx, got_alpha = fused_attend_reference(
        *map(torch.from_numpy, (t1, t2, w2, ctx)), row_mask=torch.from_numpy(mask)
    )
    assert np.isfinite(got_ctx.numpy()).all() and np.isfinite(got_alpha.numpy()).all()
    assert (got_alpha.numpy()[~mask] == 0).all() and (got_ctx.numpy()[~mask] == 0).all()
    tol = TOLERANCES["float32"]
    np.testing.assert_allclose(got_alpha.numpy(), np.asarray(want_alpha), **tol["alpha"])
    np.testing.assert_allclose(got_ctx.numpy(), np.asarray(want_ctx), **tol["ctx"])


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("fused", [True, False])
def test_attend_with_precomputed_matches_jax(layers, fused, monkeypatch):
    """2 layers and fused: the JAX side runs the Pallas kernel (interpret
    mode) and the port its plain version; unfused, both run plain ops."""
    jc, tc = configs(num_attend_layers=layers, use_pallas_attention=fused)
    variables, params = port_params(jc, tc)
    monkeypatch.setattr(pallas_attention, "FORCE_INTERPRET", fused)
    rng = np.random.default_rng(layers)
    B = 3
    contexts = rng.normal(size=(B, tc.num_ctx, tc.dim_ctx)).astype(np.float32)
    output = rng.normal(size=(B, tc.num_lstm_units)).astype(np.float32)
    jp = variables["params"]["decoder"]
    jproj = jax_decoder.precompute_attend(jp, jc, jnp.asarray(contexts))
    want_ctx, want_alpha = jax_decoder.attend_with_precomputed(
        jp, jc, jnp.asarray(contexts), jproj, jnp.asarray(output)
    )
    pp = params["decoder"]
    proj = decoder.precompute_attend(pp, tc, to_torch(contexts))
    np.testing.assert_allclose(proj.numpy(), np.asarray(jproj), rtol=1e-5, atol=1e-6)
    got_ctx, got_alpha = decoder.attend_with_precomputed(
        pp, tc, to_torch(contexts), proj, to_torch(output)
    )
    np.testing.assert_allclose(got_alpha.numpy(), np.asarray(want_alpha), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_ctx.numpy(), np.asarray(want_ctx), rtol=1e-5, atol=1e-5)
