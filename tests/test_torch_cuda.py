"""sat_tpu_torch on the card: the CUDA ``fused_attend`` against its plain
version, and the serving path on the card against the CPU.  Marked
``cuda``; each test skips without a card.  Run on a GPU machine with
``python -m pytest -m cuda tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from sat_tpu_torch.ops import fused_attend as fa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU or interpret mode)")
    return torch.device("cuda")


def _inputs(B, N, da, D, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (
        torch.tanh(torch.randn((B, N, da), generator=g, device="cuda")),
        torch.tanh(torch.randn((B, da), generator=g, device="cuda")),
        (torch.rand((da, 1), generator=g, device="cuda") - 0.5) * 0.16,
        torch.relu(torch.randn((B, N, D), generator=g, device="cuda")),
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,N,da,D",
    [(96, 196, 512, 512), (5, 7, 24, 40), (1, 1, 4, 4), (3, 13, 13, 7), (2, 12000, 8, 300), (4, 49, 512, 2048)],
)
def test_kernel_matches_plain_version(cuda, dtype, B, N, da, D):
    args = _inputs(B, N, da, D)
    before = fa.fused_attend.launches
    got = fa.fused_attend(*args, compute_dtype=dtype)
    want = fa.fused_attend_reference(*args, compute_dtype=dtype)
    torch.cuda.synchronize()
    assert fa.fused_attend.launches == before + 1
    # the same rounding points, another summation order: fa.agreement's rule
    rep = fa.agreement(got, want, args[3], fa.reference_logits(*args[:3], dtype), dtype)
    assert rep["ok"], rep


def test_kernel_without_bf16_rounding_fails_the_bf16_rule(cuda):
    """Control: the kernel in float32 mode, held against the bf16 plain
    version, must not pass — else the bf16 rule could not catch a kernel
    that rounds in the wrong place."""
    args = _inputs(96, 196, 512, 512)
    want = fa.fused_attend_reference(*args, compute_dtype="bfloat16")
    got = fa.fused_attend(*args, compute_dtype="float32")
    rep = fa.agreement(got, want, args[3], fa.reference_logits(*args[:3], "bfloat16"), "bfloat16")
    assert not rep["ok"], rep


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    t1, t2, w2, ctx = _inputs(3, 5, 8, 8)
    with pytest.raises(NotImplementedError, match="slot-pool slice"):
        fa.fused_attend(t1, t2, w2, ctx, row_mask=torch.ones(3, dtype=torch.bool, device=cuda))
    with pytest.raises(TypeError, match="float32"):
        fa.fused_attend(t1.half(), t2, w2, ctx)
    with pytest.raises(ValueError, match="contiguous"):
        fa.fused_attend(t1.transpose(1, 2).contiguous().transpose(1, 2), t2, w2, ctx)
    with pytest.raises(ValueError, match="do not agree"):
        fa.fused_attend(t1, t2[:2], w2, ctx)
    for dtype in ("int8", "float16"):
        with pytest.raises(ValueError, match="compute_dtype"):
            fa.fused_attend(t1, t2, w2, ctx, compute_dtype=dtype)


def test_serving_path_on_the_card_matches_the_cpu(cuda, tmp_path):
    """Small float32 model: the card (CUDA kernel) and the CPU (plain
    versions) give the same words, with the process's TF32 switches left
    as they are (encode turns cuDNN's off itself at float32)."""
    from sat_tpu_torch.config import Config
    from sat_tpu_torch.data.vocabulary import Vocabulary
    from sat_tpu_torch.serve.engine import ServeEngine, ServingState
    from sat_tpu_torch.train.checkpoint import param_shapes, params_from_flat

    config = Config(
        image_size=32, dim_embedding=16, num_lstm_units=16, dim_initialize_layer=16,
        dim_attend_layer=16, dim_decode_layer=32, vocabulary_size=50,
        compute_dtype="float32", serve_buckets=(4,), serve_max_batch=4,
    )
    rng = np.random.default_rng(0)
    flat = {k: rng.uniform(-0.08, 0.08, s).astype(np.float32) for k, s in param_shapes(config).items()}
    vocab = Vocabulary(50)
    vocab.build([f"w{i} ." for i in range(60)])
    images = rng.integers(0, 256, size=(4, 32, 32, 3), dtype=np.uint8)
    out = {}
    for dev in ("cuda", "cpu"):
        state = ServingState(params_from_flat(flat, config, dev), step=0)
        engine = ServeEngine(config, state, vocab, device=dev)
        out[dev] = engine.drain_output(engine.dispatch(images), 4)
    np.testing.assert_array_equal(out["cuda"][0], out["cpu"][0])
    np.testing.assert_allclose(out["cuda"][2], out["cpu"][2], rtol=0, atol=1e-4)
