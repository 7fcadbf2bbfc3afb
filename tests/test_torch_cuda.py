"""sat_tpu_torch on the card: the CUDA ``fused_attend`` (unmasked and
masked bodies) against its plain version, at VGG16's and ResNet50's
grids, the serving path (batch and continuous, both CNNs), the bulk path
and the train and eval-loss steps on the card against the CPU, the
quantized encoder's int8 conv, and the kernel's refusal to be
differentiated.  Marked
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
    [(96, 196, 512, 512), (5, 7, 24, 40), (1, 1, 4, 4), (3, 13, 13, 7), (2, 12000, 8, 300), (4, 49, 512, 2048),
     (2, 5, 22, 38), (60, 196, 512, 512), (20, 196, 512, 512),
     # ResNet50's grid: 7 positions a block, the cluster's eighth block owns none
     (96, 49, 512, 2048), (60, 49, 512, 2048), (48, 49, 512, 2048), (3, 49, 512, 2048)],
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


def _poison_dead_rows(args, mask):
    """NaN in dead rows' t1 and contexts, ±Inf in their t2."""
    t1, t2, w2, ctx = (x.clone() for x in args)
    dead = ~mask
    t1[dead] = float("nan")
    t2[dead] = float("inf")
    t2[dead, ::2] = float("-inf")
    ctx[dead] = float("nan")
    return t1, t2, w2, ctx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pattern", ["all", "one", "alternate"])
@pytest.mark.parametrize("B,N,da,D", [(48, 196, 512, 512), (5, 7, 24, 40), (3, 196, 512, 512), (2, 5, 22, 38),
                                      (48, 49, 512, 2048)])
def test_masked_kernel_matches_plain_version_and_unmasked_kernel(cuda, B, N, da, D, pattern, dtype):
    """Dead rows come out +0.0 whatever their inputs; live rows are
    bitwise the unmasked kernel's on the same inputs and agree with the
    masked plain version."""
    mask = {
        "all": torch.ones(B, dtype=torch.bool),
        "one": torch.arange(B) == B // 2,
        "alternate": torch.arange(B) % 2 == 0,
    }[pattern].to(cuda)
    args = _poison_dead_rows(_inputs(B, N, da, D, seed=B), mask)
    before = (fa.fused_attend.launches, fa.fused_attend.masked_launches)
    got = fa.fused_attend(*args, row_mask=mask, compute_dtype=dtype)
    plain_b1 = fa.fused_attend(*args, compute_dtype=dtype)
    want = fa.fused_attend_reference(*args, row_mask=mask, compute_dtype=dtype)
    torch.cuda.synchronize()
    assert (fa.fused_attend.launches, fa.fused_attend.masked_launches) == (before[0] + 1, before[1] + 1)
    for g in got:
        dead = g[~mask]
        assert (dead.view(torch.int32) == 0).all()  # +0.0, bit for bit
    for g, u in zip(got, plain_b1):
        assert torch.equal(g[mask], u[mask])
    t1, t2, w2, ctx = args
    rep = fa.agreement(
        tuple(x[mask] for x in got), tuple(x[mask] for x in want), ctx[mask],
        fa.reference_logits(t1[mask], t2[mask], w2, dtype), dtype,
    )
    assert rep["ok"], rep


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,da,D", [(196, 512, 512), (5, 22, 38), (49, 512, 2048)])
def test_row_outputs_do_not_depend_on_the_batch(cuda, N, da, D, dtype):
    """One row placed at several indices of batches of 1 to 108 rows,
    beside other rows, with and without a mask (the row live, others
    dead at random): bitwise the same ctx and alpha every time."""
    row = _inputs(1, N, da, D, seed=1)
    want = fa.fused_attend(*row, compute_dtype=dtype)
    g = torch.Generator().manual_seed(2)
    for B in (1, 3, 48, 96, 108):
        others = _inputs(B, N, da, D, seed=B + 3)
        for i in sorted({0, B // 2, B - 1}):
            t1, t2, _, ctx = (x.clone() for x in others)
            t1[i], t2[i], ctx[i] = row[0][0], row[1][0], row[3][0]
            args = (t1, t2, row[2], ctx)
            mask = (torch.rand(B, generator=g) < 0.5).to(cuda)
            mask[i] = True
            for got in (fa.fused_attend(*args, compute_dtype=dtype),
                        fa.fused_attend(*args, row_mask=mask, compute_dtype=dtype)):
                for x, y in zip(got, want):
                    assert torch.equal(x[i], y[0]), (B, i)


def test_launch_refuses_a_plan_it_cannot_run(cuda):
    """The C entry checks the plan before launching anything: it must
    cover N and D, its chunks must fit their stage, its cluster must be
    portable and its layout must fit in shared memory."""
    from sat_tpu_torch.ops import build

    lib = build.load("fused_attend")
    args = _inputs(3, 196, 512, 512)
    out = (torch.empty(3, 512, device=cuda), torch.empty(3, 196, device=cuda))
    plan = fa.attend_plan(196, 512, 512)
    fa._launch(lib, *args, None, *out, 0)  # binds the argument types
    fn = lib.fused_attend_launch
    ptrs = [x.data_ptr() for x in args] + [None] + [x.data_ptr() for x in out]
    stream = torch.cuda.current_stream().cuda_stream
    for bad in (plan._replace(rows_per_block=plan.rows_per_block - 1),
                plan._replace(cols_per_block=plan.cols_per_block - 4),
                plan._replace(stage_floats=plan.stage_floats - 4),
                plan._replace(stage_floats=60000, t1_chunk_rows=1),
                plan._replace(cluster=16)):
        assert fn(*ptrs, 3, 196, 512, 512, 0, stream, *bad[:6]) != 0, bad
    assert fn(*ptrs, 3, 196, 512, 512, 0, stream, *plan[:6]) == 0
    torch.cuda.synchronize()


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    t1, t2, w2, ctx = _inputs(3, 5, 8, 8)
    for bad, err in (
        (torch.ones(3, dtype=torch.int32, device=cuda), TypeError),
        (torch.ones(4, dtype=torch.bool, device=cuda), ValueError),
        (torch.ones(3, dtype=torch.bool), ValueError),
        (torch.ones(6, dtype=torch.bool, device=cuda)[::2], ValueError),
    ):
        with pytest.raises(err, match="row_mask"):
            fa.fused_attend(t1, t2, w2, ctx, row_mask=bad)
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


def test_stepped_decode_on_the_card_matches_the_cpu(cuda):
    """Small float32 model, a 2x2 pool with staggered admission: the card
    (masked kernel) and the CPU (plain versions) give the same words."""
    from sat_tpu_torch.config import Config
    from sat_tpu_torch.ops import beam_search as bs
    from sat_tpu_torch.train.checkpoint import param_shapes, params_from_flat

    config = Config(
        image_size=32, dim_embedding=16, num_lstm_units=16, dim_initialize_layer=16,
        dim_attend_layer=16, dim_decode_layer=32, vocabulary_size=50,
        compute_dtype="float32", max_caption_length=8,
    )
    rng = np.random.default_rng(1)
    flat = {k: rng.uniform(-0.08, 0.08, s).astype(np.float32) for k, s in param_shapes(config).items()}
    contexts = rng.normal(size=(5, config.num_ctx, config.dim_ctx)).astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        params = params_from_flat(flat, config, dev)["decoder"]
        carry = bs.init_slot_pool(config, 4, device=dev)
        before = fa.fused_attend.masked_launches
        words = {}
        for r in range(5):
            slot = r % 4
            src = torch.zeros(4, dtype=torch.int64, device=dev)
            admit = (torch.arange(4) == slot).to(dev)
            carry = bs.init_slots(params, config, carry, torch.from_numpy(contexts[r:r + 1]).to(dev), src, admit)
            carry, _, _ = bs.decode_multi_step(params, config, carry, torch.ones(4, dtype=torch.bool, device=dev),
                                               3, k=8)
            res = bs.harvest_slots(carry)
            words[r] = (res.words[slot].cpu(), res.log_scores[slot].cpu())
            carry = bs.retire_slots(carry, admit)
        out[dev] = words
        if dev == "cuda":
            assert fa.fused_attend.masked_launches == before + 5 * 8
    for r in range(5):
        assert torch.equal(out["cuda"][r][0], out["cpu"][r][0])
        torch.testing.assert_close(out["cuda"][r][1], out["cpu"][r][1], rtol=0, atol=1e-4)


def _train_config(**kw):
    from sat_tpu_torch.config import Config

    return Config(
        image_size=32, dim_embedding=16, num_lstm_units=16, dim_initialize_layer=16,
        dim_attend_layer=16, dim_decode_layer=32, vocabulary_size=50, compute_dtype="float32",
        max_caption_length=8, fc_drop_rate=0.0, lstm_drop_rate=0.0, **kw,
    )


def _train_batch(config, B=4, seed=0):
    rng = np.random.default_rng(seed)
    T = config.max_caption_length
    masks = (np.arange(T)[None] < rng.integers(3, T + 1, size=(B, 1))).astype(np.float32)
    return {
        "images": rng.integers(0, 256, size=(B, config.image_size, config.image_size, 3), dtype=np.uint8),
        "word_idxs": (rng.integers(1, config.vocabulary_size, size=(B, T)) * masks).astype(np.int32),
        "masks": masks,
    }


def test_train_steps_on_the_card_match_the_cpu(cuda):
    """Small float32 model, dropout off: 3 Adam steps on the card and on
    the CPU from the same weights and batch.  Losses within 1e-5 relative,
    parameters within 1e-5 absolute; the train step launches no kernel."""
    from sat_tpu_torch.device import resolve_device
    from sat_tpu_torch.train.checkpoint import params_to_flat
    from sat_tpu_torch.train.step import create_train_state, make_train_step, step_generator

    config = _train_config()
    resolve_device("cuda")
    batch = _train_batch(config)
    losses, flats = {}, {}
    for dev in ("cuda", "cpu"):
        state = create_train_state(config, torch.Generator().manual_seed(0), dev)
        step = make_train_step(config)
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        before = (fa.fused_attend.launches, fa.fused_attend.masked_launches)
        losses[dev] = []
        for s in range(3):
            state, metrics = step(state, tb, step_generator(0, s, dev))
            losses[dev].append(float(metrics["total_loss"]))
        assert (fa.fused_attend.launches, fa.fused_attend.masked_launches) == before
        flats[dev] = params_to_flat(state.params)
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5)
    for k, v in flats["cpu"].items():
        np.testing.assert_allclose(flats["cuda"][k], v, rtol=0, atol=1e-5, err_msg=k)


def test_kernel_refuses_to_be_differentiated_on_the_card(cuda):
    args = [x.requires_grad_(i == 2) for i, x in enumerate(_inputs(3, 7, 24, 40))]
    before = fa.fused_attend.launches
    with pytest.raises(RuntimeError, match="no backward"):
        fa.fused_attend(*args)
    assert fa.fused_attend.launches == before
    with torch.no_grad():
        fa.fused_attend(*args)
    assert fa.fused_attend.launches == before + 1


def test_eval_loss_step_launches_the_kernel_once_a_step(cuda):
    """The eval-loss step (no grad) goes through the unmasked kernel once
    per decode step, T in all, and its metrics match the CPU's within
    1e-5 relative."""
    from sat_tpu_torch.device import resolve_device
    from sat_tpu_torch.train.step import create_train_state, make_eval_loss_step

    config = _train_config()
    resolve_device("cuda")
    batch = _train_batch(config, seed=1)
    got = {}
    for dev in ("cuda", "cpu"):
        state = create_train_state(config, torch.Generator().manual_seed(0), dev)
        before = fa.fused_attend.launches
        got[dev] = make_eval_loss_step(config)(state, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        launched = fa.fused_attend.launches - before
        assert launched == (config.max_caption_length if dev == "cuda" else 0)
    for k, v in got["cpu"].items():
        np.testing.assert_allclose(float(got["cuda"][k]), float(v), rtol=1e-5, err_msg=k)


def test_bulk_on_the_card_matches_the_cpu(cuda, tmp_path):
    """``run_bulk`` at the small float32 size over 9 JPEGs and one file that
    is not a JPEG: the card (masked kernel) and the CPU (plain versions)
    write the same files, captions and quarantine markers, log-probs within
    1e-4; the card's run launched the masked kernel, the unmasked never."""
    import json
    import os

    import cv2

    from sat_tpu_torch import telemetry
    from sat_tpu_torch.bulk.runner import run_bulk
    from sat_tpu_torch.config import Config
    from sat_tpu_torch.data.vocabulary import Vocabulary, vocab_fingerprint
    from sat_tpu_torch.resilience import lineage
    from sat_tpu_torch.train.checkpoint import param_shapes

    corpus = tmp_path / "corpus"
    corpus.mkdir()
    rng = np.random.default_rng(2)
    for i in range(9):
        cv2.imwrite(str(corpus / f"img{i}.jpg"), rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
    (corpus / "zz_broken.jpg").write_bytes(b"not a jpeg")
    config = Config(
        image_size=32, dim_embedding=16, num_lstm_units=16, dim_initialize_layer=16,
        dim_attend_layer=16, dim_decode_layer=32, vocabulary_size=50, compute_dtype="float32",
        max_caption_length=8, beam_size=2, serve_slot_pages=2, serve_page_width=2,
        heartbeat_interval=0.0, shard_cache="off", bulk_input=str(corpus), bulk_shard_rows=4,
        vocabulary_file=str(tmp_path / "vocabulary.csv"), save_dir=str(tmp_path / "models"),
    )
    vocab = Vocabulary(50)
    vocab.build([f"w{i} ." for i in range(60)])
    vocab.save(config.vocabulary_file)
    flat = {k: rng.uniform(-0.08, 0.08, s).astype(np.float32) for k, s in param_shapes(config).items()}
    flat["params/decoder/decode/fc_2/bias"][vocab.word2idx["."]] -= 2.0
    os.makedirs(config.save_dir)
    path = os.path.join(config.save_dir, "1.npz")
    np.savez(path, **flat, global_step=np.asarray(1, np.int32))
    lineage.write_sidecar(path, vocab=vocab_fingerprint(config.vocabulary_file, config.vocabulary_size))
    rows = {}
    for dev in ("cuda", "cpu"):
        out = str(tmp_path / dev)
        before = (fa.fused_attend.launches, fa.fused_attend.masked_launches)
        try:
            assert run_bulk(config.replace(bulk_output=out, summary_dir=str(tmp_path / f"{dev}_summary")),
                            model_file=path, device=dev) == 0
        finally:
            telemetry.disable()
        if dev == "cuda":
            assert fa.fused_attend.launches == before[0]
            assert fa.fused_attend.masked_launches > before[1]
        rows[dev] = [json.loads(line) for n in sorted(os.listdir(out)) if n.endswith(".jsonl")
                     for line in open(os.path.join(out, n))]
    assert len(rows["cuda"]) == 10
    for a, b in zip(rows["cuda"], rows["cpu"]):
        assert (a["file"], a.get("quarantined"), a.get("substituted_from")) == (
            b["file"], b.get("quarantined"), b.get("substituted_from"))
        assert [c["caption"] for c in a["captions"]] == [c["caption"] for c in b["captions"]]
        np.testing.assert_allclose([c["log_prob"] for c in a["captions"]],
                                   [c["log_prob"] for c in b["captions"]], rtol=0, atol=1e-4)


def test_resnet50_serving_on_the_card_matches_the_cpu(cuda):
    """The small float32 ResNet50 (64 px: N=4, D=2048; running statistics
    drawn from a seed): contexts within 1e-4 of max|ctx| and the same
    words on the card (B1) and on the CPU."""
    from sat_tpu_torch.config import Config
    from sat_tpu_torch.data.vocabulary import Vocabulary
    from sat_tpu_torch.serve.engine import ServeEngine, ServingState
    from sat_tpu_torch.train.checkpoint import batch_stats_from_flat, param_shapes, params_from_flat

    config = Config(
        cnn="resnet50", image_size=64, dim_embedding=16, num_lstm_units=16, dim_initialize_layer=16,
        dim_attend_layer=16, dim_decode_layer=32, vocabulary_size=50,
        compute_dtype="float32", serve_buckets=(4,), serve_max_batch=4,
    )
    rng = np.random.default_rng(2)
    flat = {k: (rng.uniform(0.5, 1.5, s) if k.endswith(("/var", "/scale")) else rng.uniform(-0.08, 0.08, s))
            .astype(np.float32) for k, s in param_shapes(config).items()}
    vocab = Vocabulary(50)
    vocab.build([f"w{i} ." for i in range(60)])
    images = rng.integers(0, 256, size=(4, 64, 64, 3), dtype=np.uint8)
    out, ctx = {}, {}
    for dev in ("cuda", "cpu"):
        state = ServingState(params_from_flat(flat, config, dev), step=0,
                             batch_stats=batch_stats_from_flat(flat, config, dev))
        engine = ServeEngine(config, state, vocab, device=dev)
        ctx[dev] = engine.encode_images(images).cpu()
        before = fa.fused_attend.launches
        out[dev] = engine.drain_output(engine.dispatch(images), 4)
        assert (fa.fused_attend.launches > before) == (dev == "cuda")
    assert ctx["cuda"].shape == (4, 4, 2048)
    assert float((ctx["cuda"] - ctx["cpu"]).abs().max() / ctx["cpu"].abs().max()) <= 1e-4
    np.testing.assert_array_equal(out["cuda"][0], out["cpu"][0])


@pytest.mark.parametrize("B,C,H,O,k,s", [(8, 3, 224, 64, 7, 2), (8, 64, 56, 64, 3, 1), (3, 256, 14, 512, 1, 2)])
def test_int8_conv_on_the_card_is_the_cpus(cuda, B, C, H, O, k, s):
    """The quantized encoder's int8 conv (im2col and ``torch._int_mm``):
    int32 accumulators on the card bitwise the CPU's exact product, at
    ResNet50's conv1, a 3×3 and a strided 1×1."""
    from sat_tpu_torch.nn.quant import int8_conv

    g = torch.Generator().manual_seed(B + C)
    x = torch.randint(-127, 128, (B, C, H, H), generator=g).to(torch.int8)
    w = torch.randint(-127, 128, (O, C, k, k), generator=g).to(torch.int8)
    got = int8_conv(x.to(cuda), w.to(cuda), s).cpu()
    assert got.dtype == torch.int32
    assert torch.equal(got, int8_conv(x, w, s))


def test_encode_cache_ring_on_the_card_is_bitwise(cuda):
    """The encode cache's ring on the card: ``insert`` then ``gather`` give
    the inserted rows bitwise, a lane's pad positions write only the
    scratch row, and rows of other widths are left as they were."""
    from sat_tpu_torch.serve.encode_cache import EncodeCache

    cache = EncodeCache(1)
    cache.ensure_store((196, 512), np.float32, min_rows=32, device=torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    first = torch.randn((32, 196, 512), device="cuda", generator=gen)
    cache.insert(32, first, list(range(32)))
    lane = torch.randn((4, 196, 512), device="cuda", generator=gen)
    cache.insert(4, lane, [5])
    got = cache.gather(16, [5, 0, 31])
    torch.cuda.synchronize()
    assert torch.equal(got[0], lane[0]) and torch.equal(got[1], first[0]) and torch.equal(got[2], first[31])
    assert torch.equal(cache.gather(4, [1, 2, 3, 4]), first[1:5])
    assert torch.equal(got[3], cache._store[cache.rows])
