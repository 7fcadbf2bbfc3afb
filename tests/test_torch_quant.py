"""The quantized serve encoder (``encoder_quant``) of the port, held against
sat_tpu's ``nn.quant`` on the same weights and images: the per-channel
int8 kernel and the batch-norm fold, the calibration bytes and ranges,
the bf16 and int8 context grids of both CNNs within JAX's own divergence
bounds (``tests/test_quant.py``), the serve engine that quantizes once
and keeps no float32 CNN, and the phases that ignore the knob (train,
eval and test encode in full precision, as in the JAX package)."""

import json
import os
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sat_tpu import runtime as jrt
from sat_tpu.data import dataset as jax_dataset
from sat_tpu.data.images import ILSVRC_2012_MEAN
from sat_tpu.models.captioner import encode as jax_encode
from sat_tpu.nn import quant as jquant
from sat_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from sat_tpu_torch import runtime
from sat_tpu_torch.data.vocabulary import Vocabulary
from sat_tpu_torch.models.captioner import encode
from sat_tpu_torch.nn import quant
from sat_tpu_torch.serve import engine as engine_mod
from sat_tpu_torch.serve.engine import ServeEngine
from sat_tpu_torch.serve.server import CaptionServer
from sat_tpu_torch.serve.slot_pool import PagedSlotPool
from sat_tpu_torch.train.checkpoint import (
    ServingState, batch_stats_from_flat, compute_params, load_flat, params_from_flat,
)
from tests.test_quant import _CTX_BOUNDS
from tests.test_torch_eval import _outputs, _settings, _snapshot
from tests.test_torch_import import _jax_flat
from tests.test_torch_train_loop import port_config
from tests.torch_port_helpers import configs, jax_variables

torch.set_num_threads(2)

SIZES = {"vgg16": 32, "resnet50": 64}   # tests/test_quant.py's sizes: N = 4 for both


def _world(cnn, mode="off", **kw):
    jc, tc = configs(cnn=cnn, image_size=SIZES[cnn], encoder_quant=mode, **kw)
    variables = jax_variables(jc)
    flat = _jax_flat(variables)
    return jc, tc, variables, params_from_flat(flat, tc), batch_stats_from_flat(flat, tc)


def _images(size, n=2, seed=0):
    raw = np.random.default_rng(seed).integers(0, 256, size=(n, size, size, 3)).astype(np.float32)
    return raw - np.asarray(ILSVRC_2012_MEAN, np.float32)


def test_quantize_kernel_is_bitwise_jax():
    """Per-output-channel symmetric int8 (an all-zero channel on the ε
    floor): the same int8 values and float32 scales, bitwise."""
    k = np.random.default_rng(1).normal(size=(3, 3, 8, 16)).astype(np.float32)
    k[..., 5] = 0.0
    want_q, want_s = jquant.quantize_kernel(jnp.asarray(k))
    q, s = quant.quantize_kernel(torch.from_numpy(k).permute(3, 2, 0, 1))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.permute(2, 3, 1, 0).numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))
    assert s[5] > 0 and not q[5].any()


def test_fold_bn_matches_jax():
    """The folded kernel and bias within 1e-6 relative of JAX's (float32
    rounding of the same products)."""
    rng = np.random.default_rng(2)
    k = rng.normal(size=(3, 3, 4, 6)).astype(np.float32)
    b, beta, mean = (rng.normal(size=(6,)).astype(np.float32) for _ in range(3))
    gamma, var = rng.uniform(0.5, 2.0, (6,)).astype(np.float32), rng.uniform(0.1, 2.0, (6,)).astype(np.float32)
    for bias in (b, None):
        wk, wb = jquant.fold_bn(k, bias, gamma, beta, mean, var)
        t = (lambda a: None if a is None else torch.from_numpy(a))
        gk, gb = quant.fold_bn(t(k).permute(3, 2, 0, 1), t(bias), *map(t, (gamma, beta, mean, var)))
        np.testing.assert_allclose(gk.permute(2, 3, 1, 0).numpy(), np.asarray(wk), rtol=1e-6, atol=0)
        np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("cache", [False, True], ids=["noise", "shard_cache"])
@pytest.mark.parametrize("cnn", ["vgg16", "resnet50"])
def test_calibration_matches_jax(cnn, cache, tmp_path):
    """The calibration bytes (the shard cache's first rows when it is there
    and on, else ``default_rng(0)`` noise) are JAX's, bitwise, and each
    conv's input range is JAX's within 1e-5 relative (float32 convs summed
    in another order, up to 53 deep: 1.5e-6 measured)."""
    jc, tc, variables, params, stats = _world(cnn, "int8", encoder_quant_calib_batches=2,
                                              encoder_quant_calib_batch_size=2,
                                              shard_cache_dir=str(tmp_path), shard_cache="on")
    if cache:
        s = SIZES[cnn]
        rows = np.random.default_rng(4).integers(0, 256, (6, s, s, 3)).astype(np.uint8)
        np.save(str(tmp_path / "shard_00000.npy"), rows)
    want = jquant.calibration_batches(jc)
    got = quant.calibration_batches(tc)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    want_ranges = jquant.calibrate(jquant.folded_convs(variables, jc), jc, want)
    ranges = quant.calibrate(quant.folded_convs({**params, "batch_stats": stats}, tc), tc, got)
    assert set(ranges) == set(want_ranges) and len(ranges) == (13 if cnn == "vgg16" else 53)
    for name, value in want_ranges.items():
        assert ranges[name] == pytest.approx(value, rel=1e-5), name


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("cnn", ["vgg16", "resnet50"])
def test_quantized_contexts_within_jax_bounds(cnn, mode):
    """The port's quantized contexts diverge from its float32 contexts by no
    more than JAX's own gate allows (``_CTX_BOUNDS``: int8 0.10, bf16 0.05
    of max|ctx|).  Against JAX's quantized contexts: int8 kernels and
    weight scales bitwise, folded biases within 1e-6 relative, and with
    JAX's activation scales adopted (the calibration's float32 sums differ
    in their last bits, and a scale one ulp off rounds some activations
    the other way) the int8 contexts within 1e-6 of max|ctx|; bf16 within
    1e-2 of max|ctx| (a bf16 ulp is 0.4%, and the two conv libraries sum
    in their own order before rounding to it)."""
    jc, tc, variables, params, stats = _world(cnn, mode)
    images = _images(SIZES[cnn])
    qcnn = quant.quantize_encoder({**params, "batch_stats": stats}, tc)
    assert len(qcnn) == (13 if cnn == "vgg16" else 53)
    kernel = next(iter(qcnn.values()))["kernel"]
    assert kernel.dtype == (torch.int8 if mode == "int8" else torch.bfloat16)
    decoder = compute_params({"decoder": params["decoder"]}, tc)
    got = encode({**decoder, "qcnn": qcnn}, tc, torch.from_numpy(images)).numpy()
    full = encode(compute_params(params, tc, stats), tc.replace(encoder_quant="off"),
                  torch.from_numpy(images)).numpy()
    assert got.shape == full.shape and got.dtype == np.float32
    scale = np.abs(full).max()
    assert np.abs(got - full).max() / scale <= _CTX_BOUNDS[mode]

    jq = jquant.quantize_encoder(variables, jc)
    assert set(jq) == set(qcnn)
    for name, spec in jq.items():
        np.testing.assert_allclose(qcnn[name]["bias"].numpy(), np.asarray(spec["bias"]), rtol=1e-6, atol=1e-6)
        if mode == "int8":
            np.testing.assert_array_equal(qcnn[name]["kernel"].permute(2, 3, 1, 0).numpy(), np.asarray(spec["kernel"]))
            np.testing.assert_array_equal(qcnn[name]["w_scale"].numpy(), np.asarray(spec["w_scale"]))
            assert qcnn[name]["act_scale"] == pytest.approx(float(spec["act_scale"]), rel=1e-5)
            qcnn[name]["act_scale"] = float(spec["act_scale"])
    want, _ = jax_encode({"params": {"decoder": variables["params"]["decoder"]}, "qcnn": jq}, jc, jnp.asarray(images))
    if mode == "int8":
        got = encode({**decoder, "qcnn": qcnn}, tc, torch.from_numpy(images)).numpy()
    assert np.abs(got - np.asarray(want)).max() / scale <= (1e-6 if mode == "int8" else 1e-2)


def test_int8_accumulators_are_exact():
    """The int8 conv's int32 accumulators equal an exact float64 conv of the
    same integers, at conv1's 7×7/2 (K = 147, padded to 152) and a 3×3."""
    g = torch.Generator().manual_seed(0)
    for B, C, H, O, k, s in [(2, 3, 64, 64, 7, 2), (1, 64, 5, 64, 3, 1)]:
        x = torch.randint(-127, 128, (B, C, H, H), generator=g).to(torch.int8)
        w = torch.randint(-127, 128, (O, C, k, k), generator=g).to(torch.int8)
        acc = quant.int8_conv(x, w, s)
        ref = quant._conv2d(x.double(), w.double(), s)
        assert acc.dtype == torch.int32
        assert torch.equal(acc.double(), ref)


def _engine(tc, params, stats, vocab_file):
    state = ServingState(params=params, step=3, batch_stats=stats)
    return ServeEngine(tc, state, Vocabulary(tc.vocabulary_size, vocab_file), device="cpu")


def test_int8_engine_quantizes_once_and_keeps_no_float32_cnn(tmp_path, monkeypatch):
    """ResNet50 served with ``encoder_quant="int8"``: quantized once, at
    load; the engine's params hold the decoder and ``qcnn`` only (no
    float32 conv kernel, no running statistics); warmup, a dispatch and the
    slot pool's lanes all encode through it; ``/stats`` reports the mode
    and ``quantize_seconds``."""
    jc, tc, variables, params, stats = _world("resnet50", "int8", beam_size=2, serve_buckets=(1, 2),
                                              serve_max_batch=2, serve_slot_pages=1, serve_page_width=2)
    vocab = Vocabulary(tc.vocabulary_size)
    vocab.build(["a man riding a horse.", "two dogs on the grass."])
    vocab.save(str(tmp_path / "vocabulary.csv"))
    calls = []
    monkeypatch.setattr(engine_mod, "quantize_encoder",
                        lambda *a, **k: calls.append(1) or quant.quantize_encoder(*a, **k))
    engine = _engine(tc, params, stats, str(tmp_path / "vocabulary.csv"))
    assert set(engine._params) == {"decoder", "qcnn"}
    assert all(spec["kernel"].dtype == torch.int8 for spec in engine._params["qcnn"].values())
    assert engine.quantize_seconds > 0 and engine.encoder_quant == "int8"
    engine.warmup()
    images = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    out = engine.drain_output(engine.dispatch(images), 2)
    assert np.isfinite(out[2]).all()
    pool = PagedSlotPool(engine)
    pool.warmup()
    assert pool.admit([(images[0], 0)]) == 1
    assert calls == [1]
    # the server's heartbeat and access log land under summary_dir
    server = CaptionServer(tc.replace(summary_dir=str(tmp_path / "summary")), engine, port=0).start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/stats", timeout=30) as r:
            block = json.loads(r.read())["engine"]
    finally:
        server.shutdown()
    assert block["encoder_quant"] == "int8" and block["quantize_seconds"] >= 0


@pytest.fixture(scope="module")
def quantized_phases(coco_fixture, tmp_path_factory):
    """The small VGG16 model through JAX's eval and the port's eval, test
    and two train steps, each with ``encoder_quant`` off and int8."""
    root = tmp_path_factory.mktemp("torch_quant_phases")
    out = {}
    for mode in ("off", "int8"):
        settings = dict(_settings(coco_fixture, root), encoder_quant=mode, save_attention_maps=False)
        jc, _ = configs(**settings, **_outputs({"root": root / f"jax_{mode}"}))
        _, tc = configs(**settings, **_outputs({"root": root / f"port_{mode}"}))
        if mode == "off":
            jax_dataset.build_vocabulary(jc)
            state = jax.jit(jrt.create_train_state, static_argnums=1)(jax.random.PRNGKey(0), jc)
            out["path"] = jax_save_checkpoint(state, jc)
            out["jstate"] = state
        jrt.evaluate(jc, state=out["jstate"])
        out[f"jax_{mode}"] = _snapshot(jc)["results"]
        runtime.evaluate(tc, model_file=out["path"], device="cpu")
        out[f"port_{mode}"] = _snapshot(tc)["results"]
        out[f"test_{mode}"] = runtime.test(tc, model_file=out["path"], device="cpu")
        train = port_config(coco_fixture, str(root / f"train_{mode}"), encoder_quant=mode, max_steps=2,
                            save_period=0)
        runtime.train(train, device="cpu")
        out[f"train_{mode}"] = load_flat(os.path.join(train.save_dir, "2.npz"))
    return out


def test_eval_test_and_train_ignore_encoder_quant(quantized_phases):
    """With ``encoder_quant="int8"`` eval, test and train run and encode in
    full precision, as the JAX package does there: results.json equal to
    the unquantized run's and to JAX's int8 run's; test's captions and the
    trained checkpoint bitwise the unquantized run's."""
    q = quantized_phases
    assert q["port_int8"] == q["port_off"] == q["jax_int8"] == q["jax_off"]
    assert [(r["image_file"], r["caption"], r["prob"]) for r in q["test_int8"]] == [
        (r["image_file"], r["caption"], r["prob"]) for r in q["test_off"]]
    assert set(q["train_int8"]) == set(q["train_off"])
    for name, value in q["train_off"].items():
        np.testing.assert_array_equal(q["train_int8"][name], value, err_msg=name)
