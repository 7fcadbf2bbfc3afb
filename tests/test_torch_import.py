"""The reference's own weight formats in the port, held against sat_tpu on
the same files: the pretrained-CNN import (``vgg16_no_fc.npy``,
``resnet50_no_fc.npy``, written layout-exact from a seed by
``tests/ref_layouts.py``), the import of a checkpoint the reference's
``save()`` wrote (a flat ``{var.name: value}`` npy), the export back to
that format, and the trim tool.  Counts equal JAX's and every tensor
lands bitwise where JAX's lands; ``--load_cnn`` imports in
``--phase train`` and eval and test ignore it."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sat_tpu.train.checkpoint import export_reference_checkpoint as jax_export
from sat_tpu.train.checkpoint import flatten_with_names
from sat_tpu.train.checkpoint import import_reference_checkpoint as jax_import
from sat_tpu.train.checkpoint import load_pretrained_cnn as jax_load_pretrained_cnn
from sat_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from sat_tpu.train.checkpoint import trim_checkpoint as jax_trim
from sat_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from sat_tpu.train.step import TrainState as JaxTrainState
from sat_tpu.train.step import split_trainable as jax_split_trainable
from sat_tpu_torch import cli, runtime
from sat_tpu_torch.train.checkpoint import (
    batch_stats_from_flat, export_reference_checkpoint, import_reference_checkpoint, load_flat,
    load_pretrained_cnn, named_leaves, params_from_flat, state_to_flat, trim_checkpoint,
)
from sat_tpu_torch.train.step import state_from_params
from tests.ref_layouts import make_reference_train_checkpoint, make_resnet50_no_fc, make_vgg16_no_fc
from tests.test_torch_train_loop import port_config
from tests.torch_port_helpers import configs, jax_variables

torch.set_num_threads(2)

CNNS = {"vgg16": dict(cnn="vgg16"), "resnet50": dict(cnn="resnet50", image_size=64)}
# the reference's TF1 names for the nested files' parameters
TF_NAMES = {"weights": "kernel", "biases": "bias", "scale": "gamma", "offset": "beta",
            "mean": "moving_mean", "variance": "moving_variance"}


def _jax_flat(variables):
    out = {k: np.asarray(v) for k, v in flatten_with_names(variables["params"], "params/").items()}
    out.update({k: np.asarray(v) for k, v in flatten_with_names(variables.get("batch_stats", {}), "batch_stats/").items()})
    return out


def _port_flat(params, batch_stats):
    out = {k: v for k, v in state_to_flat(_state(params, batch_stats)).items() if not k.startswith("optimizer/")}
    del out["global_step"]
    return out


def _state(params, batch_stats, step=0):
    class S:  # the fields the snapshot reads
        pass

    s = S()
    s.params, s.batch_stats, s.opt_state, s.step = params, batch_stats, {}, step
    return s


def _both(cnn):
    """(jax config, port config, JAX variables, the port's params and
    statistics with the same values)."""
    jc, tc = configs(**CNNS[cnn])
    variables = jax_variables(jc)
    flat = _jax_flat(variables)
    return jc, tc, variables, params_from_flat(flat, tc), batch_stats_from_flat(flat, tc)


def _assert_same(got, want):
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)


def _partial_nested(cnn, variables):
    """Some real entries, an unknown op and an entry of the wrong shape:
    both packages skip the last two."""
    cnn_params = variables["params"]["cnn"]
    if cnn == "vgg16":
        k = cnn_params["conv1_1"]["conv"]["kernel"].shape
        return {"conv1_1": {"weights": np.full(k, 0.5, np.float32), "biases": np.full(k[-1:], 0.25, np.float32)},
                "conv2_1": {"weights": np.zeros((1, 1, 1, 1), np.float32)},
                "not_a_layer": {"weights": np.zeros((3, 3, 1, 1), np.float32)}}
    k1 = cnn_params["conv1"]["conv"]["kernel"].shape
    k2 = cnn_params["res2a"]["res2a_branch2a"]["conv"]["kernel"].shape
    return {"conv1": {"weights": np.full(k1, 0.5, np.float32)},
            "bn_conv1": {"scale": np.full((64,), 2.0, np.float32), "offset": np.full((64,), 0.1, np.float32),
                         "mean": np.full((64,), 0.3, np.float32), "variance": np.full((64,), 0.9, np.float32)},
            "res2a_branch2a": {"weights": np.full(k2, 0.25, np.float32), "biases": np.ones(64, np.float32)},
            "not_a_layer": {"weights": np.zeros((3, 3, 1, 1), np.float32)}}


@pytest.mark.parametrize("layout", ["real", "partial"])
@pytest.mark.parametrize("cnn", sorted(CNNS))
def test_load_pretrained_cnn_places_what_jax_places(cnn, layout, tmp_path):
    """The layout-exact file loads fully (VGG16: 13 convs × 2; ResNet50:
    53 bias-free convs and 53 batch norms × 4); a partial file loads what
    it has.  The same count as JAX's and the same tensors, bitwise."""
    jc, tc, variables, params, stats = _both(cnn)
    path = str(tmp_path / f"{cnn}_no_fc.npy")
    if layout == "real":
        (make_vgg16_no_fc if cnn == "vgg16" else make_resnet50_no_fc)(path)
    else:
        np.save(path, np.array(_partial_nested(cnn, variables), dtype=object), allow_pickle=True)
    want_vars, want_count = jax_load_pretrained_cnn(variables, path)
    count = load_pretrained_cnn(params, stats, path)
    assert count == want_count
    if layout == "real":
        assert count == (26 if cnn == "vgg16" else 53 + 53 * 4)
    _assert_same(_port_flat(params, stats), _jax_flat(want_vars))


def _reference_file(path, jc, cnn):
    """A checkpoint as the reference's ``save()`` writes it: the decoder in
    TF1 names, the CNN's convs and batch norms under their scopes, the
    global step and optimizer slots."""
    flat = make_reference_train_checkpoint(path, jc, seed=4)
    if cnn == "resnet50":
        nested = make_resnet50_no_fc(path + ".cnn.npy", seed=5)
        flat.update({f"{op}/{TF_NAMES[p]}:0": v for op, entries in nested.items() for p, v in entries.items()})
        np.save(path, np.array(flat, dtype=object), allow_pickle=True)
    return flat


def _jax_state(jc, variables, step=0):
    trainable, _ = jax_split_trainable(variables["params"], jc)
    return JaxTrainState(params=variables["params"], batch_stats=variables.get("batch_stats", {}),
                         opt_state=jax_make_optimizer(jc).init(trainable), step=jnp.asarray(step, jnp.int32))


@pytest.mark.parametrize("cnn", sorted(CNNS))
def test_import_reference_checkpoint_matches_jax(cnn, tmp_path):
    """Decoder by name, the LSTM's concatenated kernel, the CNN through the
    aliases, optimizer slots dropped: the same count as JAX's and the same
    parameters and statistics, bitwise; ``global_step:0`` adopted only
    with ``restore_step``."""
    jc, tc, variables, params, stats = _both(cnn)
    path = str(tmp_path / "1234.npy")
    _reference_file(path, jc, cnn)
    want, want_count = jax_import(_jax_state(jc, variables), path)
    state = state_from_params(params, tc, batch_stats=stats)
    state, count = import_reference_checkpoint(state, path)
    assert count == want_count == (46 if cnn == "vgg16" else 20 + 53 + 53 * 4)
    assert state.step == 0
    _assert_same(_port_flat(state.params, state.batch_stats), _jax_flat(want._asdict()))
    assert import_reference_checkpoint(state, path, restore_step=True)[0].step == 1234


@pytest.mark.parametrize("cnn", sorted(CNNS))
def test_export_crosses_both_ways(cnn, tmp_path):
    """The port's export loads in JAX's importer to the port's tensors, and
    JAX's export loads in the port's importer to JAX's: the same counts,
    bitwise, ``global_step`` kept."""
    jc, tc, variables, params, stats = _both(cnn)
    rng = np.random.default_rng(9)
    with torch.no_grad():
        for _, t, _ in named_leaves({"p": params, "s": stats}, ""):
            t.add_(torch.from_numpy(rng.normal(0, 0.01, tuple(t.shape)).astype(np.float32)))
    port_path = str(tmp_path / "port.npy")
    n = export_reference_checkpoint(state_from_params(params, tc, step=17, batch_stats=stats), port_path)
    jstate, count = jax_import(_jax_state(jc, variables), port_path, restore_step=True)
    assert count == n and int(jstate.step) == 17
    ported = _port_flat(params, stats)
    _assert_same(_jax_flat(jstate._asdict()), ported)

    jax_path = str(tmp_path / "jax.npy")
    want_n = jax_export(_jax_state(jc, variables, step=3), jax_path)
    # into the port's perturbed tensors: every one must be overwritten
    state, count = import_reference_checkpoint(state_from_params(params, tc, batch_stats=stats),
                                               jax_path, restore_step=True)
    assert count == want_n == n and state.step == 3
    _assert_same(_port_flat(state.params, state.batch_stats), _jax_flat(variables))


def test_trim_keeps_what_jax_keeps(tmp_path):
    """Optimizer slots dropped, parameters, statistics and the step kept:
    the same entries and bytes as JAX's trim of the same ResNet50 file."""
    jc, _, variables, _, _ = _both("resnet50")
    jc = jc.replace(save_dir=str(tmp_path), vocabulary_file=str(tmp_path / "none.csv"))
    path = jax_save_checkpoint(_jax_state(jc, variables, step=2), jc)
    want_n = jax_trim(path, str(tmp_path / "jax_slim.npz"))
    n = trim_checkpoint(path, str(tmp_path / "port_slim.npz"))
    want, got = load_flat(str(tmp_path / "jax_slim.npz")), load_flat(str(tmp_path / "port_slim.npz"))
    assert n == want_n == len(got) < len(load_flat(path))
    assert not any(k.startswith("optimizer/") for k in got)
    assert any(k.startswith("batch_stats/") for k in got)
    _assert_same(got, want)


def test_cli_load_cnn_imports_before_training(coco_fixture, tmp_path, monkeypatch):
    """``--phase train --load_cnn --cnn_model_file vgg16_no_fc.npy``: the
    file's 26 tensors are imported before the first step, and with the CNN
    frozen the saved checkpoint carries them unchanged; a reference
    ``.npy`` as ``--model_file`` imports the decoder too."""
    config = port_config(coco_fixture, str(tmp_path), phase="train", max_steps=1, save_period=0)
    path = str(tmp_path / "train.json")
    config.save(path)
    cnn_file = str(tmp_path / "vgg16_no_fc.npy")
    nested = make_vgg16_no_fc(cnn_file, seed=2)
    real = runtime.resolve_device
    monkeypatch.setattr(runtime, "resolve_device", lambda device=None: real("cpu"))
    assert cli.main(["--config", path, "--load_cnn", "--cnn_model_file", cnn_file]) == 0
    saved = load_flat(os.path.join(config.save_dir, "1.npz"))
    for op in ("conv1_1", "conv5_3"):
        np.testing.assert_array_equal(saved[f"params/cnn/{op}/conv/kernel"], nested[op]["weights"])
        np.testing.assert_array_equal(saved[f"params/cnn/{op}/conv/bias"], nested[op]["biases"])

    ref = str(tmp_path / "ref.npy")
    flat = make_reference_train_checkpoint(ref, config, seed=6)
    state = runtime.setup_train_state(config, model_file=ref, device="cpu")
    assert state.step == 0
    np.testing.assert_array_equal(
        state.params["decoder"]["lstm"]["kernel"].detach().numpy(), flat["lstm/lstm_cell/kernel:0"])
    serving = runtime.setup_state(config, model_file=ref, device="cpu")
    np.testing.assert_array_equal(
        serving.params["decoder"]["attend"]["fc_1a"]["kernel"].numpy(), flat["attend/fc_1a/kernel:0"])
    empty = str(tmp_path / "empty.npy")
    np.save(empty, np.array({"OptimizeLoss/x:0": np.zeros(2)}, dtype=object), allow_pickle=True)
    for setup in (runtime.setup_state, runtime.setup_train_state):
        with pytest.raises(ValueError, match="restored 0 tensors"):
            setup(config, model_file=empty, device="cpu")


def test_cli_takes_the_encoder_flags():
    """``--cnn_model_file`` and ``--encoder_quant``, as the JAX CLI has them."""
    config, opts = cli.build_config(["--phase", "serve", "--encoder_quant", "int8",
                                     "--cnn_model_file", "resnet50_no_fc.npy", "--load_cnn"])
    assert config.encoder_quant == "int8"
    assert (opts["cnn_model_file"], opts["load_cnn"]) == ("resnet50_no_fc.npy", True)
    assert cli.build_config([])[1]["cnn_model_file"] == "./vgg16_no_fc.npy"
    assert cli.build_config([])[0].encoder_quant == "off"
    with pytest.raises(SystemExit):
        cli.build_config(["--encoder_quant", "int4"])
