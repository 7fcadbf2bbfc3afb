"""A candidate or resident model under ``encoder_quant`` is quantized from
its host tree: its float32 CNN is never handed to the engine's device
whole, each conv moves there alone and is folded, calibrated and
quantized there, and the staged ``qcnn`` is bitwise the incumbent's for
the same checkpoint (through the lifecycle loader and through
``install_resident``), as sat_tpu's loader quantizes from the host."""

import os

import numpy as np
import pytest
import torch

from sat_tpu.data.vocabulary import vocab_fingerprint as jax_vocab_fingerprint
from sat_tpu.resilience import lineage as jax_lineage
from sat_tpu_torch.lifecycle.loader import load_candidate
from sat_tpu_torch.nn import quant
from sat_tpu_torch.serve import engine as engine_mod
from tests.test_torch_import import _jax_flat
from tests.test_torch_serve import make_checkpoint
from tests.torch_port_helpers import jax_variables
from tests.torch_planes_helpers import port_engine

torch.set_num_threads(2)


def _leaves(tree):
    if isinstance(tree, dict):
        for value in tree.values():
            yield from _leaves(value)
    else:
        yield tree


def _cnn_leaves(tree, path=()):
    """(path, float32 tensor) of every leaf under a "cnn" or
    "batch_stats" key."""
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _cnn_leaves(value, path + (key,))
    elif isinstance(tree, torch.Tensor) and tree.dtype == torch.float32 and (
            "cnn" in path or "batch_stats" in path or tree.dim() == 4):
        yield path, tree


def _same_qcnn(a, b):
    assert set(a) == set(b)
    for name in a:
        assert set(a[name]) == set(b[name]), name
        for key, value in a[name].items():
            other = b[name][key]
            if isinstance(value, torch.Tensor):
                assert value.dtype == other.dtype and torch.equal(value, other), f"{name}/{key}"
            else:
                assert value == other, f"{name}/{key}"


@pytest.mark.parametrize("cnn,mode", [("vgg16", "int8"), ("vgg16", "bf16"), ("resnet50", "int8")])
def test_candidate_and_resident_quantize_from_the_host_tree(cnn, mode, tmp_path, monkeypatch):
    size = 32 if cnn == "vgg16" else 64
    jc, tc, _, _ = make_checkpoint(tmp_path, cnn=cnn, image_size=size, encoder_quant=mode,
                                   serve_buckets=(1, 2), serve_max_batch=2)
    if cnn == "resnet50":
        # ResNet50's running statistics ride the checkpoint too
        flat = dict(_jax_flat(jax_variables(jc)), global_step=np.asarray(5, np.int32))
        path = os.path.join(jc.save_dir, "5.npz")
        np.savez(path, **flat)
        jax_lineage.write_sidecar(path, vocab=jax_vocab_fingerprint(jc.vocabulary_file, jc.vocabulary_size))
    path = jax_lineage.last_good_checkpoint(jc.save_dir)
    engine = port_engine(tc)
    incumbent = engine.slot_variables("incumbent")
    assert set(incumbent) == {"decoder", "qcnn"}

    handed, quantized_on = [], []
    real, real_quantize = engine_mod.to_device, engine_mod.quantize_encoder
    monkeypatch.setattr(engine_mod, "to_device", lambda tree, device: handed.append(tree) or real(tree, device))

    def spy_quantize(tree, config, batches=None, device=None):
        quantized_on.append(device)
        return real_quantize(tree, config, batches, device)

    monkeypatch.setattr(engine_mod, "quantize_encoder", spy_quantize)
    staged = load_candidate(engine, tc, path)
    assert handed, "the loader never placed the candidate"
    for tree in handed:
        assert list(_cnn_leaves(tree)) == [], "a float32 CNN tensor was handed to the device"
    assert quantized_on == [engine.device], "the encoder was not quantized on the engine's device"
    assert set(staged["variables"]) == {"decoder", "qcnn"}
    _same_qcnn(staged["variables"]["qcnn"], incumbent["qcnn"])
    for a, b in zip(_leaves(staged["variables"]["decoder"]), _leaves(incumbent["decoder"])):
        assert torch.equal(a, b)

    engine.install_candidate(staged["variables"], staged["decoder_params"], staged["step"], staged["source"])
    _same_qcnn(engine.slot_variables("canary")["qcnn"], incumbent["qcnn"])
    engine.install_resident("m1", staged["variables"], staged["decoder_params"], staged["step"], staged["source"])
    _same_qcnn(engine.slot_variables("m1")["qcnn"], incumbent["qcnn"])


@pytest.mark.parametrize("cnn", ["vgg16", "resnet50"])
def test_fold_runs_on_the_target_device(cnn, tmp_path):
    """``folded_convs(..., device)`` folds each conv where it is sent: on
    the meta device every folded kernel and bias lies there, with the
    shapes of the fold on the tree's own device, and the tree stays put."""
    size = 32 if cnn == "vgg16" else 64
    _, tc, _, _ = make_checkpoint(tmp_path, cnn=cnn, image_size=size, encoder_quant="int8",
                                  serve_buckets=(1, 2), serve_max_batch=2)
    from sat_tpu_torch.models.captioner import init_variables

    params, batch_stats = init_variables(tc, torch.Generator().manual_seed(0))
    tree = {"cnn": params["cnn"], "batch_stats": batch_stats}
    here = quant.folded_convs(tree, tc)
    there = quant.folded_convs(tree, tc, device=torch.device("meta"))
    assert set(here) == set(there)
    for name, spec in there.items():
        for key, value in spec.items():
            assert value.device.type == "meta" and value.shape == here[name][key].shape, f"{name}/{key}"
    assert all(t.device.type == "cpu" for t in _leaves(tree))
