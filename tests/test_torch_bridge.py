"""The weight bridge and the checkpoint read side of sat_tpu_torch, held
against sat_tpu's checkpoint writer: one ``<step>.npz`` format serves
both packages, in both directions, bit for bit."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sat_tpu.data.vocabulary import Vocabulary as JaxVocabulary
from sat_tpu.data.vocabulary import vocab_fingerprint as jax_vocab_fingerprint
from sat_tpu.resilience import lineage as jax_lineage
from sat_tpu.train.checkpoint import latest_checkpoint as jax_latest_checkpoint
from sat_tpu.train.checkpoint import save_checkpoint
from sat_tpu.train.optimizer import make_optimizer
from sat_tpu.train.step import TrainState
from sat_tpu_torch.data.vocabulary import Vocabulary, vocab_fingerprint
from sat_tpu_torch.serve.engine import load_serving_state
from sat_tpu_torch.train.checkpoint import (
    VocabMismatchError,
    latest_checkpoint,
    param_shapes,
    params_from_flat,
    params_to_flat,
)
from tests.torch_port_helpers import configs, flat_params, jax_variables

torch.set_num_threads(2)

SENTENCES = ["a man riding a horse.", "a dog runs on the grass.", "two cats sit."]


def test_flat_roundtrip_is_bitwise():
    jc, tc = configs()
    flat = flat_params(jax_variables(jc))
    assert set(flat) == set(param_shapes(tc))
    params = params_from_flat(flat, tc, "cpu")
    back = params_to_flat(params)
    assert set(back) == set(flat)
    for name, value in flat.items():
        np.testing.assert_array_equal(back[name], value, err_msg=name)
    # conv kernels cross as HWIO → OIHW, dense kernels stay [in, out]
    k = flat["params/cnn/conv2_1/conv/kernel"]
    w = params["cnn"]["conv2_1"]["weight"].numpy()
    assert w.shape == (k.shape[3], k.shape[2], 3, 3)
    np.testing.assert_array_equal(w[5, 7], k[:, :, 7, 5])
    assert tuple(params["decoder"]["attend"]["fc_1a"]["kernel"].shape) == (512, 16)


def test_bridge_rejects_what_it_does_not_know():
    jc, tc = configs()
    flat = flat_params(jax_variables(jc))
    extra = dict(flat, **{"optimizer/0/mu/x": np.zeros(3), "global_step": np.int32(4)})
    params_from_flat(extra, tc, "cpu")  # skipped by name
    with pytest.raises(KeyError, match="not a parameter"):
        params_from_flat(dict(flat, **{"params/decoder/extra/kernel": np.zeros(2)}), tc, "cpu")
    missing = dict(flat)
    del missing["params/decoder/lstm/bias"]
    with pytest.raises(KeyError, match="lacks 1"):
        params_from_flat(missing, tc, "cpu")
    with pytest.raises(ValueError, match="shape"):
        params_from_flat(flat, configs(dim_attend_layer=8)[1], "cpu")


def test_vocabulary_files_cross_both_ways(tmp_path):
    jv = JaxVocabulary(size=20)
    jv.build(SENTENCES)
    jax_file = str(tmp_path / "jax.csv")
    jv.save(jax_file)
    port = Vocabulary(20, jax_file)
    assert port.words == jv.words
    np.testing.assert_allclose(port.word_frequencies, jv.word_frequencies)
    assert vocab_fingerprint(jax_file, 20) == jax_vocab_fingerprint(jax_file, 20)
    assert vocab_fingerprint(str(tmp_path / "missing.csv"), 20) is None

    pv = Vocabulary(20)
    pv.build(SENTENCES)
    port_file = str(tmp_path / "port.csv")
    pv.save(port_file)
    back = JaxVocabulary(20, port_file)
    assert back.words == pv.words == jv.words
    assert back.get_sentence([1, 2, 3]) == pv.get_sentence([1, 2, 3])


@pytest.fixture
def jax_save_dir(tmp_path):
    """A save_dir written by sat_tpu's own save_checkpoint: npz (with
    optimizer slots and global_step), sha256+vocab sidecar, LAST_GOOD."""
    jc, tc = configs(
        save_dir=str(tmp_path / "models"),
        vocabulary_file=str(tmp_path / "vocabulary.csv"),
    )
    jv = JaxVocabulary(size=jc.vocabulary_size)
    jv.build(SENTENCES)
    jv.save(jc.vocabulary_file)
    variables = jax_variables(jc)
    state = TrainState(
        params=variables["params"],
        batch_stats={},
        opt_state=make_optimizer(jc).init(variables["params"]["decoder"]),
        step=jnp.asarray(7, jnp.int32),
    )
    path = save_checkpoint(state, jc)
    return jc, tc, path, variables


def test_jax_checkpoint_loads_through_the_lineage(jax_save_dir):
    jc, tc, path, variables = jax_save_dir
    assert jax_lineage.last_good_step(jc.save_dir) == 7
    state, source = load_serving_state(tc, device="cpu")
    assert source == path and state.step == 7
    flat = flat_params(variables)
    back = params_to_flat(state.params)
    for name, value in flat.items():
        np.testing.assert_array_equal(back[name], value, err_msg=name)
    assert latest_checkpoint(tc.save_dir) == jax_latest_checkpoint(jc.save_dir) == path
    # an explicit model_file is loaded as-is
    assert load_serving_state(tc, model_file=path, device="cpu")[1] == path


def test_walk_back_past_a_rotted_checkpoint(jax_save_dir):
    jc, tc, path, _ = jax_save_dir
    newer = os.path.join(jc.save_dir, "9.npz")
    with open(path, "rb") as f:
        data = bytearray(f.read())
    data[len(data) // 2] ^= 0xFF
    with open(newer, "wb") as f:
        f.write(bytes(data))
    # no pointer: the newest checkpoint that verifies wins, and 9.npz
    # fails its zip CRC check
    os.remove(os.path.join(jc.save_dir, "LAST_GOOD"))
    state, source = load_serving_state(tc, device="cpu")
    assert source == path and state.step == 7


def test_vocabulary_mismatch_fails_fast(jax_save_dir, tmp_path):
    jc, tc, path, _ = jax_save_dir
    other = Vocabulary(jc.vocabulary_size)
    other.build(["completely different words here."])
    other.save(tc.vocabulary_file)
    with pytest.raises(VocabMismatchError, match="vocab mismatch"):
        load_serving_state(tc, device="cpu")


def test_empty_checkpoint_restores_zero_tensors(tmp_path):
    _, tc = configs(save_dir=str(tmp_path), vocabulary_file=str(tmp_path / "none.csv"))
    np.savez(str(tmp_path / "3.npz"), global_step=np.int32(3))
    with pytest.raises(ValueError, match="restored 0 tensors"):
        load_serving_state(tc, device="cpu")
