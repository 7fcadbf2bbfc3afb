"""The port's optimizer (optax semantics on dicts of tensors) held against
sat_tpu's optax chain: the same parameters and the same numpy gradients
over 5 steps give the same parameters and slots within 1e-6, under the
same flat checkpoint names."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sat_tpu.train.checkpoint import flatten_with_names
from sat_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from sat_tpu_torch.train.checkpoint import named_leaves
from sat_tpu_torch.train.optimizer import make_optimizer
from tests.torch_port_helpers import configs

torch.set_num_threads(2)

OPTIMIZERS = {
    "adam": dict(optimizer="Adam"),
    "rmsprop": dict(optimizer="RMSProp", centered=False, momentum=0.0),
    "rmsprop_centered_momentum": dict(optimizer="RMSProp", centered=True, momentum=0.9),
    "momentum": dict(optimizer="Momentum", momentum=0.9, use_nesterov=False),
    "nesterov": dict(optimizer="Momentum", momentum=0.9, use_nesterov=True),
    "sgd": dict(optimizer="SGD"),
}
# every step's gradients have global norm 1: clipped just above, not just below
CLIPS = {"off": 0.0, "norm_above": 0.999, "norm_below": 1.001}
DECAYS = {"constant": dict(), "staircase": dict(learning_rate_decay_factor=0.5, num_steps_per_decay=2)}

SHAPES = {"decoder": {"attend": {"fc_1a": {"kernel": (6, 5), "bias": (5,)}},
                      "word_embedding": {"weights": (7, 3)}}}


def _tree(shapes, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(k, v) for k, v in shapes.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {f"{prefix}{k}": v})
    return out


@pytest.mark.parametrize(
    "opt,clip,decay", list(itertools.product(sorted(OPTIMIZERS), sorted(CLIPS), sorted(DECAYS)))
)
def test_optimizer_matches_optax_over_five_steps(opt, clip, decay):
    jc, tc = configs(
        initial_learning_rate=0.01, clip_gradients=CLIPS[clip], **OPTIMIZERS[opt], **DECAYS[decay]
    )
    rng = np.random.default_rng(0)
    init = _tree(SHAPES, lambda k, s: rng.normal(size=s).astype(np.float32))
    grads = []
    for _ in range(5):
        g = _tree(SHAPES, lambda k, s: rng.normal(size=s).astype(np.float32))
        norm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in _flat(g).values()))
        grads.append(jax.tree.map(lambda v: (v / norm).astype(np.float32), g))

    jopt = jax_make_optimizer(jc)
    jparams = jax.tree.map(jnp.asarray, init)
    jstate = jopt.init(jparams)
    for g in grads:
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)

    optimizer = make_optimizer(tc)
    params = jax.tree.map(lambda v: torch.from_numpy(v.copy()), init)
    state = optimizer.init(params)
    norms = [optimizer.step(params, jax.tree.map(torch.from_numpy, g), state) for g in grads]

    np.testing.assert_allclose([float(n) for n in norms], 1.0, rtol=1e-6)
    for name, want in _flat(jax.tree.map(np.asarray, jparams)).items():
        np.testing.assert_allclose(_flat(params)[name].numpy(), want, rtol=1e-6, atol=1e-6, err_msg=name)

    want_slots = {k: np.asarray(v) for k, v in flatten_with_names(jstate, "optimizer/").items()}
    got_slots = {name: t.numpy() for name, t, _ in named_leaves(state, "optimizer/")}
    assert sorted(got_slots) == sorted(want_slots)
    for name, want in want_slots.items():
        assert got_slots[name].dtype == want.dtype, name
        np.testing.assert_allclose(got_slots[name], want, rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_slot_names_are_the_jax_checkpoint_names(opt):
    """``state_to_flat`` of the JAX package and the port's name every slot
    alike for the flagship settings (clip 5, Adam 1e-4) of each optimizer."""
    from sat_tpu.train.checkpoint import state_to_flat as jax_state_to_flat
    from sat_tpu.train.step import TrainState as JaxTrainState

    jc, tc = configs(**OPTIMIZERS[opt])
    init = _tree(SHAPES, lambda k, s: np.zeros(s, np.float32))
    jparams = jax.tree.map(jnp.asarray, init)
    jstate = JaxTrainState(params=jparams, batch_stats={}, opt_state=jax_make_optimizer(jc).init(jparams),
                           step=jnp.zeros((), jnp.int32))
    want = sorted(k for k in jax_state_to_flat(jstate) if k.startswith("optimizer/"))
    params = jax.tree.map(lambda v: torch.from_numpy(v.copy()), init)
    got = sorted(name for name, _, _ in named_leaves(make_optimizer(tc).init(params), "optimizer/"))
    assert got == want
    slots = {
        "adam": ["1/0/count", "1/0/mu", "1/0/nu"],
        "rmsprop": ["1/0/nu", "1/2/trace"],
        "rmsprop_centered_momentum": ["1/0/mu", "1/0/nu", "1/2/trace"],
        "momentum": ["1/0/trace"],
        "nesterov": ["1/0/trace"],
        "sgd": [],
    }[opt]
    assert sorted({"/".join(n.split("/")[1:4]) for n in got}) == slots
