"""Shared set-up of the tests that hold sat_tpu_torch against sat_tpu.

Both packages get the same inputs: weights from
``sat_tpu.models.init_variables`` passed through the port's bridge, and
images and activations made with numpy from a seed.  Sizes are the small
model of ``tests/test_runtime.py`` at ``compute_dtype="float32"``, where
the two packages differ only in summation order.  Torch runs on 2 threads
so the port's tests leave the CPU to the rest of the suite.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import torch

from sat_tpu.config import Config as JaxConfig
from sat_tpu.models import init_variables
from sat_tpu.train.checkpoint import flatten_with_names
from sat_tpu_torch.config import Config
from sat_tpu_torch.train.checkpoint import params_from_flat

torch.set_num_threads(2)

# tests/test_runtime.py's SMALL_MODEL dims (image 32 px → N = 4)
SMALL_MODEL = dict(
    image_size=32,
    dim_embedding=16,
    num_lstm_units=16,
    dim_initialize_layer=16,
    dim_attend_layer=16,
    dim_decode_layer=32,
    compute_dtype="float32",
    vocabulary_size=50,
    max_caption_length=8,
)


def configs(**kw):
    """The same settings as a (sat_tpu Config, sat_tpu_torch Config) pair."""
    settings = {**SMALL_MODEL, **kw}
    return JaxConfig(**settings), Config(**settings)


# the Config fields param init reads; the rest (paths, beam, kernels)
# must not cost a recompile of init_variables
_INIT_FIELDS = (
    "cnn", "image_size", "dim_embedding", "num_lstm_units",
    "num_initialize_layers", "dim_initialize_layer", "num_attend_layers",
    "dim_attend_layer", "num_decode_layers", "dim_decode_layer",
    "vocabulary_size", "fc_kernel_initializer_scale", "compute_dtype",
)


@functools.lru_cache(maxsize=None)
def _init(jc: JaxConfig, seed: int):
    return jax.jit(init_variables, static_argnums=1)(jax.random.PRNGKey(seed), jc)


def jax_variables(jc: JaxConfig, seed: int = 0):
    """``init_variables`` under one jit (eager init compiles op by op),
    computed once per architecture and seed."""
    return _init(JaxConfig(**{k: getattr(jc, k) for k in _INIT_FIELDS}), seed)


def flat_params(variables) -> dict:
    """The checkpoint's flat ``params/...`` names → numpy arrays."""
    return {k: np.asarray(v) for k, v in flatten_with_names(variables["params"], "params/").items()}


def port_params(jc: JaxConfig, tc: Config, seed: int = 0):
    """(jax variables, port params on the CPU) with the same weights."""
    variables = jax_variables(jc, seed)
    return variables, params_from_flat(flat_params(variables), tc, "cpu")


def to_torch(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))
