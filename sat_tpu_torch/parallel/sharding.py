"""Placement rules — the port of ``sat_tpu.parallel.sharding``.

One rule places every leaf, as in the JAX package (``_leaf_spec``): a
dimension equal to ``vocabulary_size`` and divisible by the model axis'
size shards over ``model`` — only under a ``word_embedding`` or
``decode`` path, so an unrelated dimension of the same size never
shards — and every other leaf is replicated.  The rule keys on a leaf's
path and shape alone, so it places the parameters and their optimizer
slots (Adam's ``mu``/``nu`` mirror the parameter paths) alike.

A sharded leaf of a rank holds its block of the full array along that
dimension (block ``model index``).  Checkpoints hold full host arrays
always (``utils.dist.gather_tree_replicated`` makes them before a
save), so an elastic resume under another mesh is the same slicing of
the restored full state (:func:`shard_train_state`, as a fresh start).

The port runs the vocab-parallel decode over exactly two shardings: the
embedding table ``[V, E]`` over its rows and the final decode projection
(kernel ``[in, V]`` and bias ``[V]``) over its columns.
:func:`vocab_leaves` raises when the rule would shard any other leaf
(a config whose attention or decode width equals the vocabulary).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from .collectives import all_reduce_

_VOCAB_SHARDED_SCOPES = ("word_embedding", "decode")


def leaf_dim(path: Tuple[str, ...], shape: Tuple[int, ...], config: Config, model_size: int) -> Optional[int]:
    """The dimension of a leaf that shards over ``model``, or None
    (replicated): the JAX package's ``_leaf_spec``."""
    if model_size > 1 and any(key in _VOCAB_SHARDED_SCOPES for key in path):
        for i, d in enumerate(shape):
            if d == config.vocabulary_size and d % model_size == 0:
                return i
    return None


def walk(tree: Any, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(path, tensor) of every tensor leaf under nested dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from walk(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from walk(v, path + (str(i),))
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def _map(tree: Any, fn, path: Tuple[str, ...] = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn, path + (str(i),)) for i, v in enumerate(tree)]
    if isinstance(tree, tuple):
        return tuple(_map(v, fn, path + (str(i),)) for i, v in enumerate(tree))
    if isinstance(tree, torch.Tensor):
        return fn(path, tree)
    return tree


# the leaves (under the decoder params) that the port's vocab-parallel
# decode runs sharded, and the dimension each shards along
_PORT_VOCAB_LEAVES = {
    ("word_embedding", "weights"): 0,
    ("decode", "fc", "kernel"): 1, ("decode", "fc", "bias"): 0,
    ("decode", "fc_2", "kernel"): 1, ("decode", "fc_2", "bias"): 0,
}


def vocab_leaves(decoder_params: Dict[str, Any], config: Config, model_size: int) -> List[Tuple[str, ...]]:
    """The decoder leaves the rule shards; raises when it would shard a
    leaf the port's vocab-parallel decode does not run sharded, or would
    leave one of those replicated."""
    sharded = []
    for path, t in walk(decoder_params):
        dim = leaf_dim(path, tuple(t.shape), config, model_size)
        if dim is None:
            continue
        if _PORT_VOCAB_LEAVES.get(path) != dim:
            raise ValueError(
                f"vocab parallelism over {model_size} ranks would shard decoder/{'/'.join(path)} "
                f"{tuple(t.shape)} along dim {dim}; the port shards only the embedding rows and the "
                "final decode projection's columns (choose layer widths other than vocabulary_size)"
            )
        sharded.append(path)
    last = "fc" if config.num_decode_layers == 1 else "fc_2"
    expected = {("word_embedding", "weights"), ("decode", last, "kernel"), ("decode", last, "bias")}
    if model_size > 1 and set(sharded) != expected:
        raise ValueError(
            f"vocab parallelism over {model_size} ranks needs vocabulary_size={config.vocabulary_size} "
            f"divisible by {model_size}"
        )
    return sharded


def shard_tree(tree: Any, config: Config, mesh) -> Any:
    """``tree`` (full arrays) with every leaf the rule shards replaced by
    a copy of this rank's block (its ``requires_grad`` carried over);
    replicated leaves are the same tensors."""
    size, index = mesh.size("model"), mesh.index("model")

    def cut(path, t):
        dim = leaf_dim(path, tuple(t.shape), config, size)
        if dim is None:
            return t
        width = t.shape[dim] // size
        return t.detach().narrow(dim, index * width, width).clone().requires_grad_(t.requires_grad)

    return _map(tree, cut)


def shard_train_state(state, config: Config, mesh):
    """This rank's train state from a full one: the parameters and the
    optimizer slots cut by the rule; batch statistics and the step as
    they are."""
    if mesh.size("model") == 1:
        return state
    if config.vocabulary_size > 0:
        vocab_leaves(state.params["decoder"], config, mesh.size("model"))
    return state._replace(
        params=shard_tree(state.params, config, mesh),
        opt_state=shard_tree(state.opt_state, config, mesh),
    )


def _decoder_suffix(path: Tuple[str, ...]) -> Tuple[str, ...]:
    """The part of a leaf's path below its last ``decoder`` key (the
    parameter's own path under an optimizer slot too)."""
    if "decoder" not in path:
        return ()
    return path[len(path) - path[::-1].index("decoder"):]


def is_sharded(path: Tuple[str, ...], config: Config, mesh) -> bool:
    """Whether the leaf at ``path`` of this rank's state (a parameter or
    its optimizer slot) is a vocab-sharded block."""
    if mesh.size("model") == 1 or config.vocabulary_size <= 0 or config.context_parallel > 1:
        return False
    last = "fc" if config.num_decode_layers == 1 else "fc_2"
    return _decoder_suffix(path) in {("word_embedding", "weights"), ("decode", last, "kernel"),
                                     ("decode", last, "bias")}


def partition(tree: Dict[str, Any], config: Config, mesh) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(the replicated leaves, the vocab-sharded blocks) of a nested dict
    of tensors, each in its own nested dicts (empty dicts dropped)."""
    def keep(node, path, sharded):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                sub = keep(v, path + (k,), sharded)
                if sub:
                    out[k] = sub
            elif is_sharded(path + (k,), config, mesh) == sharded:
                out[k] = v
        return out

    return keep(tree, (), False), keep(tree, (), True)


def grad_norm_sq(trainable: Dict[str, Any], config: Config, mesh):
    """The optimizer's ``norm_sq`` on ``mesh``: the replicated leaves'
    squared sums, plus the sharded blocks' summed over the model group;
    None when no leaf is sharded (the optimizer's own sum)."""
    sharded = [is_sharded(path, config, mesh) for path, _ in walk(trainable)]
    if not any(sharded):
        return None

    def norm_sq(squares: List[torch.Tensor]) -> torch.Tensor:
        rep = sum(s for s, sh in zip(squares, sharded) if not sh)
        part = torch.stack([s for s, sh in zip(squares, sharded) if sh]).sum()
        return rep + all_reduce_(part, mesh.group("model"))

    return norm_sq


def sharded_dim(path: Tuple[str, ...]) -> int:
    """The vocabulary dimension of a sharded leaf (see :func:`is_sharded`)."""
    return _PORT_VOCAB_LEAVES[_decoder_suffix(path)]


def shard_flat(flat: Dict[str, Any], config: Config, mesh) -> Dict[str, Any]:
    """A checkpoint's flat arrays with every vocab-sharded name cut to this
    rank's block (the decoder's dense kernels and the embedding keep one
    layout on disk and in the port, so the cut is the same)."""
    size, index = mesh.size("model"), mesh.index("model")
    if size == 1:
        return flat
    out = dict(flat)
    for name, value in flat.items():
        path = tuple(name.split("/"))
        dim = leaf_dim(path, tuple(np.shape(value)), config, size)
        if dim is not None:
            width = np.shape(value)[dim] // size
            out[name] = np.take(value, range(index * width, (index + 1) * width), axis=dim)
    return out
