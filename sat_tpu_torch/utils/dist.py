"""Full arrays from sharded leaves — the port of ``sat_tpu.utils.dist``."""

from __future__ import annotations

from typing import Any

from ..config import Config


def gather_tree_replicated(tree: Any, config: Config, mesh) -> Any:
    """``tree`` with every vocab-sharded block (``parallel.sharding.
    is_sharded``) replaced by the full array, in one collective over the
    model group: each block is written into a zero-padded full-width
    buffer and all the buffers are summed together, so the gathers of
    every leaf ride one ``all_reduce`` instead of one a leaf.  Replicated
    leaves pass through untouched; so does everything when the model axis
    has size 1."""
    from ..parallel.collectives import flat_all_reduce_
    from ..parallel.sharding import _map, is_sharded, sharded_dim

    size, index = mesh.size("model"), mesh.index("model")
    if size == 1 or config.vocabulary_size <= 0 or config.context_parallel > 1:
        return tree
    fulls = []

    def pad(path, t):
        if not is_sharded(path, config, mesh):
            return t
        dim = sharded_dim(path)
        shape = list(t.shape)
        width = shape[dim]
        shape[dim] = width * size
        full = t.detach().new_zeros(shape)
        full.narrow(dim, index * width, width).copy_(t.detach())
        fulls.append(full)
        return full

    out = _map(tree, pad)
    flat_all_reduce_(fulls, mesh.group("model"))
    return out
