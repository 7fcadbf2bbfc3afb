"""The mesh's train step and decode — the port of ``sat_tpu.parallel.train``.

The JAX package runs the single-device step under shardings and lets
GSPMD compile the collectives.  Here each rank runs its part of the
step and the collectives are written out in the one step and loss
(``train.step.make_train_step(config, mesh)``,
``models.captioner.compute_loss(mesh=)``), each the identity without a
mesh:

**Data parallelism.**  Each rank takes its rows of the global batch
(``parallel.data``).  Every term of the loss is normalized by the global
count, as GSPMD computes it, the counts coming from an ``all_reduce``
with no gradient.  The gradients are summed with one bucketed
``all_reduce`` over the data group before the optimizer's global-norm
clip.  This is not DDP's gradient mean, which equals it only when every
rank's mask sum is the same.  The weight-L2 term is replicated, so only
data rank 0 puts it into its loss: its gradient counts once.  Dropout
draws the global batch's masks and takes the rank's rows
(``nn.layers.BatchRows``), so a data-parallel run drops what the
single-process run drops.  A training ResNet50's batch-norm moments are
global over the data group (``nn.layers.batch_norm``).

**Vocab tensor parallelism** (``parallel.vocab``): the embedding rows
and the last decode layer's columns split over the model group; the
L2 term of a sharded leaf is summed over the group; the clip's global
norm adds the sharded leaves' squared sums over the group
(``parallel.sharding.grad_norm_sq``).

**Context parallelism** (``parallel.context``) when
``context_parallel`` > 1: the model axis splits the context grid
instead, and the parameters stay replicated.

**Mesh decode** (:func:`mesh_decode_batch`): each data rank encodes its
rows and runs the single-device ``beam_search`` — so the fused attention
kernel runs in every rank — with the logits assembled full-width before
``top_k`` under vocab parallelism (the search identical on every model
rank), or the context-parallel search.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..config import Config
from ..models.captioner import encode
from ..ops.beam_search import BeamResult, beam_search
from .vocab import vocab_parallel


@torch.inference_mode()
def mesh_decode_batch(params: Dict[str, Any], config: Config, images: torch.Tensor, eos_id: int,
                      valid_size: int, mesh, return_alphas: bool = False) -> BeamResult:
    """One batch of this rank's rows: encode, then the beam search of this
    mesh — the single-device search with the vocab-parallel hooks, or the
    context-parallel search (its alphas gathered to the whole grid).
    ``params`` holds this rank's blocks (``sharding.shard_tree``)."""
    contexts = encode(params, config, images)
    kwargs = dict(beam_size=config.beam_size, valid_size=valid_size, return_alphas=return_alphas)
    if config.context_parallel > 1:
        from .context import cp_beam_search, gather_alphas

        out = cp_beam_search(params["decoder"], config, contexts, eos_id, mesh, **kwargs)
        if out.alphas is not None:
            out = out._replace(alphas=gather_alphas(out.alphas, mesh))
        return out
    vocab = vocab_parallel(config, mesh)
    return beam_search(params["decoder"], config, contexts, eos_id, vocab=vocab, **kwargs)


def place_params(params: Dict[str, Any], config: Config, mesh) -> Dict[str, Any]:
    """Decode params on this mesh: the vocab rule's blocks (the params of a
    context-parallel run stay replicated)."""
    from .sharding import shard_tree

    if vocab_parallel(config, mesh) is None:
        return params
    return shard_tree(params, config, mesh)

