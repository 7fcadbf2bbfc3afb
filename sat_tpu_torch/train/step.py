"""Training and eval-loss steps — the port of ``sat_tpu.train.step``.

A train step is the encoder forward (frozen under ``torch.no_grad``
unless ``train_cnn``), the teacher-forced decode, the loss, autograd's
backward over the trainable leaves only, then the optax chain
(``train.optimizer``) updating parameters and slots in place.  It syncs
nothing with the host: its metrics stay device tensors until the caller
fetches them.

ResNet50's running statistics ride in ``TrainState.batch_stats``, out of
the optimizer: with ``train_cnn`` a step's forward returns their update
and the step copies it in place; with a frozen CNN they never change.

The eval-loss step runs the same loss without dropout under
``torch.no_grad`` (batch norms on the running statistics); its attention
goes through the fused kernel on the card (the kernel has no backward,
and this step needs none).
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..models.captioner import compute_loss, init_variables
from ..parallel.collectives import MAX, all_reduce_, flat_all_reduce_
from ..parallel.mesh import SINGLE
from ..parallel.sharding import grad_norm_sq
from ..utils.dist import gather_tree_replicated
from .optimizer import _leaves, make_optimizer

Tree = Dict[str, Any]


class TrainState(NamedTuple):
    params: Tree              # {"cnn", "decoder"}, the params_from_flat layout, float32
    batch_stats: Tree         # ResNet50's running statistics; {} for VGG16
    opt_state: List[Any]      # optax's chain state over the trainable sub-dict
    step: int                 # global step


def split_trainable(params: Tree, config: Config) -> Tuple[Tree, Tree]:
    """(trainable, frozen): the CNN is frozen unless ``train_cnn``."""
    if config.train_cnn:
        return dict(params), {}
    return {"decoder": params["decoder"]}, {"cnn": params["cnn"]}


def _like(tree: Tree, leaves) -> Tree:
    """``leaves`` (in :func:`_leaves` order) in ``tree``'s structure."""
    it = iter(leaves)

    def build(node):
        return {k: build(v) if isinstance(v, dict) else next(it) for k, v in node.items()}

    return build(tree)


def state_from_params(
    params: Tree, config: Config, step: int = 0, batch_stats: Optional[Tree] = None
) -> TrainState:
    """A train state over ``params`` (and ``batch_stats``) with fresh
    optimizer slots; the trainable leaves require grad, the frozen ones
    do not."""
    trainable, frozen = split_trainable(params, config)
    for leaf in _leaves(frozen):
        leaf.requires_grad_(False)
    for leaf in _leaves(trainable):
        leaf.requires_grad_(True)
    return TrainState(
        params=params, batch_stats=batch_stats or {},
        opt_state=make_optimizer(config).init(trainable), step=step,
    )


def create_train_state(config: Config, generator: torch.Generator, device="cpu") -> TrainState:
    """Random parameters and initial statistics (``captioner.init_variables``,
    drawn from the CPU ``generator``) on ``device``, and fresh slots."""
    params, batch_stats = init_variables(config, generator, device)
    return state_from_params(params, config, batch_stats=batch_stats)


def model_inputs(state: TrainState) -> Tree:
    """The params tree ``compute_loss`` takes: the parameters, with the
    running statistics beside them when the model has any."""
    return {**state.params, "batch_stats": state.batch_stats} if state.batch_stats else state.params


def _attention_metrics(att: torch.Tensor, groups=()) -> Dict[str, torch.Tensor]:
    """``attention/mean|std|max`` over the global [B, N]: on a mesh each
    rank holds a block, and its sums and max are reduced over ``groups``
    (None where the axis is whole)."""
    att = att.float()
    sums = torch.stack([att.sum(), torch.full((), att.numel(), dtype=torch.float32, device=att.device)])
    peak = att.max()
    for group in groups:
        all_reduce_(sums, group)
        all_reduce_(peak, group, MAX)
    mean = sums[0] / sums[1]
    squares = ((att - mean) ** 2).sum()
    for group in groups:
        all_reduce_(squares, group)
    return {"attention/mean": mean, "attention/std": torch.sqrt(squares / sums[1]), "attention/max": peak}


@torch.no_grad()
def _copy_into(dst: Tree, src: Tree) -> None:
    for key, value in src.items():
        if isinstance(value, dict):
            _copy_into(dst[key], value)
        else:
            dst[key].copy_(value)


def make_train_step(config: Config, mesh=None):
    """Returns ``train_step(state, batch, generator) -> (state, metrics)``.

    ``batch``: images, word_idxs, masks on the params' device;
    ``generator``: the dropout generator, on the same device.  Parameters
    and slots are updated in place; the returned state carries step + 1.
    Metrics: the five losses and accuracy, ``grad_norm`` (before the
    clip) and ``attention/mean|std|max``, as 0-d device tensors, plus, on
    each step that ends a ``log_every`` interval (the steps whose metrics
    the loop fetches), the ``diag/*`` taps of ``diag_level``
    (``telemetry.device``).  With
    ``train_cnn``, ResNet50's running statistics take the forward's
    update, in place.

    ``mesh`` (``parallel.mesh.Mesh``): the step of this rank
    (``parallel.train``): its rows and blocks in, the loss's global
    normalization (``compute_loss(mesh=)``), the gradients summed over
    the data group in one bucketed ``all_reduce`` before the clip, the
    clip's norm over the whole arrays, the metrics global.  Without a
    mesh each of these collectives is the identity."""
    optimizer = make_optimizer(config)
    mesh = mesh or SINGLE
    cp = config.context_parallel > 1
    # the groups over which a rank's attentions [B, N] are a block
    att_groups = (mesh.group("data"), mesh.group("model") if cp else None)
    # the taps are read only where the loop fetches the metrics (every
    # log_every-th step); on the other steps they would cost host time for
    # values nobody reads, so those steps run without them
    untapped = config.replace(diag_level="off")

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor], generator: torch.Generator):
        trainable, _ = split_trainable(state.params, config)
        leaves = _leaves(trainable)
        tapped = config.diag_level != "off" and (state.step + 1) % config.log_every == 0
        total, aux = compute_loss(
            model_inputs(state), config if tapped else untapped, batch, generator, train=True, mesh=mesh,
        )
        grads = torch.autograd.grad(total, leaves)
        flat_all_reduce_(list(grads), mesh.group("data"))  # the one gradient bucket
        updates = [] if tapped else None
        grad_norm = optimizer.step(trainable, _like(trainable, grads), state.opt_state, updates,
                                   norm_sq=grad_norm_sq(trainable, config, mesh))
        if aux["batch_stats"] is not None:
            _copy_into(state.batch_stats, aux["batch_stats"])
        metrics = {k: v.detach() for k, v in aux["metrics"].items()}
        metrics["grad_norm"] = grad_norm
        metrics.update(_attention_metrics(aux["attentions"].detach(), att_groups))
        if updates is not None:
            # update-side diag taps: merged into the metrics, so they ride
            # the loop's one log_every fetch; the norms over the whole arrays
            from ..telemetry.device import grad_taps

            grads, updates, params = (gather_tree_replicated(t, config, mesh) for t in (
                _like(trainable, grads), _like(trainable, updates), trainable))
            metrics.update(grad_taps(config.diag_level, grads=grads, updates=updates, params=params))
        return state._replace(step=state.step + 1), metrics

    return train_step


def make_eval_loss_step(config: Config):
    """Returns ``eval_step(state, batch) -> metrics``: the loss without
    dropout and without an update, under ``torch.no_grad``."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        _, aux = compute_loss(model_inputs(state), config, batch, generator=None, train=False)
        return aux["metrics"]

    return eval_step


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The dropout generator of global step ``step``: seeded from
    (``seed`` + 1, ``step``), as ``jax.random.fold_in(root, step)`` keys the
    JAX package's steps, so a resumed run replays the same masks.

    ``rng_impl`` is accepted and has no effect: it picks JAX's random-bit
    generator, and torch draws dropout masks with its own (Philox on the
    card), so the port's masks never equal the JAX package's bits."""
    value = int(np.random.SeedSequence((seed + 1, step)).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(value)
