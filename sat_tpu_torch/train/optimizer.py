"""The optimizer — the port of ``sat_tpu.train.optimizer``, with optax's
semantics and optax's state layout, not ``torch.optim``.

``make_optimizer(config)`` builds the JAX package's chain: global-norm
clipping (when ``clip_gradients`` > 0), then Adam, RMSProp (plain or
centered, with a momentum trace), Momentum (plain or Nesterov) or SGD,
each scaled by the learning rate (constant, or a staircase exponential
decay that reads its own ``count``).  Its state is optax's tuple of
states as nested lists and dicts, so its leaves take the names
``train.checkpoint`` writes under ``optimizer/``: Adam
``1/0/count``, ``1/0/mu/<param path>``, ``1/0/nu/...`` (and ``1/1/count``
when the learning rate decays), RMSProp ``1/0/nu`` (centered: also
``1/0/mu``) and ``1/2/trace``, Momentum ``1/0/trace``, SGD none.

Where optax and torch differ, this follows optax:

* ``clip_by_global_norm`` is ``g · max / ‖g‖`` when ‖g‖ ≥ max, with no
  +1e-6 (``torch.nn.utils.clip_grad_norm_`` adds one);
* RMSProp puts ``eps`` inside the square root, and its ``nu`` starts at 0;
* Adam's bias correction counts with its own ``count``;
* RMSProp's momentum trace runs after the learning-rate scale.

:meth:`Optimizer.step` updates parameters and slots in place; callers run
it under ``torch.no_grad``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Union

import torch

from ..config import Config

Tree = Dict[str, Any]


def _leaves(tree: Tree) -> List[torch.Tensor]:
    out = []
    for value in tree.values():
        out.extend(_leaves(value) if isinstance(value, dict) else [value])
    return out


def _zeros_like(tree: Tree) -> Tree:
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v) for k, v in tree.items()}


def _count(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def make_learning_rate(config: Config) -> Union[float, Callable[[torch.Tensor], torch.Tensor]]:
    """A float, or (``learning_rate_decay_factor`` < 1) optax's staircase
    ``exponential_decay`` on an int32 count tensor: ``init ·
    factor ** floor(count / num_steps_per_decay)``, ``init`` at count 0."""
    if config.learning_rate_decay_factor < 1.0:
        init = config.initial_learning_rate
        rate = config.learning_rate_decay_factor
        steps = config.num_steps_per_decay

        def schedule(count: torch.Tensor) -> torch.Tensor:
            p = torch.floor(count.float() / steps)
            return torch.where(count <= 0, torch.full_like(p, init), init * rate ** p)

        return schedule
    return config.initial_learning_rate


class Optimizer:
    """``init(trainable) → state`` and ``step(trainable, grads, state)``.

    ``trainable`` and ``grads`` are nested dicts of tensors of one layout;
    ``state`` is optax's chain state (lists for tuples, dicts for named
    states, ``{}`` for an empty one).  Counts are int32 tensors on the
    parameters' device, so a step never waits on the device."""

    def __init__(self, config: Config):
        if config.optimizer not in ("Adam", "RMSProp", "Momentum", "SGD"):
            raise ValueError(
                f"optimizer={config.optimizer!r}: expected Adam, RMSProp, Momentum or SGD"
            )
        self.name = config.optimizer
        self.config = config
        self.lr = make_learning_rate(config)
        self.clip = config.clip_gradients if config.clip_gradients and config.clip_gradients > 0 else 0.0

    def init(self, trainable: Tree) -> List[Any]:
        device = _leaves(trainable)[0].device
        # the learning-rate scale: a schedule keeps its own count
        lr_state = {"count": _count(device)} if callable(self.lr) else {}
        if self.name == "Adam":
            inner = [
                {"count": _count(device), "mu": _zeros_like(trainable), "nu": _zeros_like(trainable)},
                lr_state,
            ]
        elif self.name == "RMSProp":
            scale = {"nu": _zeros_like(trainable)}
            if self.config.centered:
                scale = {"mu": _zeros_like(trainable), **scale}
            inner = [scale, lr_state, {"trace": _zeros_like(trainable)}]
        elif self.name == "Momentum":
            inner = [{"trace": _zeros_like(trainable)}, lr_state]
        else:
            inner = [{}, lr_state]
        return [{}, inner] if self.clip else [inner]

    def _step_size(self, lr_state):
        """-lr; a schedule reads its count, then advances it."""
        if not callable(self.lr):
            return -self.lr
        size = -self.lr(lr_state["count"])
        lr_state["count"].add_(1)
        return size

    @torch.no_grad()
    def step(self, trainable: Tree, grads: Tree, state: List[Any]) -> torch.Tensor:
        """One update of ``trainable`` and ``state`` in place; returns the
        global norm of ``grads`` before clipping."""
        c = self.config
        params, gs = _leaves(trainable), _leaves(grads)
        norm = torch.sqrt(sum((g * g).sum() for g in gs))
        if self.clip:
            clipped = norm >= self.clip
            gs = [torch.where(clipped, g / norm * self.clip, g) for g in gs]
        inner = state[-1]
        step_size = self._step_size(inner[1])
        if self.name == "Adam":
            adam = inner[0]
            adam["count"].add_(1)
            count = adam["count"].float()
            c1 = 1.0 - c.beta1 ** count
            c2 = 1.0 - c.beta2 ** count
            for p, g, m, v in zip(params, gs, _leaves(adam["mu"]), _leaves(adam["nu"])):
                m.mul_(c.beta1).add_(g, alpha=1.0 - c.beta1)
                v.mul_(c.beta2).add_(g * g, alpha=1.0 - c.beta2)
                p.add_(step_size * ((m / c1) / (torch.sqrt(v / c2) + c.epsilon)))
        elif self.name == "RMSProp":
            # optax.rmsprop: eps inside the root, the momentum trace (never
            # Nesterov here) after the learning-rate scale
            scale, trace = inner[0], inner[2]["trace"]
            mus = _leaves(scale["mu"]) if c.centered else [None] * len(params)
            for p, g, m, v, tr in zip(params, gs, mus, _leaves(scale["nu"]), _leaves(trace)):
                v.mul_(c.decay).add_(g * g, alpha=1.0 - c.decay)
                if m is None:
                    u = g * torch.rsqrt(v + c.epsilon)
                else:
                    m.mul_(c.decay).add_(g, alpha=1.0 - c.decay)
                    u = g * torch.rsqrt(v - m * m + c.epsilon)
                tr.mul_(c.momentum).add_(step_size * u)
                p.add_(tr)
        elif self.name == "Momentum":
            for p, g, tr in zip(params, gs, _leaves(inner[0]["trace"])):
                tr.mul_(c.momentum).add_(g)
                p.add_(step_size * (g + c.momentum * tr if c.use_nesterov else tr))
        else:
            for p, g in zip(params, gs):
                p.add_(step_size * g)
        return norm


def make_optimizer(config: Config) -> Optimizer:
    return Optimizer(config)
