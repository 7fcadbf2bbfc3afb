"""On-device model-health taps (``--diag_level``) — the port of
``sat_tpu.telemetry.device``.

The host-side telemetry (spans, heartbeat) times the run; these taps say
what the model is doing: whether the gradient exploded and in which
layer group, and whether the doubly-stochastic attention term is
flattening the alphas.  Each tap is a 0-d float32 tensor reduced on the
params' device next to the loss or the gradients and merged into the
metrics dict that ``train.step`` already returns, so it rides the one
``log_every`` fetch of ``runtime.train``: no device sync of its own.
Nothing here calls ``.item()``, ``.cpu()`` or ``float()`` on a tensor
(``tests/test_torch_device_diag.py`` checks the source).

Imported by ``models.captioner`` and ``train.step`` only when
``config.diag_level != "off"``, so the off path runs exactly the ops it
ran before the taps existed.

Tap catalogue (all float32 scalars, keys prefixed ``diag/``), the JAX
package's names and levels:

==================================  =====  ==================================
key                                 level  meaning
==================================  =====  ==================================
``diag/param_norm``                 basic  global L2 of the trainable tree
``diag/update_norm``                basic  global L2 of the optimizer update
``diag/update_ratio``               basic  update_norm / param_norm
``diag/attn_entropy``               basic  mean masked per-word attention
                                           entropy H_t = -Σ_i α_ti ln α_ti
``diag/attn_entropy_frac``          basic  attn_entropy / ln N
``diag/alpha_coverage_dev``         basic  mean_{b,i} (1 - Σ_t α_ti)²
``diag/logit_max``                  basic  max |pre-softmax logit|
``diag/grad_nonfinite``             full   count of non-finite grad elements
``diag/grad_norm/<group>``          full   per-layer-group grad L2
``diag/update_norm/<group>``        full   per-layer-group update L2
``diag/param_norm/<group>``         full   per-layer-group param L2
==================================  =====  ==================================
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
import torch.distributed as dist

from ..parallel.collectives import MAX, all_reduce_

DIAG_LEVELS = ("off", "basic", "full")


def _tree_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        out: List[torch.Tensor] = []
        for value in tree.values():
            out.extend(_tree_leaves(value))
        return out
    return [tree]


def _l2(tree) -> torch.Tensor:
    """Global L2 norm of a nested dict of tensors, accumulated in float32."""
    leaves = _tree_leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(sum(torch.sum(torch.square(x.detach().float())) for x in leaves))


def _nonfinite_count(tree) -> torch.Tensor:
    """Total count of non-finite elements across the tree's leaves, as float32."""
    leaves = _tree_leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return sum(torch.sum(~torch.isfinite(x.detach().float())) for x in leaves).float()


def _layer_groups(tree: Dict[str, Any]) -> Dict[str, Any]:
    """Flatten a params-like dict one level: {"decoder": {"lstm": ...}} →
    {"decoder.lstm": ...}, the per-layer-group granularity of the full
    taps.  Non-dict values keep their top-level name."""
    groups: Dict[str, Any] = {}
    for top, sub in tree.items():
        if isinstance(sub, dict) and sub:
            for name, leaf_tree in sub.items():
                groups[f"{top}.{name}"] = leaf_tree
        else:
            groups[top] = sub
    return groups


def attention_entropy(alphas: torch.Tensor, masks: torch.Tensor, rows=None, positions=None) -> torch.Tensor:
    """Mean per-word attention entropy over real (masked-in) words.
    alphas [B, T, N] softmax rows; masks [B, T].  On a mesh ``rows`` is
    the group over which the batch's rows are split and ``positions`` the
    one over which the grid is (context parallelism): the sums are reduced
    over them (each None when unsplit)."""
    a = alphas.float()
    h = all_reduce_(-torch.sum(a * torch.log(torch.clamp(a, 1e-10, 1.0)), dim=-1), positions)  # [B, T]
    m = masks.float()
    sums = all_reduce_(torch.stack([torch.sum(h * m), torch.sum(m)]), rows)
    return sums[0] / torch.clamp(sums[1], min=1.0)


def alpha_coverage_deviation(alphas: torch.Tensor, masks: torch.Tensor, rows=None, positions=None) -> torch.Tensor:
    """mean_{b,i} (1 - Σ_t α_ti)² over masked alphas: the unscaled
    doubly-stochastic attention penalty (``rows``/``positions`` as in
    :func:`attention_entropy`)."""
    a = alphas.float() * masks.float().unsqueeze(-1)
    d = 1.0 - a.sum(dim=1)                                              # [B, N]
    sums = torch.stack([torch.sum(d * d), torch.full((), d.numel(), dtype=torch.float32, device=d.device)])
    sums = all_reduce_(all_reduce_(sums, rows), positions)
    return sums[0] / sums[1]


def loss_taps(
    level: str, *, alphas: torch.Tensor, masks: torch.Tensor, logits: torch.Tensor,
    rows=None, positions=None, columns=None,
) -> Dict[str, torch.Tensor]:
    """Forward-side taps, computed in ``compute_loss`` where the alphas and
    logits are live.  Detached: a tap never reaches the gradient.  On a
    mesh, the groups over which the rows, the grid's positions and the
    logits' columns are split (None where whole): the taps are those of
    the global batch."""
    if level == "off":
        return {}
    alphas, logits = alphas.detach(), logits.detach()
    ent = attention_entropy(alphas, masks, rows, positions)
    n = alphas.shape[-1] * (1 if positions is None else dist.get_world_size(positions))
    peak = torch.max(torch.abs(logits.float()))
    for group in (rows, columns):
        all_reduce_(peak, group, MAX)
    return {
        "diag/attn_entropy": ent,
        "diag/attn_entropy_frac": ent / math.log(n),
        "diag/alpha_coverage_dev": alpha_coverage_deviation(alphas, masks, rows, positions),
        "diag/logit_max": peak,
    }


def grad_taps(
    level: str, *, grads: Dict[str, Any], updates: Dict[str, Any], params: Dict[str, Any]
) -> Dict[str, torch.Tensor]:
    """Backward- and update-side taps, computed in the train step where the
    gradient and update trees are live.  ``params`` is the trainable tree
    after the update."""
    if level == "off":
        return {}
    param_norm = _l2(params)
    update_norm = _l2(updates)
    taps: Dict[str, torch.Tensor] = {
        "diag/param_norm": param_norm,
        "diag/update_norm": update_norm,
        "diag/update_ratio": update_norm / torch.clamp(param_norm, min=1e-12),
    }
    if level == "full":
        taps["diag/grad_nonfinite"] = _nonfinite_count(grads)
        for kind, tree in (("grad_norm", grads), ("update_norm", updates), ("param_norm", params)):
            for group, sub in _layer_groups(tree).items():
                taps[f"diag/{kind}/{group}"] = _l2(sub)
    return taps
