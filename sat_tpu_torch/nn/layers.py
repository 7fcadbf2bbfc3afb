"""NN primitives — the port of ``sat_tpu.nn.layers``: the encoder's SAME
conv and max pool, batch norm, inverted dropout and the L2 regularization
sum.

These functions take NCHW tensors (any memory format; the encoder keeps
``channels_last``).  Padding follows Flax's ``padding="SAME"``, which is
asymmetric when the total is odd (the extra row/column goes last) — torch's
``padding='same'`` refuses stride > 1, so the pads are computed here once
and applied explicitly.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def same_padding(
    size: Sequence[int], kernel: Sequence[int], strides: Sequence[int]
) -> Tuple[Tuple[int, int], ...]:
    """Per spatial dim, the (low, high) pads of XLA's SAME rule: output
    ``ceil(in / stride)``, total ``max((out-1)*stride + k - in, 0)``, low
    half rounded down."""
    pads = []
    for n, k, s in zip(size, kernel, strides):
        out = -(-n // s)
        total = max((out - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def _apply(x: torch.Tensor, pads, value: float):
    """Symmetric pads go to the op itself (returned); asymmetric ones are
    applied here with ``value`` and the op gets no padding."""
    if all(lo == hi for lo, hi in pads):
        return x, tuple(lo for lo, _ in pads)
    (hl, hh), (wl, wh) = pads
    return F.pad(x, (wl, wh, hl, hh), value=value), (0, 0)


def pad_same(x: torch.Tensor, kernel: Sequence[int], stride: int, value: float):
    """(input, padding) for an op with ``kernel`` and ``stride`` under the
    SAME rule: asymmetric pads applied here with ``value``, symmetric ones
    returned for the op to apply."""
    return _apply(x, same_padding(x.shape[-2:], kernel, (stride, stride)), value)


def conv2d_same(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    stride: int = 1,
    relu: bool = True,
) -> torch.Tensor:
    """SAME-padded conv with OIHW ``weight``, in ``x``'s dtype.

    As in Flax's ``nn.Conv`` with ``dtype=compute_dtype``, the bias (none
    for ResNet50's convs but conv1) is added to the conv output in the
    compute dtype (not fused into the conv's fp32 accumulator), then
    relu."""
    x, padding = pad_same(x, weight.shape[-2:], stride, 0.0)
    y = F.conv2d(x, weight, None, stride, padding)
    if bias is not None:
        y.add_(bias.view(1, -1, 1, 1))
    if relu:
        y.relu_()
    return y


def max_pool2d(
    x: torch.Tensor, pool_size: int = 2, strides: int = 2
) -> torch.Tensor:
    """SAME-padded max pool (pads are -inf, as XLA's reduce_window)."""
    x, padding = pad_same(x, (pool_size, pool_size), strides, float("-inf"))
    return F.max_pool2d(x, pool_size, strides, padding)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout, ``where(mask, x / keep, 0)`` with a keep mask drawn
    from ``generator`` (which must live on ``x``'s device).  The JAX
    package's ``dropout``; ``F.dropout`` takes no generator, so a resumed
    run could not replay its masks."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


def regularization_loss(params, fc_scale: float, conv_scale: float, train_cnn: bool) -> torch.Tensor:
    """0.5 · scale · Σw² per kernel — TF's l2_regularizer, as the JAX
    package accounts it: rank-2 ``kernel``/``embedding``/``weights`` leaves
    are fc kernels; rank-4 conv ``weight`` leaves count only when the CNN
    trains; anything under ``lstm`` and every bias never counts."""
    terms = []

    def walk(node, path):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, f"{path}/{key}")
                continue
            if "lstm" in f"{path}/{key}".lower():
                continue
            if key not in ("kernel", "embedding", "weights", "weight"):
                continue
            w = value.float()
            if w.dim() == 4:
                if train_cnn and conv_scale > 0:
                    terms.append(0.5 * conv_scale * (w * w).sum())
            elif w.dim() >= 2 and fc_scale > 0:
                terms.append(0.5 * fc_scale * (w * w).sum())

    walk(params, "")
    if not terms:
        return torch.zeros((), device=next(_leaves(params)).device)
    return sum(terms[1:], terms[0])


def _leaves(node):
    for value in node.values():
        if isinstance(value, dict):
            yield from _leaves(value)
        else:
            yield value


BN_EPSILON = 1e-3    # TF1's batch-norm defaults, as the JAX package's ResNet50 sets them
BN_MOMENTUM = 0.99


def batch_norm(
    x: torch.Tensor,
    params: Dict[str, torch.Tensor],
    stats: Dict[str, torch.Tensor],
    train: bool = False,
):
    """Flax's ``nn.BatchNorm`` over NCHW ``x`` (per channel), returning
    ``(y, new_stats)``.

    Inference uses the running ``stats`` (``mean``, ``var``) and returns
    ``new_stats=None``.  Training normalizes with the batch's statistics,
    taken in float32 (at least) as Flax's fast variance does (``E[x²] − E[x]²``,
    biased, clipped at 0), and returns the running update ``0.99·ra +
    0.01·batch`` (no gradient).  Either way ``(x − mean)·(rsqrt(var + ε)·
    scale) + bias`` runs in float32 (at least) and is cast back to ``x``'s
    dtype."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    new_stats = None
    if train:
        mean = xf.mean(dim=(0, 2, 3))
        var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
        new_stats = {
            "mean": BN_MOMENTUM * stats["mean"] + (1.0 - BN_MOMENTUM) * mean.detach(),
            "var": BN_MOMENTUM * stats["var"] + (1.0 - BN_MOMENTUM) * var.detach(),
        }
    else:
        mean, var = stats["mean"], stats["var"]
    mul = torch.rsqrt(var + BN_EPSILON) * params["scale"]
    y = (xf - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) + params["bias"].view(1, -1, 1, 1)
    return y.to(x.dtype), new_stats
