"""NN primitives of the encoder — the port of ``sat_tpu.nn.layers``' inference
half (``Conv``, ``max_pool2d``).

These functions take NCHW tensors (any memory format; the encoder keeps
``channels_last``).  Padding follows Flax's ``padding="SAME"``, which is
asymmetric when the total is odd (the extra row/column goes last) — torch's
``padding='same'`` refuses stride > 1, so the pads are computed here once
and applied explicitly.
"""

from __future__ import annotations

from typing import Sequence, Tuple

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


def conv2d_same(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    stride: int = 1,
    relu: bool = True,
) -> torch.Tensor:
    """SAME-padded conv with OIHW ``weight``, in ``x``'s dtype.

    As in Flax's ``nn.Conv`` with ``dtype=compute_dtype``, the bias is
    added to the conv output in the compute dtype (not fused into the
    conv's fp32 accumulator), then relu."""
    pads = same_padding(x.shape[-2:], weight.shape[-2:], (stride, stride))
    x, padding = _apply(x, pads, 0.0)
    y = F.conv2d(x, weight, None, stride, padding)
    y.add_(bias.view(1, -1, 1, 1))
    if relu:
        y.relu_()
    return y


def max_pool2d(
    x: torch.Tensor, pool_size: int = 2, strides: int = 2
) -> torch.Tensor:
    """SAME-padded max pool (pads are -inf, as XLA's reduce_window)."""
    pads = same_padding(x.shape[-2:], (pool_size, pool_size), (strides, strides))
    x, padding = _apply(x, pads, float("-inf"))
    return F.max_pool2d(x, pool_size, strides, padding)
