"""ResNet50 encoder → [B, N, 2048] context grid — the port of ``sat_tpu.models.resnet50``.

conv1 (7×7/2, with a bias) + batch norm + relu + a 3×3/2 SAME max pool,
then the bottleneck stages res2 (a..c), res3 (a..d), res4 (a..f) and res5
(a..c).  A stage's first block has a projection shortcut (``branch1``;
res2a at stride 1, the others at stride 2, taken by ``branch1`` and
``branch2a``); the rest an identity shortcut.  res5c's map is reshaped to
the context grid (49 rows at 224 px).  The convs other than conv1 carry
no bias.

Parameters use the JAX package's names and nesting: ``cnn["conv1"]``,
``cnn["bn_conv1"]``, and per block ``cnn["res2a"]["res2a_branch2a"]``
(``weight`` OIHW) and ``cnn["res2a"]["bn2a_branch2a"]`` (``scale``,
``bias``); the running statistics are a second tree of the same nesting,
``batch_stats["res2a"]["bn2a_branch2a"]`` (``mean``, ``var``).  As in
``vgg16``, images come in NHWC and the convs run NCHW-shaped tensors in
``channels_last`` memory in the compute dtype.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from ..nn.layers import batch_norm, conv2d_same, max_pool2d

DIM_CTX = 2048

# (stage prefix, bottleneck width, identity blocks, first block's stride)
STAGES = [
    ("2", 64, 2, 1),
    ("3", 128, 3, 2),
    ("4", 256, 5, 2),
    ("5", 512, 2, 2),
]


def blocks() -> Iterator[Tuple[str, str, int, int, bool]]:
    """(block name, stage tag, width, stride, projection) of the 16
    bottleneck blocks in order, e.g. ("res3a", "3a", 128, 2, True)."""
    for prefix, width, n_identity, stride in STAGES:
        yield f"res{prefix}a", f"{prefix}a", width, stride, True
        for i in range(n_identity):
            st = f"{prefix}{chr(ord('b') + i)}"
            yield f"res{st}", st, width, 1, False


def conv_specs() -> Iterator[Tuple[str, str, str, int, int, int, int]]:
    """(block, conv name, batch-norm name, kernel size, in, out, stride) of
    every conv in order; ``block`` is "" for conv1, which sits at the top."""
    yield "", "conv1", "bn_conv1", 7, 3, 64, 2
    cin = 64
    for block, st, width, stride, projection in blocks():
        if projection:
            yield block, f"res{st}_branch1", f"bn{st}_branch1", 1, cin, 4 * width, stride
        yield block, f"res{st}_branch2a", f"bn{st}_branch2a", 1, cin, width, stride
        yield block, f"res{st}_branch2b", f"bn{st}_branch2b", 3, width, width, 1
        yield block, f"res{st}_branch2c", f"bn{st}_branch2c", 1, width, 4 * width, 1
        cin = 4 * width


def resnet50(
    cnn: Dict[str, Any],
    batch_stats: Dict[str, Any],
    images: torch.Tensor,
    dtype: torch.dtype,
    train: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """images [B, H, W, 3] float32 (mean-subtracted) → (contexts [B, N,
    2048] float32, new batch statistics).

    ``train`` (the CNN is training): batch norms normalize with the
    batch's statistics and the second value is the updated running
    statistics, in ``batch_stats``' nesting; otherwise they use
    ``batch_stats`` and the second value is None."""
    new_stats: Optional[Dict[str, Any]] = {} if train else None

    def conv_bn(block: str, conv: str, bn: str, x, stride=1, relu=False):
        p = cnn[block] if block else cnn
        s = batch_stats[block] if block else batch_stats
        w = p[conv]
        y = conv2d_same(x, w["weight"].to(dtype), w["bias"].to(dtype) if "bias" in w else None,
                        stride, relu=False)
        y, new = batch_norm(y, p[bn], s[bn], train)
        if train:
            (new_stats.setdefault(block, {}) if block else new_stats)[bn] = new
        return y.relu_() if relu else y

    # the NCHW view of contiguous NHWC memory is already channels_last
    x = images.permute(0, 3, 1, 2).to(dtype)
    x = conv_bn("", "conv1", "bn_conv1", x, stride=2, relu=True)
    x = max_pool2d(x, 3, 2)
    for block, st, _width, stride, projection in blocks():
        shortcut = conv_bn(block, f"res{st}_branch1", f"bn{st}_branch1", x, stride) if projection else x
        y = conv_bn(block, f"res{st}_branch2a", f"bn{st}_branch2a", x, stride, relu=True)
        y = conv_bn(block, f"res{st}_branch2b", f"bn{st}_branch2b", y, relu=True)
        y = conv_bn(block, f"res{st}_branch2c", f"bn{st}_branch2c", y)
        x = (shortcut + y).relu_()
    b = x.shape[0]
    return x.permute(0, 2, 3, 1).reshape(b, -1, DIM_CTX).float(), new_stats


def quant_forward(conv, images: torch.Tensor) -> torch.Tensor:
    """The topology walker of the quantized encoder (``nn.quant``): the
    graph above with every (conv, batch norm) pair folded into one
    ``conv(name, x, stride=1, relu=False)`` of the chosen precision;
    residual adds and relus run at that conv's output precision.
    ``images`` NHWC float32 → contexts [B, N, 2048] float32."""
    x = conv("conv1", images.permute(0, 3, 1, 2), stride=2, relu=True)
    x = max_pool2d(x, 3, 2)
    for _block, st, _width, stride, projection in blocks():
        shortcut = conv(f"res{st}_branch1", x, stride=stride) if projection else x
        y = conv(f"res{st}_branch2a", x, stride=stride, relu=True)
        y = conv(f"res{st}_branch2b", y, relu=True)
        y = conv(f"res{st}_branch2c", y)
        x = torch.relu(shortcut + y)
    b = x.shape[0]
    return x.permute(0, 2, 3, 1).reshape(b, -1, DIM_CTX).float()
