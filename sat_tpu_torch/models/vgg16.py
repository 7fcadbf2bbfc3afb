"""VGG16 encoder → [B, N, 512] context grid — the port of ``sat_tpu.models.vgg16``.

13 SAME-padded 3×3 convs (relu) named ``conv1_1 … conv5_3``, a 2×2/2 max
pool after each of the first four blocks, conv5_3's map reshaped to the
context grid (196 rows at 224 px).  Images come in NHWC, as in the JAX
package; inside, the convs run NCHW-shaped tensors in ``channels_last``
memory through cuDNN (``F.conv2d``) in the compute dtype.  The map goes
back to NHWC before the reshape, so context row ``n`` is spatial position
``(n // W, n % W)`` — the JAX package's row-major order.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..nn.layers import conv2d_same, max_pool2d

# (name, features, pool_after)
VGG_LAYERS = [
    ("conv1_1", 64, False), ("conv1_2", 64, True),
    ("conv2_1", 128, False), ("conv2_2", 128, True),
    ("conv3_1", 256, False), ("conv3_2", 256, False), ("conv3_3", 256, True),
    ("conv4_1", 512, False), ("conv4_2", 512, False), ("conv4_3", 512, True),
    ("conv5_1", 512, False), ("conv5_2", 512, False), ("conv5_3", 512, False),
]

DIM_CTX = 512


def vgg16(
    cnn: Dict[str, Dict[str, torch.Tensor]],
    images: torch.Tensor,
    dtype: torch.dtype,
    with_activity: bool = False,
):
    """images [B, H, W, 3] float32 (mean-subtracted) → contexts [B, N, 512]
    float32.  ``cnn[name]`` holds ``weight`` (OIHW) and ``bias``.

    ``with_activity``: also return Σ|relu output| over the 13 convs (the
    conv L1 activity the JAX package's ``Conv`` sows), as (contexts, l1)."""
    # the NCHW view of contiguous NHWC memory is already channels_last
    x = images.permute(0, 3, 1, 2).to(dtype)
    activity = []
    for name, _features, pool_after in VGG_LAYERS:
        p = cnn[name]
        x = conv2d_same(x, p["weight"].to(dtype), p["bias"].to(dtype))
        if with_activity:
            activity.append(x.float().abs().sum())
        if pool_after:
            x = max_pool2d(x)
    b = x.shape[0]
    contexts = x.permute(0, 2, 3, 1).reshape(b, -1, DIM_CTX).float()
    return (contexts, sum(activity[1:], activity[0])) if with_activity else contexts


def quant_forward(conv, images: torch.Tensor) -> torch.Tensor:
    """The topology walker of the quantized encoder (``nn.quant``): the
    graph above with each conv a ``conv(name, x, stride=1, relu=False)``
    of the chosen precision.  ``images`` NHWC float32 → contexts
    [B, N, 512] float32."""
    x = images.permute(0, 3, 1, 2)
    for name, _features, pool_after in VGG_LAYERS:
        x = conv(name, x, relu=True)
        if pool_after:
            x = max_pool2d(x)
    b = x.shape[0]
    return x.permute(0, 2, 3, 1).reshape(b, -1, DIM_CTX).float()
