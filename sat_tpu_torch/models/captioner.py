"""Image → context grid at inference — the port of ``sat_tpu.models.captioner.encode``.

Only the serving half of the JAX module: no training, no activity
collection, no BN state (VGG16 has none).  The quantized encoder
(``encoder_quant``) and ResNet50 are later slices of the port and raise
here.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..config import Config
from ..data.images import ILSVRC_2012_MEAN
from .vgg16 import vgg16


def check_encoder(config: Config) -> None:
    """Raise on encoder knobs this slice of the port does not implement."""
    if config.cnn != "vgg16":
        raise NotImplementedError(
            f"cnn={config.cnn!r} is not ported yet (only 'vgg16')"
        )
    if config.encoder_quant != "off":
        raise NotImplementedError(
            f"encoder_quant={config.encoder_quant!r} is not ported yet "
            "(only 'off')"
        )


def encode(
    params: Dict[str, Any], config: Config, images: torch.Tensor
) -> torch.Tensor:
    """images [B, S, S, 3] → contexts [B, N, D] float32, on ``images``' device.

    A uint8 batch is the raw RGB feed: it becomes ``float32 − ILSVRC mean``
    on the device, the JAX package's device-side preprocessing tail.  The
    CNN then runs in ``config.compute_dtype``.  cuDNN would run float32
    convolutions in TF32; at float32 its TF32 switch (process-wide) is
    off for the length of the call, so float32 means float32 on the card."""
    check_encoder(config)
    if images.dtype == torch.uint8:
        mean = torch.as_tensor(ILSVRC_2012_MEAN, device=images.device)
        images = images.float() - mean
    dtype = getattr(torch, config.compute_dtype)
    if dtype != torch.float32 or not images.is_cuda:
        return vgg16(params["cnn"], images, dtype)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return vgg16(params["cnn"], images, dtype)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
