"""Everything a run feeds the program, made from ``--seed``: the weights
(one flat dict under the checkpoint's names, handed to the program and to
the reference alike) and the images.

Weights are drawn on the device in one call, in the distributions of the
model's random initialization: conv kernels glorot-uniform, dense kernels,
the LSTM kernel and the word embedding uniform in +-``fc_kernel_initializer_scale``,
biases and batch-norm shifts and means 0, batch-norm scales and variances 1,
but for the output bias of word 0 (``<start>``), set at ``START_BIAS``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .reference.shapes import param_shapes

_CONSTANT = {"bias": 0.0, "mean": 0.0, "scale": 1.0, "var": 1.0}
START_BIAS = -30.0
WEIGHT_STREAM, IMAGE_STREAM = 0, 1


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator for one stream of a run's draws on ``device``: the
    weights, the images, and each driver's own (its captions, dropout)."""
    return torch.Generator(device=device).manual_seed((int(seed) * 7919 + stream) % (2 ** 63))


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    shapes = param_shapes(cfg)
    drawn = [n for n in shapes if n.rsplit("/", 1)[1] not in _CONSTANT]
    sizes = [math.prod(shapes[n]) for n in drawn]
    u = torch.rand(sum(sizes), generator=generator(seed, WEIGHT_STREAM, device), device=device).mul_(2.0).sub_(1.0)
    flat = {}
    for name, part in zip(drawn, torch.split(u, sizes)):
        shape = shapes[name]
        if len(shape) == 4:  # HWIO conv kernel
            receptive = shape[0] * shape[1]
            limit = math.sqrt(6.0 / (receptive * shape[2] + receptive * shape[3]))
        else:
            limit = cfg["fc_kernel_initializer_scale"]
        flat[name] = part.view(shape).mul_(limit)
    for name, shape in shapes.items():
        if name not in flat:
            flat[name] = torch.full(shape, _CONSTANT[name.rsplit("/", 1)[1]], device=device)
    # index 0 is <start>, which a trained model never emits: its logit sits far below
    flat["params/decoder/decode/fc_2/bias"][0] = START_BIAS
    return flat


def make_images(count: int, size: int, seed: int, device) -> torch.Tensor:
    """``count`` RGB uint8 images [count, size, size, 3]."""
    g = generator(seed, IMAGE_STREAM, device)
    return torch.randint(0, 256, (count, size, size, 3), generator=g, device=device, dtype=torch.uint8)
