"""The full caption model: the CNN encoder (VGG16 or ResNet50), the
attention-LSTM decoder and the training loss — the port of
``sat_tpu.models.captioner``.

* :func:`encode` maps images to the context grid for decoding: through
  the float32 CNN (ResNet50's batch norms on their running statistics),
  or through the quantized encoder when the params carry one (``qcnn``,
  built by ``nn.quant`` for serving with ``encoder_quant``);
* :func:`compute_loss` is the three-part objective: masked cross-entropy
  over the mask sum, the doubly-stochastic attention penalty and the L2
  (plus optional L1 activity) regularization, and token accuracy.  The
  CNN trains only with ``train_cnn`` (ResNet50's batch norms then on the
  batch's statistics, the updated running statistics returned);
  otherwise it runs under ``torch.no_grad`` and its contexts carry no
  gradient;
* :func:`init_variables` is a random initialization in the JAX package's
  distributions, drawn from an explicit generator.

The params these functions take are the ``params_from_flat`` layout
(``{"cnn", "decoder"}``), plus ``"batch_stats"`` for ResNet50 (and
``"qcnn"`` in place of ``"cnn"`` for a quantized encoder).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..config import Config
from ..data.images import ILSVRC_2012_MEAN
from ..nn.layers import regularization_loss
from ..nn.quant import quantized_encode
from ..train.checkpoint import batch_stats_from_flat, param_shapes, params_from_flat
from .decoder import teacher_forced_decode
from .resnet50 import resnet50
from .vgg16 import vgg16


def _preprocess(images: torch.Tensor) -> torch.Tensor:
    """A uint8 batch is the raw RGB feed: it becomes ``float32 − ILSVRC
    mean`` on the device, the JAX package's device-side preprocessing
    tail."""
    if images.dtype == torch.uint8:
        mean = torch.as_tensor(ILSVRC_2012_MEAN, device=images.device)
        return images.float() - mean
    return images


def _cnn(params: Dict[str, Any], config: Config, images: torch.Tensor, train: bool,
         with_activity: bool = False):
    """The float32-parameter CNN over preprocessed images: (contexts, new
    batch statistics or None, conv L1 activity).  Only VGG16's convs sow
    activity; ResNet50's run without an activation, so theirs is 0."""
    dtype = getattr(torch, config.compute_dtype)
    if config.cnn == "vgg16":
        if with_activity:
            contexts, activity = vgg16(params["cnn"], images, dtype, with_activity=True)
            return contexts, None, activity
        return vgg16(params["cnn"], images, dtype), None, 0.0
    contexts, new_stats = resnet50(params["cnn"], params["batch_stats"], images, dtype, train)
    return contexts, new_stats, 0.0


def encode(
    params: Dict[str, Any], config: Config, images: torch.Tensor
) -> torch.Tensor:
    """images [B, S, S, 3] → contexts [B, N, D] float32, on ``images``' device.

    The CNN runs in ``config.compute_dtype`` (TF32 is off once the card
    is resolved, ``device.resolve_device``); with ``encoder_quant`` on and
    a ``qcnn`` in the params, the quantized encoder runs instead."""
    images = _preprocess(images)
    if config.encoder_quant != "off" and "qcnn" in params:
        return quantized_encode(params, config, images)
    return _cnn(params, config, images, train=False)[0]


def token_ce(
    logits: torch.Tensor, sentences: torch.Tensor, config: Config, train: bool = True
) -> torch.Tensor:
    """Per-token cross-entropy [B, T].  ``ce_dtype="bfloat16"`` (training
    only) takes ``logsumexp − target logit`` with the max shift held out
    of the gradient and the normalizer summed in float32, as the JAX
    package does; otherwise the float32 log-softmax."""
    target = sentences.long().unsqueeze(-1)
    if config.ce_dtype == "bfloat16" and train:
        m = logits.detach().amax(dim=-1, keepdim=True)
        s = torch.exp(logits - m).sum(dim=-1, dtype=torch.float32)
        lse = m[..., 0].float() + torch.log(s)
        return lse - logits.gather(-1, target)[..., 0].float()
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, target)[..., 0]


def compute_loss(
    params: Dict[str, Any],
    config: Config,
    batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
    train: bool = True,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Forward pass and the total loss.

    ``batch``: images [B, S, S, 3] (or precomputed 'contexts' [B, N, D]),
    word_idxs [B, T] int, masks [B, T].  Dropout masks come from
    ``generator``, which training needs.  Returns (total_loss, aux) with
    aux's 'metrics' (the five losses and accuracy), 'attentions' [B, N]
    (Σ_t α·mask) and 'batch_stats' (ResNet50's updated running
    statistics when the CNN trains, else None)."""
    if train and generator is None:
        raise ValueError("compute_loss(train=True) requires a generator for dropout")
    fc_act_scale = config.fc_activity_regularizer_scale if train else 0.0
    train_cnn = train and config.train_cnn
    conv_act_scale = config.conv_activity_regularizer_scale if train_cnn else 0.0
    conv_activity, new_stats = 0.0, None
    if "contexts" in batch:
        contexts = batch["contexts"]
    elif train_cnn:
        contexts, new_stats, conv_activity = _cnn(
            params, config, _preprocess(batch["images"]), train=True,
            with_activity=conv_act_scale > 0,
        )
    else:
        with torch.no_grad():
            contexts = encode(params, config, batch["images"])

    sentences = batch["word_idxs"]
    masks = batch["masks"].float()
    B, T = sentences.shape
    N = contexts.shape[1]
    logits, alphas, fc_activity = teacher_forced_decode(
        params["decoder"], config, contexts, sentences, generator if train else None
    )

    ce = token_ce(logits, sentences, config, train)
    mask_sum = masks.sum()
    cross_entropy_loss = (ce * masks).sum() / mask_sum

    # doubly stochastic attention: Σ_t α·mask per position, pulled toward 1
    attentions = (alphas * masks.unsqueeze(-1)).sum(dim=1)
    diffs = 1.0 - attentions
    attention_loss = config.attention_loss_factor * 0.5 * (diffs * diffs).sum() / (B * N)

    reg_loss = regularization_loss(
        {"cnn": params["cnn"], "decoder": params["decoder"]},
        fc_scale=config.fc_kernel_regularizer_scale if train else 0.0,
        conv_scale=config.conv_kernel_regularizer_scale,
        train_cnn=train_cnn,
    )
    reg_loss = reg_loss + fc_act_scale * fc_activity + conv_act_scale * conv_activity
    total_loss = cross_entropy_loss + attention_loss + reg_loss

    predictions = logits.argmax(dim=-1)
    accuracy = ((predictions == sentences).float() * masks).sum() / mask_sum
    aux = {
        "metrics": {
            "cross_entropy_loss": cross_entropy_loss,
            "attention_loss": attention_loss,
            "reg_loss": reg_loss,
            "total_loss": total_loss,
            "accuracy": accuracy,
        },
        "attentions": attentions,
        "batch_stats": new_stats,
    }
    return total_loss, aux


def init_variables(
    config: Config, generator: torch.Generator, device="cpu"
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The port of ``init_variables``: (params, batch statistics) in the
    JAX package's distributions — conv kernels glorot-uniform, dense
    kernels, the LSTM kernel and the word embedding uniform in
    ±``fc_kernel_initializer_scale``, biases zero, batch-norm scales one;
    running means zero and variances one.  Drawn on the CPU from
    ``generator`` in the order of the flat checkpoint names, then moved to
    ``device``.  (Not JAX's bits: the tests carry JAX's weights across
    through the bridge.)"""
    flat = {}
    for name, shape in param_shapes(config).items():
        leaf = name.rsplit("/", 1)[1]
        if leaf in ("bias", "mean", "scale", "var"):
            fill = torch.ones if leaf in ("scale", "var") else torch.zeros
            flat[name] = fill(shape).numpy()
            continue
        if len(shape) == 4:      # HWIO conv kernel
            receptive = shape[0] * shape[1]
            limit = math.sqrt(6.0 / (receptive * shape[2] + receptive * shape[3]))
        else:
            limit = config.fc_kernel_initializer_scale
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        flat[name] = ((u * 2.0 - 1.0) * limit).numpy()
    return params_from_flat(flat, config, device), batch_stats_from_flat(flat, config, device)


def init_params(config: Config, generator: torch.Generator, device="cpu") -> Dict[str, Any]:
    """The parameters of :func:`init_variables`."""
    return init_variables(config, generator, device)[0]
