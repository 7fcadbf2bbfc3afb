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
  gradient.  ``remat_cnn`` puts a training CNN's forward under
  ``torch.utils.checkpoint``; ``diag_level`` adds the forward-side
  ``diag/*`` taps (``telemetry.device.loss_taps``) to a training step's
  metrics;
* :func:`init_variables` is a random initialization in the JAX package's
  distributions, drawn from an explicit generator.

The params these functions take are the ``params_from_flat`` layout
(``{"cnn", "decoder"}``), plus ``"batch_stats"`` for ResNet50 (and
``"qcnn"`` in place of ``"cnn"`` for a quantized encoder).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..config import Config
from ..data.images import ILSVRC_2012_MEAN
from ..nn.layers import BatchRows, regularization_loss
from ..nn.quant import quantized_encode
from ..parallel.collectives import all_reduce_, reduce_from
from ..parallel.mesh import SINGLE
from ..parallel.sharding import partition
from ..parallel.vocab import vocab_parallel
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
         with_activity: bool = False, group=None):
    """The float32-parameter CNN over preprocessed images: (contexts, new
    batch statistics or None, conv L1 activity).  Only VGG16's convs sow
    activity; ResNet50's run without an activation, so theirs is 0.
    ``group``: the data-parallel group of a training ResNet50's global
    batch-norm moments."""
    dtype = getattr(torch, config.compute_dtype)
    if config.cnn == "vgg16":
        if with_activity:
            contexts, activity = vgg16(params["cnn"], images, dtype, with_activity=True)
            return contexts, None, activity
        return vgg16(params["cnn"], images, dtype), None, 0.0
    contexts, new_stats = resnet50(params["cnn"], params["batch_stats"], images, dtype, train, group)
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


def loss_contexts(params: Dict[str, Any], config: Config, batch: Dict[str, torch.Tensor], train: bool,
                  group=None):
    """The context grid a loss runs on: (contexts, the CNN's new batch
    statistics or None, its conv L1 activity).  The batch's precomputed
    'contexts', or the CNN: training with ``train_cnn`` (under
    ``remat_cnn`` checkpointed; ``group`` the data-parallel group of its
    batch-norm moments), else frozen under ``torch.no_grad``."""
    train_cnn = train and config.train_cnn
    if "contexts" in batch:
        return batch["contexts"], None, 0.0
    if train_cnn:
        with_activity = config.conv_activity_regularizer_scale > 0

        def cnn(images):
            return _cnn(params, config, images, train=True, with_activity=with_activity, group=group)

        if config.remat_cnn:
            # the backward recomputes the CNN forward from the images
            # instead of keeping every conv activation; the running
            # statistics are the forward's (the recompute's are dropped)
            cnn = functools.partial(checkpoint, cnn, use_reentrant=False, preserve_rng_state=False)
        return cnn(_preprocess(batch["images"]))
    with torch.no_grad():
        return encode(params, config, batch["images"]), None, 0.0


def _regularization(params: Dict[str, Any], config: Config, mesh, vocab, train_cnn: bool,
                    fc_scale: float) -> torch.Tensor:
    """The weight-L2 term over the full parameters: under vocab
    parallelism the replicated leaves' sum plus the sharded blocks' sums
    added over the model group (identity backward: each rank's block
    takes its own gradient)."""
    kw = dict(fc_scale=fc_scale, conv_scale=config.conv_kernel_regularizer_scale, train_cnn=train_cnn)
    if vocab is None:
        return regularization_loss(params, **kw)
    replicated, sharded = partition(params, config, mesh)
    return regularization_loss(replicated, **kw) + reduce_from(regularization_loss(sharded, **kw), vocab.group)


def compute_loss(
    params: Dict[str, Any],
    config: Config,
    batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
    train: bool = True,
    mesh=None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Forward pass and the total loss.

    ``batch``: images [B, S, S, 3] (or precomputed 'contexts' [B, N, D]),
    word_idxs [B, T] int, masks [B, T].  Dropout masks come from
    ``generator``, which training needs.  Returns (total_loss, aux) with
    aux's 'metrics' (the five losses and accuracy), 'attentions' [B, N]
    (Σ_t α·mask) and 'batch_stats' (ResNet50's updated running
    statistics when the CNN trains, else None).

    ``mesh`` (a ``parallel.mesh.Mesh``): ``batch`` holds this rank's rows
    of the global batch and ``params`` its blocks.  Every term is then
    normalized by the global count, as GSPMD computes it: cross-entropy
    and accuracy by the global mask sum, the attention penalty by the
    global B·N, the fc activity summed over the global batch.  The loss
    returned is this rank's share (the weight-L2 term, replicated, on data
    rank 0 only), so the sum of the data ranks' gradients is the global
    loss' gradient; the metrics are the global values on every rank.
    Dropout draws the global batch's masks and takes this rank's rows
    (``nn.layers.BatchRows``).  Vocab parallelism (``parallel.vocab``)
    splits the embedding and the logits over the model group; context
    parallelism (``parallel.context``) the grid.  Without a mesh every
    reduction here is the identity."""
    if train and generator is None:
        raise ValueError("compute_loss(train=True) requires a generator for dropout")
    mesh = mesh or SINGLE
    data, model = mesh.group("data"), mesh.group("model")
    dp, d = mesh.size("data"), mesh.index("data")
    cp = config.context_parallel > 1
    vocab = vocab_parallel(config, mesh)
    fc_act_scale = config.fc_activity_regularizer_scale if train else 0.0
    train_cnn = train and config.train_cnn
    conv_act_scale = config.conv_activity_regularizer_scale if train_cnn else 0.0
    contexts, new_stats, conv_activity = loss_contexts(params, config, batch, train, group=data)

    sentences = batch["word_idxs"]
    masks = batch["masks"].float()
    B, T = sentences.shape
    gen = (BatchRows(generator, d * B, dp * B) if dp > 1 else generator) if train else None
    if cp:
        from ..parallel.context import cp_teacher_forced

        logits, alphas, fc_activity = cp_teacher_forced(params["decoder"], config, contexts, sentences, mesh, gen)
    else:
        logits, alphas, fc_activity = teacher_forced_decode(
            params["decoder"], config, contexts, sentences, gen, vocab=vocab
        )

    ce = token_ce(logits, sentences, config, train) if vocab is None else vocab.token_ce(logits, sentences)
    mask_sum = all_reduce_(masks.sum(), data)
    cross_entropy_loss = (ce * masks).sum() / mask_sum

    # doubly stochastic attention: Σ_t α·mask per position, pulled toward 1
    # (under context parallelism this rank's block of positions)
    attentions = (alphas * masks.unsqueeze(-1)).sum(dim=1)
    diffs = 1.0 - attentions
    squares = (diffs * diffs).sum()
    N = alphas.shape[-1]
    if cp:
        squares = reduce_from(squares, model)
        N *= mesh.size("model")
    attention_loss = config.attention_loss_factor * 0.5 * squares / (B * dp * N)

    reg = _regularization(
        {"cnn": params["cnn"], "decoder": params["decoder"]}, config, mesh, vocab, train_cnn,
        config.fc_kernel_regularizer_scale if train else 0.0,
    )
    if d > 0:  # replicated over the data group: its gradient counts once
        reg = 0.0 * reg
    reg_loss = reg + fc_act_scale * fc_activity + conv_act_scale * conv_activity
    total_loss = cross_entropy_loss + attention_loss + reg_loss

    predictions = logits.argmax(dim=-1) if vocab is None else vocab.argmax(logits)
    accuracy = ((predictions == sentences).float() * masks).sum() / mask_sum
    parts = all_reduce_(torch.stack([cross_entropy_loss, attention_loss, reg_loss, accuracy]).detach(), data)
    aux = {
        "metrics": {
            "cross_entropy_loss": parts[0],
            "attention_loss": parts[1],
            "reg_loss": parts[2],
            "total_loss": parts[0] + parts[1] + parts[2],
            "accuracy": parts[3],
        },
        "attentions": attentions,
        "batch_stats": new_stats,
    }
    if train and config.diag_level != "off":
        # forward-side diag taps, computed where the alphas and logits are
        # live; with diag off nothing here runs
        from ..telemetry.device import loss_taps

        aux["metrics"].update(loss_taps(
            config.diag_level, alphas=alphas, masks=masks, logits=logits,
            rows=data, positions=model if cp else None, columns=None if vocab is None else vocab.group,
        ))
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
