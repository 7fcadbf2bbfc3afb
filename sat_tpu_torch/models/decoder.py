"""Soft-attention LSTM caption decoder at inference — the port of the
inference functions of ``sat_tpu.models.decoder``.

Parameters are the JAX package's nested dict (``params["attend"]["fc_1a"]
["kernel"]``), with dense kernels kept ``[in, out]`` so the bridge
(``train.checkpoint``) is a rename, not a transpose.  Rounding follows the
JAX functions step for step, so both packages agree at ``float32`` up to
summation order:

* ``_dense`` rounds ``x`` and the kernel to ``compute_dtype``, multiplies,
  adds the bias in ``compute_dtype``, then casts to float32;
* ``lstm_step`` adds its bias in float32, after the cast;
* the LSTM is a TF1 LSTMCell — one ``[in+H, 4H]`` kernel, gates
  (i, j, f, o), ``forget_bias=1.0`` — not ``torch.nn.LSTMCell``.

No dropout and no training path: this slice of the port only serves.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..config import Config
from ..ops.fused_attend import fused_attend

Params = Dict[str, Any]


class DecoderState(NamedTuple):
    """LSTM carry; ``output`` and ``recurrent`` are the same h at
    inference (they differ only under the JAX package's training
    dropout)."""

    memory: torch.Tensor      # cell state c, [B, H]
    output: torch.Tensor      # emitted h (feeds attend + decode), [B, H]
    recurrent: torch.Tensor   # recurrent h (feeds the next LSTM step), [B, H]


def compute_dtype(config: Config) -> torch.dtype:
    return getattr(torch, config.compute_dtype)


def _dense(p, x, activation=None, dtype=torch.bfloat16):
    y = x.to(dtype) @ p["kernel"].to(dtype)
    if "bias" in p:
        y = y + p["bias"].to(dtype)
    y = y.float()
    if activation == "tanh":
        y = torch.tanh(y)
    return y


def lstm_step(
    p: Params,
    c: torch.Tensor,
    h: torch.Tensor,
    x: torch.Tensor,
    dtype=torch.bfloat16,
    forget_bias: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """TF1 LSTMCell: concat(x, h) @ kernel → (i, j, f, o).  Returns (c, h)."""
    z = torch.cat([x, h], dim=-1).to(dtype) @ p["kernel"].to(dtype)
    z = z.float() + p["bias"]
    i, j, f, o = z.chunk(4, dim=-1)
    new_c = torch.sigmoid(f + forget_bias) * c + torch.sigmoid(i) * torch.tanh(j)
    new_h = torch.sigmoid(o) * torch.tanh(new_c)
    return new_c, new_h


def init_state(params: Params, config: Config, contexts: torch.Tensor) -> DecoderState:
    """LSTM state from the mean context through a 1- or 2-layer MLP."""
    p = params["initialize"]
    dt = compute_dtype(config)
    context_mean = contexts.mean(dim=1)
    if config.num_initialize_layers == 1:
        memory = _dense(p["fc_a"], context_mean, dtype=dt)
        output = _dense(p["fc_b"], context_mean, dtype=dt)
    else:
        ta = _dense(p["fc_a1"], context_mean, activation="tanh", dtype=dt)
        tb = _dense(p["fc_b1"], context_mean, activation="tanh", dtype=dt)
        memory = _dense(p["fc_a2"], ta, dtype=dt)
        output = _dense(p["fc_b2"], tb, dtype=dt)
    return DecoderState(memory=memory, output=output, recurrent=output)


def precompute_attend(params: Params, config: Config, contexts: torch.Tensor) -> torch.Tensor:
    """The context-only half of the attention MLP, hoisted out of the
    decode loop: 1-layer per-position logits [B, N], or the 2-layer
    tanh features ``t1`` [B, N, da]."""
    p = params["attend"]
    dt = compute_dtype(config)
    if config.num_attend_layers == 1:
        return _dense(p["fc_a"], contexts, dtype=dt)[..., 0]
    return _dense(p["fc_1a"], contexts, activation="tanh", dtype=dt)


def _softmax_context(logits: torch.Tensor, contexts: torch.Tensor):
    alpha = torch.softmax(logits.float(), dim=-1)
    context = torch.bmm(alpha.unsqueeze(1), contexts).squeeze(1)
    return context, alpha


def attend_with_precomputed(
    params: Params,
    config: Config,
    contexts: torch.Tensor,
    ctx_proj: torch.Tensor,
    output: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(context [B, D], alpha [B, N]) from the hoisted ``ctx_proj``.

    With ``use_pallas_attention`` the 2-layer combine goes through
    :func:`~sat_tpu_torch.ops.fused_attend.fused_attend`: the CUDA kernel
    for tensors on the card, its plain version for tensors on the CPU."""
    p = params["attend"]
    dt = compute_dtype(config)
    if config.num_attend_layers == 1:
        logits = ctx_proj + _dense(p["fc_b"], output, dtype=dt)
        return _softmax_context(logits, contexts)
    t2 = _dense(p["fc_1b"], output, activation="tanh", dtype=dt)
    if config.use_pallas_attention:
        return fused_attend(
            ctx_proj, t2, p["fc_2"]["kernel"], contexts,
            compute_dtype=config.compute_dtype,
        )
    temp = ctx_proj + t2.unsqueeze(1)
    logits = _dense(p["fc_2"], temp, dtype=dt)[..., 0]
    return _softmax_context(logits, contexts)


def decode_logits(params: Params, config: Config, expanded_output: torch.Tensor) -> torch.Tensor:
    """concat(output, context, word_embed) → vocabulary logits."""
    p = params["decode"]
    dt = compute_dtype(config)
    if config.num_decode_layers == 1:
        return _dense(p["fc"], expanded_output, dtype=dt)
    temp = _dense(p["fc_1"], expanded_output, activation="tanh", dtype=dt)
    return _dense(p["fc_2"], temp, dtype=dt)


def decoder_step(
    params: Params,
    config: Config,
    contexts: torch.Tensor,
    state: DecoderState,
    word: torch.Tensor,
    ctx_proj: Optional[torch.Tensor] = None,
) -> Tuple[DecoderState, torch.Tensor, torch.Tensor]:
    """One decoder step: attend → embed → LSTM → logits.

    Returns (new_state, logits [B, V], alpha [B, N]).  ``ctx_proj`` is the
    hoisted :func:`precompute_attend` output; None recomputes it."""
    if ctx_proj is None:
        ctx_proj = precompute_attend(params, config, contexts)
    context, alpha = attend_with_precomputed(
        params, config, contexts, ctx_proj, state.output
    )
    word_embed = params["word_embedding"]["weights"][word]
    lstm_input = torch.cat([context, word_embed], dim=-1)
    new_c, new_h = lstm_step(
        params["lstm"], state.memory, state.recurrent, lstm_input,
        dtype=compute_dtype(config),
    )
    expanded = torch.cat([new_h, context, word_embed], dim=-1)
    logits = decode_logits(params, config, expanded)
    return DecoderState(memory=new_c, output=new_h, recurrent=new_h), logits, alpha
