"""Soft-attention LSTM caption decoder — the port of ``sat_tpu.models.decoder``.

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

Training (:func:`teacher_forced_decode` with a ``generator``) follows the
JAX package's ``train=True`` path: fc dropout on the initializer, attend
and decode inputs, DropoutWrapper masks on the LSTM input and on the
emitted and recurrent h (the cell state is exempt), ``t1 = tanh(fc_1a(
ctx))`` recomputed every step on freshly dropped-out contexts (so it
reaches no kernel), and the L1 activity sums of the tanh outputs taken
before their dropout.  Masks come from one ``torch.Generator`` drawn in
a fixed order, so the same generator state replays the same masks.
With ``remat_decoder`` each training step runs under selective
activation checkpointing (:func:`_remat_step`).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from ..config import Config
from ..nn.layers import dropout
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
    return init_from_mean(params, config, contexts.mean(dim=1))


def init_from_mean(params: Params, config: Config, context_mean: torch.Tensor) -> DecoderState:
    """:func:`init_state` from an already reduced context mean."""
    p = params["initialize"]
    dt = compute_dtype(config)
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


def _softmax_context(logits: torch.Tensor, contexts: torch.Tensor, valid=None):
    """Softmax over N and the weighted context sum; ``valid`` [B, 1] bool
    zeroes dead rows' logits before the softmax and alpha and context
    after it, as the JAX decoder's ``jnp.where`` does."""
    logits = logits.float()
    if valid is not None:
        logits = torch.where(valid, logits, torch.zeros_like(logits))
    alpha = torch.softmax(logits, dim=-1)
    if valid is not None:
        alpha = torch.where(valid, alpha, torch.zeros_like(alpha))
    context = torch.bmm(alpha.unsqueeze(1), contexts).squeeze(1)
    if valid is not None:
        context = torch.where(valid, context, torch.zeros_like(context))
    return context, alpha


def attend_with_precomputed(
    params: Params,
    config: Config,
    contexts: torch.Tensor,
    ctx_proj: torch.Tensor,
    output: torch.Tensor,
    row_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(context [B, D], alpha [B, N]) from the hoisted ``ctx_proj``.

    With ``use_pallas_attention`` the 2-layer combine goes through
    :func:`~sat_tpu_torch.ops.fused_attend.fused_attend`: the CUDA kernel
    for tensors on the card, its plain version for tensors on the CPU.

    ``row_mask`` [B] bool (the slot pool's dead-slot mask): False rows get
    zero logits, alpha and context on every path, so a retired slot's
    stale state can never emit a NaN; True rows are bitwise those of the
    unmasked call."""
    p = params["attend"]
    dt = compute_dtype(config)
    valid = None if row_mask is None else row_mask.reshape(-1, 1)
    if config.num_attend_layers == 1:
        logits = ctx_proj + _dense(p["fc_b"], output, dtype=dt)
        return _softmax_context(logits, contexts, valid)
    t2 = _dense(p["fc_1b"], output, activation="tanh", dtype=dt)
    if config.use_pallas_attention:
        return fused_attend(
            ctx_proj, t2, p["fc_2"]["kernel"], contexts, row_mask=row_mask,
            compute_dtype=config.compute_dtype,
        )
    temp = ctx_proj + t2.unsqueeze(1)
    logits = _dense(p["fc_2"], temp, dtype=dt)[..., 0]
    return _softmax_context(logits, contexts, valid)


def embed(params: Params, word: torch.Tensor, vocab=None) -> torch.Tensor:
    """The word embedding rows of ``word``; with ``vocab``
    (``parallel.vocab.VocabParallel``) the table is this rank's block."""
    table = params["word_embedding"]["weights"]
    return table[word] if vocab is None else vocab.embed(table, word)


def _project(p, x: torch.Tensor, dt, vocab=None) -> torch.Tensor:
    """The last decode layer: full logits, or this rank's block of them
    under vocab parallelism (``x`` entering the sharded work)."""
    return _dense(p, x if vocab is None else vocab.enter(x), dtype=dt)


def decode_logits(params: Params, config: Config, expanded_output: torch.Tensor, vocab=None) -> torch.Tensor:
    """concat(output, context, word_embed) → vocabulary logits (this rank's
    block of them with ``vocab``)."""
    p = params["decode"]
    dt = compute_dtype(config)
    if config.num_decode_layers == 1:
        return _project(p["fc"], expanded_output, dt, vocab)
    temp = _dense(p["fc_1"], expanded_output, activation="tanh", dtype=dt)
    return _project(p["fc_2"], temp, dt, vocab)


def decoder_step(
    params: Params,
    config: Config,
    contexts: torch.Tensor,
    state: DecoderState,
    word: torch.Tensor,
    ctx_proj: Optional[torch.Tensor] = None,
    row_mask: Optional[torch.Tensor] = None,
    vocab=None,
) -> Tuple[DecoderState, torch.Tensor, torch.Tensor]:
    """One decoder step: attend → embed → LSTM → logits.

    Returns (new_state, logits [B, V], alpha [B, N]).  ``ctx_proj`` is the
    hoisted :func:`precompute_attend` output; None recomputes it.
    ``row_mask`` [B] bool goes to :func:`attend_with_precomputed` (the
    stepped decode's dead-slot mask); the monolithic search never sets
    it.  ``vocab`` (vocab parallelism): the sharded embedding and
    projection, the logits assembled full-width."""
    if ctx_proj is None:
        ctx_proj = precompute_attend(params, config, contexts)
    context, alpha = attend_with_precomputed(
        params, config, contexts, ctx_proj, state.output, row_mask=row_mask
    )
    word_embed = embed(params, word, vocab)
    lstm_input = torch.cat([context, word_embed], dim=-1)
    new_c, new_h = lstm_step(
        params["lstm"], state.memory, state.recurrent, lstm_input,
        dtype=compute_dtype(config),
    )
    expanded = torch.cat([new_h, context, word_embed], dim=-1)
    logits = decode_logits(params, config, expanded, vocab)
    if vocab is not None:
        logits = vocab.gather(logits)
    return DecoderState(memory=new_c, output=new_h, recurrent=new_h), logits, alpha


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def _l1(config: Config, *xs: torch.Tensor):
    """L1 activity of activated layer outputs: Σ|x|, unnormalized (TF1
    ``l1_regularizer``; the scale is applied by the caller).  0.0 when
    ``fc_activity_regularizer_scale`` is 0, so no kernel runs for it."""
    if config.fc_activity_regularizer_scale <= 0:
        return 0.0
    return sum(x.float().abs().sum() for x in xs)


def train_init_state(
    params: Params, config: Config, contexts: torch.Tensor, generator: torch.Generator
) -> Tuple[DecoderState, torch.Tensor]:
    """:func:`init_state` under dropout: one mask on the context mean and
    one on each tanh layer.  Returns (state, L1 of the tanh outputs)."""
    return train_init_from_mean(params, config, contexts.mean(dim=1), generator)


def train_init_from_mean(
    params: Params, config: Config, context_mean: torch.Tensor, generator: torch.Generator
) -> Tuple[DecoderState, torch.Tensor]:
    """:func:`train_init_state` from an already reduced context mean (the
    context-parallel init takes it over the sharded grid)."""
    p = params["initialize"]
    rate = config.fc_drop_rate
    dt = compute_dtype(config)
    context_mean = dropout(context_mean, rate, generator)
    act = 0.0
    if config.num_initialize_layers == 1:
        memory = _dense(p["fc_a"], context_mean, dtype=dt)
        output = _dense(p["fc_b"], context_mean, dtype=dt)
    else:
        ta = _dense(p["fc_a1"], context_mean, activation="tanh", dtype=dt)
        tb = _dense(p["fc_b1"], context_mean, activation="tanh", dtype=dt)
        act = _l1(config, ta, tb)
        memory = _dense(p["fc_a2"], dropout(ta, rate, generator), dtype=dt)
        output = _dense(p["fc_b2"], dropout(tb, rate, generator), dtype=dt)
    return DecoderState(memory=memory, output=output, recurrent=output), act


def train_attend(
    params: Params,
    config: Config,
    contexts: torch.Tensor,
    output: torch.Tensor,
    generator: torch.Generator,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention under dropout → (alpha [B, N], L1 of the tanh outputs,
    see :func:`_l1`).

    Masks on ``contexts`` and ``output``, then (2 layers) on ``t1 + t2``;
    ``t1`` is recomputed from the dropped-out contexts every step."""
    p = params["attend"]
    rate = config.fc_drop_rate
    dt = compute_dtype(config)
    contexts = dropout(contexts, rate, generator)
    output = dropout(output, rate, generator)
    if config.num_attend_layers == 1:
        logits = _dense(p["fc_a"], contexts, dtype=dt)[..., 0] + _dense(p["fc_b"], output, dtype=dt)
        return torch.softmax(logits.float(), dim=-1), 0.0
    t1 = _dense(p["fc_1a"], contexts, activation="tanh", dtype=dt)     # [B, N, da]
    t2 = _dense(p["fc_1b"], output, activation="tanh", dtype=dt)       # [B, da]
    act = _l1(config, t1, t2)
    temp = dropout(t1 + t2.unsqueeze(1), rate, generator)
    logits = _dense(p["fc_2"], temp, dtype=dt)[..., 0]
    return torch.softmax(logits.float(), dim=-1), act


def train_decode_logits(
    params: Params, config: Config, expanded_output: torch.Tensor, generator: torch.Generator, vocab=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`decode_logits` under dropout → (logits, L1 of the tanh output)."""
    p = params["decode"]
    rate = config.fc_drop_rate
    dt = compute_dtype(config)
    expanded_output = dropout(expanded_output, rate, generator)
    if config.num_decode_layers == 1:
        return _project(p["fc"], expanded_output, dt, vocab), 0.0
    temp = _dense(p["fc_1"], expanded_output, activation="tanh", dtype=dt)
    act = _l1(config, temp)
    return _project(p["fc_2"], dropout(temp, rate, generator), dt, vocab), act


def train_decoder_step(
    params: Params,
    config: Config,
    contexts: torch.Tensor,
    state: DecoderState,
    word: torch.Tensor,
    generator: torch.Generator,
    vocab=None,
) -> Tuple[DecoderState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One training step: attend → embed → LSTM → logits, with the
    DropoutWrapper's three masks (LSTM input, emitted h, recurrent h).
    Returns (new_state, logits [B, V] (this rank's block under vocab
    parallelism), alpha [B, N], the step's L1)."""
    ldr = config.lstm_drop_rate
    alpha, act = train_attend(params, config, contexts, state.output, generator)
    context = torch.bmm(alpha.unsqueeze(1), contexts).squeeze(1)
    word_embed = embed(params, word, vocab)
    lstm_input = dropout(torch.cat([context, word_embed], dim=-1), ldr, generator)
    new_c, new_h = lstm_step(
        params["lstm"], state.memory, state.recurrent, lstm_input, dtype=compute_dtype(config)
    )
    emitted = dropout(new_h, ldr, generator)
    recurrent = dropout(new_h, ldr, generator)
    expanded = torch.cat([emitted, context, word_embed], dim=-1)
    logits, dec_act = train_decode_logits(params, config, expanded, generator, vocab)
    new_state = DecoderState(memory=new_c, output=emitted, recurrent=recurrent)
    return new_state, logits, alpha, act + dec_act


def teacher_forced_decode(
    params: Params,
    config: Config,
    contexts: torch.Tensor,
    sentences: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    vocab=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The training-time unroll over T steps: step 0 is fed ``<start>`` = 0,
    step t the ground-truth word ``sentences[:, t-1]``.

    With a ``generator``: the training path, dropout on.  Without: the
    inference step (hoisted ``t1``, the fused attention kernel on the
    card), as the JAX package's ``train=False``.  Returns (logits [B, T, V],
    alphas [B, T, N], the L1 activity of every tanh output over the
    initializer and all T steps; 0.0 without a generator or with
    ``fc_activity_regularizer_scale`` 0).  ``vocab`` (vocab parallelism):
    the sharded embedding and projection; the training logits are this
    rank's block, the inference ones full-width."""
    B, T = sentences.shape
    words_in = torch.cat([sentences.new_zeros((B, 1)), sentences[:, :-1]], dim=1)
    logits, alphas = [], []
    if generator is None:
        act = 0.0
        state = init_state(params, config, contexts)
        ctx_proj = precompute_attend(params, config, contexts)
        for t in range(T):
            state, step_logits, alpha = decoder_step(
                params, config, contexts, state, words_in[:, t], ctx_proj=ctx_proj, vocab=vocab
            )
            logits.append(step_logits)
            alphas.append(alpha)
    else:
        state, act = train_init_state(params, config, contexts, generator)
        step = functools.partial(
            _remat_step if config.remat_decoder else train_decoder_step, params, config, contexts,
            generator=generator, vocab=vocab,
        )
        for t in range(T):
            state, step_logits, alpha, step_act = step(state, words_in[:, t])
            logits.append(step_logits)
            alphas.append(alpha)
            act = act + step_act
    return torch.stack(logits, dim=1), torch.stack(alphas, dim=1), act


# matmul outputs a rematerialized step keeps, as JAX's ``dots_saveable``
_SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.bmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_OPS else CheckpointPolicy.PREFER_RECOMPUTE


def replay_checkpoint(step_fn, generators, *args):
    """``step_fn(*args)`` under selective activation checkpointing (the
    backward keeps the matmul outputs and recomputes the elementwise
    chain).  ``torch.utils.checkpoint`` replays only the default
    generators, so the recompute would draw new dropout masks from
    ``generators``: their states are taken before the forward body and set
    again for the recompute (their own states put back after it), so both
    draw the same masks and the gradients are bitwise those of the plain
    step."""
    snapshot = [g.get_state() for g in generators]
    calls = []

    def body(*a):
        if not calls:
            calls.append(True)
            return step_fn(*a)
        current = [g.get_state() for g in generators]
        for g, state in zip(generators, snapshot):
            g.set_state(state)
        try:
            return step_fn(*a)
        finally:
            for g, state in zip(generators, current):
                g.set_state(state)

    return checkpoint(
        body, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=functools.partial(create_selective_checkpoint_contexts, _save_dots),
    )


def _remat_step(
    params: Params,
    config: Config,
    contexts: torch.Tensor,
    state: DecoderState,
    word: torch.Tensor,
    generator: torch.Generator,
    vocab=None,
):
    """:func:`train_decoder_step` under ``remat_decoder``
    (:func:`replay_checkpoint`)."""
    step = functools.partial(train_decoder_step, params, config, contexts, generator=generator, vocab=vocab)
    return replay_checkpoint(step, [generator], state, word)
