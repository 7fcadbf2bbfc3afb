"""Context parallelism: the attention grid split over the mesh's ``model``
axis — the port of ``sat_tpu.parallel.context``.

Each model rank holds a block of ``N / cp`` positions of every context
grid and the soft attention becomes a distributed softmax (plain tensor
code, as the JAX package's ``_cp_attend`` is ``jnp`` code, not a kernel):

* each rank scores only its block (the dominant ``fc_1a`` matmul runs on
  ``1/cp`` of the grid);
* the softmax shift is a MAX over the group with no gradient, the
  denominator a SUM of the local exp-sums (summing backward: it feeds
  the sharded alphas), and the attended context a SUM of the local
  weighted sums (identity backward: it feeds replicated work);
* the LSTM, the embedding and the vocabulary logits run replicated,
  identically on every rank of the group.

Gradients come out whole on every rank (the tests hold them against the
single-device ones): a replicated tensor or parameter that enters the
sharded work goes through ``collectives.copy_to`` (its gradient summed
over the group) — the context grid, the ``h`` half of the attention MLP
and the parameters applied to a block (``fc_1a``, ``fc_2``; ``fc_a`` with
one attend layer) — and each partial that leaves it through
``reduce_from``.

Dropout: masks on context-sharded tensors (the dropped-out grid, the
attention MLP's ``temp``) come from a generator with the model index
folded in (independent masks a block); masks on replicated tensors from
the shared step generator, so the model ranks stay bitwise equal.  Both
draw over the global batch and take the rank's rows, so a context- and
data-parallel run draws what a context-parallel one does.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..models.decoder import (
    DecoderState, _dense, _l1, compute_dtype, decode_logits, embed, init_from_mean, lstm_step,
    precompute_attend, replay_checkpoint, train_decode_logits, train_init_from_mean,
)
from ..nn.layers import BatchRows, dropout
from ..ops.beam_search import BeamResult, run_search, tile_beams
from .collectives import all_reduce_max, all_reduce_sum, copy_to, reduce_from

AXIS = "model"  # the mesh axis the context grid splits over


def validate_cp_mesh(config: Config, mesh) -> None:
    """A context-parallel degree must spend the mesh's model axis exactly."""
    if mesh.size(AXIS) != config.context_parallel:
        raise ValueError(
            f"context_parallel={config.context_parallel} requires mesh '{AXIS}' axis of that size, "
            f"got {dict(zip(mesh.axes, mesh.shape))} (set mesh_shape and launch one rank a position "
            "with `python -m torch.distributed.run --standalone --nproc_per_node N -m sat_tpu_torch.cli`)"
        )
    if config.num_ctx % config.context_parallel:
        raise ValueError(
            f"context_parallel={config.context_parallel} must divide the context grid's "
            f"{config.num_ctx} positions"
        )


def shard_generator(generator, index: int):
    """The generator of a rank's context-sharded masks: the step
    generator's seed with the model ``index`` folded in (a
    :class:`BatchRows` keeps its rows)."""
    inner = generator.generator if isinstance(generator, BatchRows) else generator
    seed = int(np.random.SeedSequence((inner.initial_seed(), index)).generate_state(1)[0])
    folded = torch.Generator(device=inner.device).manual_seed(seed)
    if isinstance(generator, BatchRows):
        return BatchRows(folded, generator.start, generator.total)
    return folded


def _block(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block of positions (dim 1) of a [B, N, ...] grid."""
    n_local = x.shape[1] // mesh.size(AXIS)
    return x[:, mesh.index(AXIS) * n_local:(mesh.index(AXIS) + 1) * n_local]


def _sharded_params(params, config: Config, group):
    """The attention parameters applied to a block, each entering the
    sharded work once (their gradients summed over the group)."""
    p = params["attend"]
    names = ("fc_a",) if config.num_attend_layers == 1 else ("fc_1a", "fc_2")
    return {name: {k: copy_to(v, group) for k, v in p[name].items()} for name in names}


def _cp_attend(params, sharded, config: Config, ctx_local: torch.Tensor, output: torch.Tensor, mesh,
               gens=None, ctx_proj: Optional[torch.Tensor] = None):
    """The distributed soft attention over this rank's block ``ctx_local``
    [B, Nl, D]: (context [B, D] replicated, alpha_local [B, Nl], the L1
    activity partials (block-sharded, replicated)).  ``gens`` (shared,
    sharded) turns dropout on; ``ctx_proj`` is the hoisted context half
    of the MLP for this block (inference only)."""
    p = params["attend"]
    group = mesh.group(AXIS)
    rate = config.fc_drop_rate
    dt = compute_dtype(config)
    n_local = ctx_local.shape[1]
    act_ctx = act_rep = 0.0
    if gens is not None:
        shared, own = gens
        ctx_in = dropout(ctx_local, rate, own)
        output = dropout(output, rate, shared)
    else:
        ctx_in = ctx_local
    if config.num_attend_layers == 1:
        logits_local = ctx_proj if ctx_proj is not None else _dense(sharded["fc_a"], ctx_in, dtype=dt)[..., 0]
        # fc_b maps h to all N positions; this rank takes its block
        logits_h = copy_to(_dense(p["fc_b"], output, dtype=dt), group)
        start = mesh.index(AXIS) * n_local
        logits_local = logits_local + logits_h[:, start:start + n_local]
    else:
        t1 = ctx_proj if ctx_proj is not None else _dense(sharded["fc_1a"], ctx_in, activation="tanh", dtype=dt)
        t2 = _dense(p["fc_1b"], output, activation="tanh", dtype=dt)
        if gens is not None:
            act_ctx, act_rep = _l1(config, t1), _l1(config, t2)
        temp = t1 + copy_to(t2, group).unsqueeze(1)
        if gens is not None:
            temp = dropout(temp, rate, gens[1])
        logits_local = _dense(sharded["fc_2"], temp, dtype=dt)[..., 0]
    logits_local = logits_local.float()
    shift = all_reduce_max(logits_local.amax(dim=-1), group)                  # [B]
    e = torch.exp(logits_local - shift.unsqueeze(-1))                           # [B, Nl]
    denom = all_reduce_sum(e.sum(dim=-1), group)                                # [B]
    alpha_local = e / denom.unsqueeze(-1)
    context = reduce_from(torch.bmm(alpha_local.unsqueeze(1), ctx_local).squeeze(1), group)
    return context, alpha_local, (act_ctx, act_rep)


def _cp_step(params, sharded, config: Config, ctx_local, mesh, state: DecoderState, word, gens=None,
             ctx_proj=None):
    """``decoder_step``'s twin with the distributed attend; everything
    after the attend runs replicated.  Returns (state, logits, alpha_local,
    (activity block-sharded, activity replicated))."""
    context, alpha_local, (act_ctx, act_rep) = _cp_attend(
        params, sharded, config, ctx_local, state.output, mesh, gens, ctx_proj,
    )
    word_embed = embed(params, word)
    dt = compute_dtype(config)
    if gens is None:
        lstm_input = torch.cat([context, word_embed], dim=-1)
        new_c, new_h = lstm_step(params["lstm"], state.memory, state.recurrent, lstm_input, dtype=dt)
        expanded = torch.cat([new_h, context, word_embed], dim=-1)
        logits = decode_logits(params, config, expanded)
        return DecoderState(memory=new_c, output=new_h, recurrent=new_h), logits, alpha_local, (0.0, 0.0)
    shared = gens[0]
    ldr = config.lstm_drop_rate
    lstm_input = dropout(torch.cat([context, word_embed], dim=-1), ldr, shared)
    new_c, new_h = lstm_step(params["lstm"], state.memory, state.recurrent, lstm_input, dtype=dt)
    emitted = dropout(new_h, ldr, shared)
    recurrent = dropout(new_h, ldr, shared)
    expanded = torch.cat([emitted, context, word_embed], dim=-1)
    logits, dec_act = train_decode_logits(params, config, expanded, shared)
    new_state = DecoderState(memory=new_c, output=emitted, recurrent=recurrent)
    return new_state, logits, alpha_local, (act_ctx, act_rep + dec_act)


def _cp_remat_step(params, sharded, config, ctx_local, mesh, state, word, gens):
    """:func:`_cp_step` under ``remat_decoder``, both generators replayed
    (``models.decoder.replay_checkpoint``)."""
    step = functools.partial(_cp_step, params, sharded, config, ctx_local, mesh, gens=gens)
    return replay_checkpoint(step, list(gens), state, word)


def cp_teacher_forced(params, config: Config, contexts: torch.Tensor, sentences: torch.Tensor, mesh,
                      generator=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The context-parallel unroll over T steps (``teacher_forced_decode``'s
    twin) on this rank's rows: ``contexts`` [B, N, D] is the whole grid of
    these rows (replicated over the model group).  Returns (logits
    [B, T, V], alpha_local [B, T, Nl], the L1 activity of these rows'
    tanh outputs, whole over the grid)."""
    group = mesh.group(AXIS)
    cp = mesh.size(AXIS)
    B, T = sentences.shape
    train = generator is not None
    # the grid enters the sharded work: its gradient (train_cnn) summed
    ctx_local = _block(copy_to(contexts, group), mesh)
    context_mean = reduce_from(ctx_local.mean(dim=1) / cp, group)
    sharded = _sharded_params(params, config, group)
    words_in = torch.cat([sentences.new_zeros((B, 1)), sentences[:, :-1]], dim=1)
    if train:
        gens = (generator, shard_generator(generator, mesh.index(AXIS)))
        state, act_rep = train_init_from_mean(params, config, context_mean, generator)
        act_ctx = 0.0
        step = _cp_remat_step if config.remat_decoder else _cp_step
    else:
        gens, act_ctx, act_rep = None, 0.0, 0.0
        state = init_from_mean(params, config, context_mean)
        step = _cp_step
    logits, alphas = [], []
    for t in range(T):
        state, step_logits, alpha_local, (a_ctx, a_rep) = step(
            params, sharded, config, ctx_local, mesh, state, words_in[:, t], gens,
        )
        logits.append(step_logits)
        alphas.append(alpha_local)
        act_ctx = act_ctx + a_ctx
        act_rep = act_rep + a_rep
    if isinstance(act_ctx, torch.Tensor):
        act_rep = act_rep + reduce_from(act_ctx, group)
    return torch.stack(logits, dim=1), torch.stack(alphas, dim=1), act_rep


@torch.inference_mode()
def cp_beam_search(params, config: Config, contexts: torch.Tensor, eos_id: int, mesh,
                   beam_size: Optional[int] = None, max_len: Optional[int] = None,
                   valid_size: Optional[int] = None, return_alphas: bool = False) -> BeamResult:
    """The context-parallel beam search over this rank's rows: the grid
    [B, N, D] of the rows, split here to this rank's block; the context
    half of the attention MLP hoisted for the block.  Everything after
    the attend computes on replicated values, so words, scores and
    lengths are the same on every rank of the group (which agree each
    step's stop); the alphas are this block's [B, K, T, Nl]."""
    K = beam_size or config.beam_size
    group = mesh.group(AXIS)
    B = contexts.shape[0]
    ctx_local = _block(contexts, mesh).contiguous()
    context_mean = reduce_from(ctx_local.mean(dim=1) / mesh.size(AXIS), group)
    state0 = DecoderState(*(tile_beams(x, K) for x in init_from_mean(params, config, context_mean)))
    sharded = params["attend"]
    ctx_tiled = tile_beams(ctx_local, K)
    proj_tiled = tile_beams(precompute_attend(params, config, ctx_local), K)

    def step_fn(state, last_word):
        state, logits, alpha_local, _ = _cp_step(params, sharded, config, ctx_tiled, mesh, state, last_word,
                                                 ctx_proj=proj_tiled)
        return state, logits, alpha_local

    return run_search(
        config, step_fn, state0, B, eos_id, beam_size=K, max_len=max_len, valid_size=valid_size,
        return_alphas=return_alphas, alpha_width=ctx_local.shape[1], stop_group=group,
    )


def gather_alphas(alphas: torch.Tensor, mesh) -> torch.Tensor:
    """Full-grid alphas [..., N] from each rank's block [..., Nl]."""
    from .collectives import zero_padded_gather

    return zero_padded_gather(alphas.contiguous(), alphas.dim() - 1, mesh.index(AXIS), mesh.size(AXIS),
                              mesh.group(AXIS))

