"""Batched beam search — the port of the monolithic search of ``sat_tpu.ops.beam_search``.

Same semantics as the JAX package (its module docstring has the full
account): completed captions end with the terminator '.', accumulate in a
per-image top-K set while partial beams expand, scores are sums of
log-probabilities with no length normalization, each step takes the
global top-K continuations over beam×vocab (eos excluded), an eos
completion is a candidate only when eos is within its beam's top-(K+1)
words, and partial beams fill the result only when not enough captions
completed.

The JAX ``lax.while_loop`` becomes a Python loop that asks the device once
per step whether every image is sealed (``_sealed``): one host sync a
step, a known cost that CUDA graphs can remove later.

``jax.lax.top_k`` puts the lower index first among equal values, and the
search relies on it (dead beams and empty finished slots all sit at
``NEG_INF``); ``torch.topk`` promises no order among ties.  Every top-k
here goes through :func:`top_k`, which breaks ties the JAX way.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import Config
from ..models.decoder import DecoderState, decoder_step, init_state, precompute_attend

NEG_INF = -1e30
# Added to completed-caption scores when ranking them against live partial
# beams at the end of the search, so every completed caption outranks every
# partial one (scores are log-probs of ≤20 tokens, far above -1e6).
_FINISHED_RANK_BONUS = 1e6


class BeamResult(NamedTuple):
    """Per-image captions ranked finished-first, then by descending score."""

    words: torch.Tensor       # [B, K, T] int64 token ids ('.'-terminated)
    log_scores: torch.Tensor  # [B, K] sum of log p(word)
    lengths: torch.Tensor     # [B, K] number of emitted tokens
    alphas: Optional[torch.Tensor] = None  # [B, K, T, N] when return_alphas
    steps_run: Optional[int] = None        # decode steps run, when return_steps


class SearchState(NamedTuple):
    live_logp: torch.Tensor    # [B, K] cumulative log-prob of live beams
    live_words: torch.Tensor   # [B, K, T]
    live_len: torch.Tensor     # [B, K]
    last_word: torch.Tensor    # [B, K] input word of the next step
    fin_logp: torch.Tensor     # [B, K] finished top-K (NEG_INF = empty slot)
    fin_words: torch.Tensor    # [B, K, T]
    fin_len: torch.Tensor      # [B, K]
    live_alphas: torch.Tensor  # [B, K, T, An] (An = 0 unless return_alphas)
    fin_alphas: torch.Tensor   # [B, K, T, An]


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last axis,
    sorted descending, the lower index first among equal values — the
    order of ``jax.lax.top_k``.

    Each float32 value maps to an int64 key that orders like the float
    (its bit pattern, with the magnitude bits of negatives flipped),
    scaled by the axis length and offset by the reversed index, so keys
    are distinct and ``torch.topk`` has no ties left to order."""
    x = x.float().contiguous()
    n = x.shape[-1]
    bits = x.view(torch.int32).to(torch.int64)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    key = key * n + torch.arange(n - 1, -1, -1, device=x.device)
    idx = torch.topk(key, k, dim=-1).indices
    return torch.gather(x, -1, idx), idx


def _init_search(B: int, K: int, T: int, An: int, device) -> SearchState:
    # beam 0 alive at logp 0; others dead so step 0 expands a single beam
    live_logp = torch.full((B, K), NEG_INF, device=device)
    live_logp[:, 0] = 0.0
    zeros_bkt = torch.zeros((B, K, T), dtype=torch.int64, device=device)
    return SearchState(
        live_logp=live_logp,
        live_words=zeros_bkt,
        live_len=torch.zeros((B, K), dtype=torch.int64, device=device),
        last_word=torch.zeros((B, K), dtype=torch.int64, device=device),  # <start> = 0
        fin_logp=torch.full((B, K), NEG_INF, device=device),
        fin_words=zeros_bkt.clone(),
        fin_len=torch.zeros((B, K), dtype=torch.int64, device=device),
        live_alphas=torch.zeros((B, K, T, An), device=device),
        fin_alphas=torch.zeros((B, K, T, An), device=device),
    )


def _expand_step(
    eos_id: int,
    K: int,
    V: int,
    An: int,
    valid_size: Optional[int],
    new_state: DecoderState,
    logits: torch.Tensor,
    alpha: torch.Tensor,
    t: int,
    s: SearchState,
):
    """One beam-expansion step at time ``t`` over ``B`` rows; the decoder
    outputs are over the flattened [B*K] beam batch."""
    B = s.live_logp.shape[0]
    H = new_state.output.shape[-1]
    batch_idx = torch.arange(B, device=logits.device).unsqueeze(1)  # [B,1]

    if valid_size is not None and valid_size < V:
        logits = logits.clone()
        logits[:, valid_size:] = NEG_INF
    step_logp = torch.log_softmax(logits.float(), dim=-1).reshape(B, K, V)
    logp = step_logp + s.live_logp.unsqueeze(-1)           # [B,K,V] cumulative

    # completions: eos is a candidate only within its beam's top-(K+1)
    kth = top_k(step_logp, min(K + 1, V))[0][..., -1]     # [B,K]
    eos_allowed = step_logp[:, :, eos_id] >= kth
    eos_scores = torch.where(
        eos_allowed, logp[:, :, eos_id], torch.full_like(kth, NEG_INF)
    )
    eos_words = s.live_words.clone()
    eos_words[:, :, t] = eos_id
    cand_logp = torch.cat([s.fin_logp, eos_scores], dim=1)        # [B,2K]
    cand_words = torch.cat([s.fin_words, eos_words], dim=1)       # [B,2K,T]
    cand_len = torch.cat([s.fin_len, s.live_len + 1], dim=1)
    fin_logp, fin_sel = top_k(cand_logp, K)
    fin_words = cand_words[batch_idx, fin_sel]
    fin_len = cand_len[batch_idx, fin_sel]

    # continuations: global top-K over beam×vocab, eos excluded
    cont = logp.clone()
    cont[:, :, eos_id] = NEG_INF
    top_live, flat_sel = top_k(cont.reshape(B, K * V), K)   # [B,K]
    parent = flat_sel // V
    word = flat_sel % V

    def gather_bk(x):
        return x.reshape(B, K, -1)[batch_idx, parent].reshape(B * K, H)

    state = DecoderState(
        memory=gather_bk(new_state.memory),
        output=gather_bk(new_state.output),
        recurrent=gather_bk(new_state.recurrent),
    )
    live_words = s.live_words[batch_idx, parent]
    live_words[:, :, t] = word
    live_len = s.live_len[batch_idx, parent] + 1

    fin_alphas, live_alphas = s.fin_alphas, s.live_alphas
    if An:
        step_alpha = alpha.reshape(B, K, -1)[:, :, :An]            # [B,K,An]
        eos_alphas = s.live_alphas.clone()
        eos_alphas[:, :, t] = step_alpha
        cand_alphas = torch.cat([s.fin_alphas, eos_alphas], dim=1)
        fin_alphas = cand_alphas[batch_idx, fin_sel]
        live_alphas = s.live_alphas[batch_idx, parent]
        live_alphas[:, :, t] = step_alpha[batch_idx, parent]
    return state, SearchState(
        live_logp=top_live,
        live_words=live_words,
        live_len=live_len,
        last_word=word,
        fin_logp=fin_logp,
        fin_words=fin_words,
        fin_len=fin_len,
        live_alphas=live_alphas,
        fin_alphas=fin_alphas,
    )


def _sealed(fin_logp: torch.Tensor, live_logp: torch.Tensor) -> torch.Tensor:
    """[B] bool: rows whose merged result can no longer change — all K
    finished slots filled and the worst finished caption at or above the
    best live beam (live scores only fall)."""
    return torch.all(fin_logp > NEG_INF / 2, dim=1) & (
        fin_logp.min(dim=1).values >= live_logp.max(dim=1).values
    )


def _merge_results(
    s: SearchState, K: int, return_alphas: bool, steps: Optional[int] = None
) -> BeamResult:
    """Completed captions first; unfilled finished slots are backfilled
    from the live partial beams."""
    B = s.live_logp.shape[0]
    batch_idx = torch.arange(B, device=s.live_logp.device).unsqueeze(1)
    fin_valid = s.fin_logp > NEG_INF / 2
    rank_key = torch.cat(
        [
            torch.where(
                fin_valid, s.fin_logp + _FINISHED_RANK_BONUS,
                torch.full_like(s.fin_logp, NEG_INF),
            ),
            s.live_logp,
        ],
        dim=1,
    )                                                           # [B,2K]
    cand_logp = torch.cat([s.fin_logp, s.live_logp], dim=1)
    cand_words = torch.cat([s.fin_words, s.live_words], dim=1)
    cand_len = torch.cat([s.fin_len, s.live_len], dim=1)
    _, sel = top_k(rank_key, K)
    alphas = None
    if return_alphas:
        alphas = torch.cat([s.fin_alphas, s.live_alphas], dim=1)[batch_idx, sel]
    return BeamResult(
        words=cand_words[batch_idx, sel],
        log_scores=cand_logp[batch_idx, sel],
        lengths=cand_len[batch_idx, sel],
        alphas=alphas,
        steps_run=steps,
    )


def run_search(
    config: Config,
    step_fn,
    state0: DecoderState,
    B: int,
    eos_id: int,
    beam_size: Optional[int] = None,
    max_len: Optional[int] = None,
    valid_size: Optional[int] = None,
    return_alphas: bool = False,
    alpha_width: Optional[int] = None,
    early_exit: bool = True,
    return_steps: bool = False,
) -> BeamResult:
    """The search loop.  ``step_fn(state, last_word [B*K])`` returns
    (new_state, logits [B*K, V], alpha [B*K, N]); ``state0`` is already
    tiled to [B*K, H].  ``early_exit`` stops once every row is sealed —
    result-identical to running all T steps."""
    K = beam_size or config.beam_size
    T = max_len or config.max_caption_length
    V = config.vocabulary_size
    if return_alphas and alpha_width is None:
        raise ValueError("return_alphas requires alpha_width")
    An = (alpha_width or 0) if return_alphas else 0
    state = state0
    s = _init_search(B, K, T, An, state0.output.device)
    t = 0
    while t < T:
        new_state, logits, alpha = step_fn(state, s.last_word.reshape(B * K))
        state, s = _expand_step(
            eos_id, K, V, An, valid_size, new_state, logits, alpha, t, s
        )
        t += 1
        # one host sync per step: the exact early exit
        if early_exit and bool(_sealed(s.fin_logp, s.live_logp).all()):
            break
    return _merge_results(s, K, return_alphas, steps=t if return_steps else None)


def tile_beams(x: torch.Tensor, K: int) -> torch.Tensor:
    """[B, ...] -> [B*K, ...], each row repeated K times (a contiguous copy)."""
    B = x.shape[0]
    # reshape may return a stride-0 view when B == 1; the kernel needs real rows
    return x.unsqueeze(1).expand(B, K, *x.shape[1:]).reshape(B * K, *x.shape[1:]).contiguous()


def beam_search(
    params,
    config: Config,
    contexts: torch.Tensor,
    eos_id: int,
    beam_size: Optional[int] = None,
    max_len: Optional[int] = None,
    valid_size: Optional[int] = None,
    return_alphas: bool = False,
    early_exit: bool = True,
    return_steps: bool = False,
) -> BeamResult:
    """Decode captions for a batch of context grids [B, N, D] float32.

    ``params`` is the decoder parameter dict; ``valid_size`` masks logit
    columns past the real vocabulary; ``return_alphas`` carries each
    hypothesis' per-step attention maps."""
    K = beam_size or config.beam_size
    B, N, _ = contexts.shape
    ctx_tiled = tile_beams(contexts, K)
    proj_tiled = tile_beams(precompute_attend(params, config, contexts), K)
    state0 = DecoderState(*(tile_beams(x, K) for x in init_state(params, config, contexts)))

    def step_fn(state, last_word):
        return decoder_step(params, config, ctx_tiled, state, last_word, ctx_proj=proj_tiled)

    return run_search(
        config, step_fn, state0, B, eos_id,
        beam_size=K, max_len=max_len, valid_size=valid_size,
        return_alphas=return_alphas, alpha_width=N, early_exit=early_exit,
        return_steps=return_steps,
    )
