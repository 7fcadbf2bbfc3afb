"""Batched beam search — the port of ``sat_tpu.ops.beam_search``.

Same semantics as the JAX package (its module docstring has the full
account): completed captions end with the terminator '.', accumulate in a
per-image top-K set while partial beams expand, scores are sums of
log-probabilities with no length normalization, each step takes the
global top-K continuations over beam×vocab (eos excluded), an eos
completion is a candidate only when eos is within its beam's top-(K+1)
words, and partial beams fill the result only when not enough captions
completed.

Two loops run the same expansion (``_expand_step``): the monolithic
search (``run_search``), whose JAX ``lax.while_loop`` becomes a Python
loop that asks the device once per step whether every image is sealed
(``_sealed``): one host sync a step, a known cost that CUDA graphs can
remove later; and the stepped decode of the slot pool (``SlotCarry``,
``decode_step``, ``decode_multi_step``), where each slot of a fixed pool
has its own time index and advances only while it is active.  Its fused
window runs ``k`` steps with no host sync at all (see
:func:`decode_multi_step`).

``jax.lax.top_k`` puts the lower index first among equal values, and the
search relies on it (dead beams and empty finished slots all sit at
``NEG_INF``); ``torch.topk`` promises no order among ties.  Every top-k
here goes through :func:`top_k`, which breaks ties the JAX way.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

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
    # decode steps run, when return_steps: an int from run_search, the
    # per-slot [S] time index from harvest_slots
    steps_run: Optional[Union[int, torch.Tensor]] = None


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
    t_vec: torch.Tensor,
    s: SearchState,
):
    """One beam-expansion step over ``B`` rows; the decoder outputs are
    over the flattened [B*K] beam batch.  ``t_vec`` [B] is each row's own
    time index (the monolithic search passes its loop counter to every
    row); time-indexed writes are a one-hot select over T, as in the JAX
    package."""
    B = s.live_logp.shape[0]
    T = s.live_words.shape[2]
    H = new_state.output.shape[-1]
    batch_idx = torch.arange(B, device=logits.device).unsqueeze(1)  # [B,1]
    t_hot = torch.arange(T, device=logits.device).unsqueeze(0) == t_vec.unsqueeze(1)  # [B,T]
    t_words = t_hot.unsqueeze(1)                                    # [B,1,T]

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
    eos_words = torch.where(t_words, eos_id, s.live_words)
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
    live_words = torch.where(t_words, word.unsqueeze(-1), s.live_words[batch_idx, parent])
    live_len = s.live_len[batch_idx, parent] + 1

    fin_alphas, live_alphas = s.fin_alphas, s.live_alphas
    if An:
        t_alphas = t_words.unsqueeze(-1)                               # [B,1,T,1]
        step_alpha = alpha.reshape(B, K, -1)[:, :, :An]            # [B,K,An]
        eos_alphas = torch.where(t_alphas, step_alpha.unsqueeze(2), s.live_alphas)
        cand_alphas = torch.cat([s.fin_alphas, eos_alphas], dim=1)
        fin_alphas = cand_alphas[batch_idx, fin_sel]
        live_alphas = torch.where(
            t_alphas, step_alpha[batch_idx, parent].unsqueeze(2), s.live_alphas[batch_idx, parent]
        )
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
    s: SearchState, K: int, return_alphas: bool, steps=None
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
        t_vec = torch.full((B,), t, dtype=torch.int64, device=logits.device)
        state, s = _expand_step(
            eos_id, K, V, An, valid_size, new_state, logits, alpha, t_vec, s
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


# ---------------------------------------------------------------------------
# Stepped decode over a slot pool: continuous serving's path
# ---------------------------------------------------------------------------


class SlotCarry(NamedTuple):
    """The whole resumable state of an S-slot decode pool, each leaf of
    fixed shape for a pool geometry.  Slots advance independently: ``t``
    is each slot's own time index and ``alive`` its in-flight flag; rows
    of inactive slots pass through every function unchanged (selects
    only, no writes at data-dependent offsets)."""

    ctx: torch.Tensor        # [S*K, N, D] per-slot context grid, K-tiled
    ctx_proj: torch.Tensor   # [S*K, N] or [S*K, N, da] hoisted attention
    state: DecoderState      # [S*K, H] LSTM carry
    search: SearchState      # [S, ...] beam bookkeeping
    t: torch.Tensor          # [S] int64 per-slot time index
    alive: torch.Tensor      # [S] bool: seeded and not yet finished


def _select(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """``new`` where ``mask`` (over the leading axis), else ``old``."""
    return torch.where(mask.reshape(mask.shape + (1,) * (old.dim() - 1)), new, old)


def init_slot_pool(
    config: Config,
    slots: int,
    beam_size: Optional[int] = None,
    max_len: Optional[int] = None,
    return_alphas: bool = False,
    device=None,
) -> SlotCarry:
    """An empty pool on ``device``: all slots dead, all state zeroed;
    ``return_alphas`` carries each hypothesis' attention maps."""
    K = beam_size or config.beam_size
    T = max_len or config.max_caption_length
    N, D, H = config.num_ctx, config.dim_ctx, config.num_lstm_units
    An = N if return_alphas else 0
    SK = int(slots) * K
    if config.num_attend_layers == 1:
        ctx_proj = torch.zeros((SK, N), device=device)
    else:
        ctx_proj = torch.zeros((SK, N, config.dim_attend_layer), device=device)
    return SlotCarry(
        ctx=torch.zeros((SK, N, D), device=device),
        ctx_proj=ctx_proj,
        state=DecoderState(*(torch.zeros((SK, H), device=device) for _ in range(3))),
        search=_init_search(int(slots), K, T, An, device),
        t=torch.zeros((int(slots),), dtype=torch.int64, device=device),
        alive=torch.zeros((int(slots),), dtype=torch.bool, device=device),
    )


def init_slots(
    params,
    config: Config,
    carry: SlotCarry,
    lane_ctx: torch.Tensor,
    slot_src: torch.Tensor,
    admit_mask: torch.Tensor,
    beam_size: Optional[int] = None,
) -> SlotCarry:
    """Seed slots anywhere in the pool from one encoded admission lane.

    ``lane_ctx`` [L, N, D]: the encoder output of the admitted images.
    ``slot_src`` [S] int64: the lane row each slot gathers (rows of slots
    not admitted are ignored; point them at 0).  ``admit_mask`` [S] bool:
    those slots restart a fresh t=0 search over their lane row; the
    others keep their state.  The init runs pool-wide, one gather and one
    select, whichever slots are handed out."""
    K = beam_size or config.beam_size
    S = carry.t.shape[0]
    T = carry.search.live_words.shape[2]
    An = carry.search.live_alphas.shape[3]

    contexts = lane_ctx[slot_src]                                  # [S, N, D]
    ctx_new = tile_beams(contexts, K)
    proj_new = tile_beams(precompute_attend(params, config, contexts), K)
    st = DecoderState(*(tile_beams(x, K) for x in init_state(params, config, contexts)))
    fresh = _init_search(S, K, T, An, contexts.device)
    row_mask = tile_beams(admit_mask, K)                           # [S*K]
    return SlotCarry(
        ctx=_select(row_mask, ctx_new, carry.ctx),
        ctx_proj=_select(row_mask, proj_new, carry.ctx_proj),
        state=DecoderState(*(_select(row_mask, n, o) for n, o in zip(st, carry.state))),
        search=SearchState(*(_select(admit_mask, n, o) for n, o in zip(fresh, carry.search))),
        t=_select(admit_mask, torch.zeros_like(carry.t), carry.t),
        alive=carry.alive | admit_mask,
    )


def decode_step(
    params,
    config: Config,
    carry: SlotCarry,
    slot_mask: torch.Tensor,
    eos_id: int,
    beam_size: Optional[int] = None,
    valid_size: Optional[int] = None,
):
    """Advance every active slot by one decode step; returns
    ``(carry, done)``.

    ``slot_mask`` [S] bool is the host's view of which slots hold
    requests; a slot advances only when it and ``carry.alive`` are both
    set.  ``done`` [S] flags the slots that finished this step: sealed
    (:func:`_sealed`, as in the monolithic search) or out of time.  The
    decoder runs over all S*K rows; ``row_mask`` zeroes the attention of
    inactive rows inside ``fused_attend``, so a retired slot's stale state
    cannot make a NaN there, and the selects below keep their old carry.
    With no slot active the step is an exact no-op."""
    K = beam_size or config.beam_size
    S = carry.t.shape[0]
    T = carry.search.live_words.shape[2]
    V = config.vocabulary_size
    An = carry.search.live_alphas.shape[3]
    active = slot_mask & carry.alive                               # [S]
    row_active = tile_beams(active, K)                             # [S*K]

    new_state, logits, alpha = decoder_step(
        params, config, carry.ctx, carry.state,
        carry.search.last_word.reshape(S * K),
        ctx_proj=carry.ctx_proj, row_mask=row_active,
    )
    g_state, stepped = _expand_step(
        eos_id, K, V, An, valid_size, new_state, logits, alpha, carry.t, carry.search
    )
    state = DecoderState(*(_select(row_active, n, o) for n, o in zip(g_state, carry.state)))
    search = SearchState(*(_select(active, n, o) for n, o in zip(stepped, carry.search)))
    t = torch.where(active, carry.t + 1, carry.t)
    sealed = _sealed(search.fin_logp, search.live_logp)
    alive = torch.where(active, ~sealed & (t < T), carry.alive)
    done = active & ~alive
    return carry._replace(state=state, search=search, t=t, alive=alive), done


def decode_multi_step(
    params,
    config: Config,
    carry: SlotCarry,
    slot_mask: torch.Tensor,
    eos_id: int,
    k: int = 1,
    beam_size: Optional[int] = None,
    valid_size: Optional[int] = None,
):
    """Up to ``k`` decode steps with no host sync; returns
    ``(carry, done, steps_run)``, all on the device.

    The JAX package runs this as an on-device ``lax.while_loop`` that
    exits once no slot is active.  Here the host enqueues all ``k``
    iterations of :func:`decode_step` without asking the device anything:
    an iteration with no active slot is an exact no-op, so the carry and
    ``done`` (every slot that finished anywhere in the window) are
    bitwise those of the early-exiting loop, and ``steps_run`` counts on
    the device the iterations before which a slot was still active.  The
    price: a pool that drains mid-window still spends the window's
    remaining iterations on the device."""
    S = carry.t.shape[0]
    done = torch.zeros((S,), dtype=torch.bool, device=carry.t.device)
    steps_run = torch.zeros((), dtype=torch.int64, device=carry.t.device)
    for _ in range(int(k)):
        steps_run = steps_run + (slot_mask & carry.alive).any()
        carry, step_done = decode_step(
            params, config, carry, slot_mask, eos_id,
            beam_size=beam_size, valid_size=valid_size,
        )
        done = done | step_done
    return carry, done, steps_run


def retire_slots(carry: SlotCarry, retire_mask: torch.Tensor) -> SlotCarry:
    """Mark slots dead after harvest (``decode_step`` already cleared
    ``alive`` for finished slots; this also cancels a running one)."""
    return carry._replace(alive=carry.alive & ~retire_mask)


def harvest_slots(carry: SlotCarry, return_alphas: bool = False) -> BeamResult:
    """Every slot's merged result [S, ...] (the host slices the rows it
    harvests); ``steps_run`` is the per-slot [S] step count."""
    K = carry.search.live_logp.shape[1]
    return _merge_results(carry.search, K, return_alphas, steps=carry.t)
