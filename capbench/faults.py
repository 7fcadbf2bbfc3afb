"""Faults planted in the program's timed path, each of which a run has to
judge not correct: the CPU tests plant them at a tiny size, and
``capbench.readings --fault <name>`` at a cell's own size on the card.
The benchmark's own runs never plant one.

    with planted("rank_drop"):
        ...  # the program runs with the fault in place
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator

import torch


def _swap(module, name: str, make: Callable) -> Callable[[], None]:
    inner = getattr(module, name)
    setattr(module, name, make(inner))
    return lambda: setattr(module, name, inner)


def alter_a_token():
    """The first beam's second word of every caption replaced by another."""
    from sat_tpu_torch import runtime

    def make(inner):
        def altered(*a, **k):
            out = inner(*a, **k)
            words = out.words.clone()
            words[:, 0, 1] = (words[:, 0, 1] % 40) + 3
            return out._replace(words=words)
        return altered

    return _swap(runtime, "beam_search", make)


def half_the_batch():
    """Only the first half of each batch encoded; the second half gets the
    first half's contexts again."""
    from sat_tpu_torch import runtime

    def make(inner):
        def half(params, config, images):
            out = inner(params, config, images[: images.shape[0] // 2])
            return torch.cat([out, out])
        return half

    return _swap(runtime, "encode", make)


def state_unchanged():
    """A decoder step that returns the LSTM state it was given."""
    from sat_tpu_torch.models import decoder
    from sat_tpu_torch.ops import beam_search

    def make(_):
        def stale(params, config, contexts, state, word, **k):
            _, logits, alpha = decoder.decoder_step(params, config, contexts, state, word, **k)
            return state, logits, alpha
        return stale

    return _swap(beam_search, "decoder_step", make)


def _continuations(x: torch.Tensor, k: int) -> bool:
    """The search's top-k over beam x vocabulary, [B, K * V] (its other
    top-k calls take K + 1 of each beam's words, or K of 2K candidates)."""
    return x.dim() == 2 and x.shape[-1] > 2 * k


def rank_drop():
    """The search keeps the 2nd to (K+1)-th best continuations each step
    instead of the K best."""
    from sat_tpu_torch.ops import beam_search

    def make(inner):
        def dropped(x, k):
            if not _continuations(x, k):
                return inner(x, k)
            values, indices = inner(x, k + 1)
            return values[..., 1:], indices[..., 1:]
        return dropped

    return _swap(beam_search, "top_k", make)


FAULTS: Dict[str, Callable[[], Callable[[], None]]] = {
    f.__name__: f for f in (alter_a_token, half_the_batch, state_unchanged, rank_drop)
}


@contextlib.contextmanager
def planted(name: str) -> Iterator[None]:
    undo = FAULTS[name]()
    try:
        yield
    finally:
        undo()
