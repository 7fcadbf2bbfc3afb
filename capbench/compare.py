"""The comparisons that decide ``correct``: what the timed path produced,
against the plain reference (``reference.model``) on the same inputs and
weights, in float32 with TF32 off.

The encoder is checked by itself, and the decoder and the search from the
program's own contexts, so that each stage's rounding is judged alone:

* ``contexts_off10``: the share of the sampled context elements that lie
  more than 10% off the reference encoder's (elements the reference holds
  at 0, relu's, left out).  bf16 rounds each element by a share of
  itself, int8 and fp8 by a share of the whole tensor, so small elements
  drift far under the latter: this share separates the precisions more
  widely than a norm of the difference does;
* ``score_err``: the widest gap, in nats, between a returned caption's
  score and the reference decoder's score of the same words on the same
  contexts, over every returned beam;
* ``search_slack``: the widest margin, in nats and by the reference's
  step log-probabilities, by which the returned beams break what a beam
  search keeps (:func:`search_slack`): a one-word extension that the
  search dropped above a sibling it kept, beams out of their own order or
  returned twice, an end token admitted outside its beam's K + 1 best
  words.  It compares siblings within one step, so a near-tie costs one
  step's rounding and no more.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .reference import model as ref

OFF_SHARE = 0.10   # an element is off when further than this share of itself from the reference
OFF_FLOOR = 1e-6   # elements under this share of the largest are the reference's zeros
FINISHED = 1e6     # ranks a finished caption above every live one (the search's own rule)


def _finished(words: torch.Tensor, lengths: torch.Tensor, eos: int) -> torch.Tensor:
    """[..., K] bool: the caption ends with the end token."""
    last = words.gather(-1, (lengths - 1).clamp_min(0).unsqueeze(-1))[..., 0]
    return (lengths >= 1) & (last == eos)


def search_slack(logp: torch.Tensor, words: torch.Tensor, lengths: torch.Tensor, scores: torch.Tensor,
                 eos: int) -> torch.Tensor:
    """[b] per image: the widest margin by which the returned beams
    (``words`` [b, K, T], ``lengths`` [b, K], the program's ``scores``
    [b, K]) break the beam search's rules, read from the reference's step
    log-probabilities ``logp`` [b, K, T, V] of each returned caption's
    prefixes.  At most 0, up to one step's rounding, for a search that
    keeps at each step the K best one-word extensions of its live beams
    (the end token left out).

    At step t the kept set holds K extensions; the returned beams' live
    prefixes R_t of length t + 1 are some of them, and the others died
    later.  Every extension that was not kept lies at or below the least
    kept, and so below the least kept child of its own parent: among the
    extensions of R_{t-1} outside R_t, at most K - |R_t| (the kept ones
    that died) may lie above the least returned child of the same parent.
    The step's margin is the (K - |R_t| + 1)-th largest of those gaps.  A
    gap between siblings is one step's log-probabilities, so the rounding
    of the earlier steps, which differs from path to path, stays out.

    Beside it: the program's scores out of its own order (finished first,
    then by score), the same caption twice (infinite), and a finished
    caption whose end token lies below its beam's K + 1 best words at its
    last step."""
    b, K, T, V = logp.shape
    dev = logp.device
    finished = _finished(words, lengths, eos)
    live = lengths - finished.long()
    rows = torch.arange(b, device=dev).unsqueeze(1).expand(b, K)
    beams = torch.arange(K, device=dev).unsqueeze(0).expand(b, K)
    earlier = torch.ones(K, K, dtype=torch.bool, device=dev).tril(-1)  # [k, j]: j before k
    none = torch.full((b,), -float("inf"), dtype=torch.float64, device=dev)

    key = scores.double() + FINISHED * finished
    worst = (key[:, 1:] - key[:, :-1]).amax(1) if K > 1 else none
    tt = torch.arange(T, device=dev)
    shown = torch.where(tt < lengths.unsqueeze(-1), words, torch.full_like(words, -1))
    twice = ((shown.unsqueeze(2) == shown.unsqueeze(1)).all(-1) & earlier).any(-1).any(-1)
    worst = torch.where(twice, torch.full_like(worst, float("inf")), worst)

    at_end = logp[rows, beams, (lengths - 1).clamp_min(0)]                    # [b, K, V]
    admit = (at_end.topk(min(K + 1, V), dim=-1).values[..., -1] - at_end[..., eos]).double()
    worst = torch.maximum(worst, torch.where(finished, admit, none.unsqueeze(1)).amax(1))

    for t in range(T):
        same = (words[:, :, None, :t] == words[:, None, :, :t]).all(-1)      # [b, K, K] equal prefixes
        parent = live >= t
        child = live >= t + 1
        first = parent & ~(same & parent.unsqueeze(1) & earlier).any(-1)
        of = (same & parent.unsqueeze(1)).int().argmax(-1)                   # each prefix's first beam
        step = logp[:, :, t].double()                                         # [b, K, V], by parent
        chosen = step[rows, of, words[:, :, t]]                               # each child's log-prob
        mine = (of.unsqueeze(2) == beams.unsqueeze(1)).transpose(1, 2) & child.unsqueeze(1)  # [b, p, j]
        least = torch.where(mine, chosen.unsqueeze(1), torch.full_like(mine, float("inf"), dtype=step.dtype))
        least = least.amin(-1)                                                 # [b, p]
        gap = torch.where((first & mine.any(-1)).unsqueeze(-1), step - least.unsqueeze(-1),
                          torch.full_like(step, -float("inf")))
        gap[..., eos] = -float("inf")
        gap[rows[child], of[child], words[:, :, t][child]] = -float("inf")    # the returned extensions
        grown = (words[:, :, None, :t + 1] == words[:, None, :, :t + 1]).all(-1)
        kept = (child & ~(grown & child.unsqueeze(1) & earlier).any(-1)).sum(1)
        best = gap.reshape(b, K * V).topk(K + 1, dim=-1).values
        over = best.gather(1, (K - kept).clamp(0, K).unsqueeze(1))[:, 0]
        worst = torch.maximum(worst, torch.where(kept > 0, over, none))
    return worst


@torch.no_grad()
def caption_checks(cfg: Dict, flat: Dict[str, torch.Tensor], images: torch.Tensor,
                   words: torch.Tensor, scores: torch.Tensor, lengths: torch.Tensor,
                   contexts: Optional[torch.Tensor] = None, block: int = 64
                   ) -> Tuple[Dict[str, float], Dict[str, torch.Tensor]]:
    """(readings {number: value}, {number: [M] per-image reading}) of the
    program's captions (``words`` [M, K, T], ``scores`` [M, K], ``lengths``
    [M, K]) of ``images`` [M, S, S, 3], decoded from its ``contexts``
    [M, N, D].  Without ``contexts`` (a path whose contexts the run cannot
    capture) the reference's stand in and ``contexts_off10`` is not read."""
    ref.no_tf32()
    dec = ref.Decoder(cfg, flat)
    eos = cfg["eos_id"]
    M, K, T = words.shape
    off = live = 0
    score_err, ctx_off, slack = [], [], []
    for i in range(0, M, block):
        rc = ref.encode(cfg, flat, images[i:i + block])
        if contexts is not None:
            pc = contexts[i:i + block].float()
            nz = rc.abs() > OFF_FLOOR * rc.abs().amax()
            far = ((pc - rc).abs() > OFF_SHARE * rc.abs()) & nz
            off, live = off + int(far.sum()), live + int(nz.sum())
            ctx_off.append(far.flatten(1).sum(1) / nz.flatten(1).sum(1).clamp_min(1))
            rc = pc
        w, s, n = words[i:i + block].long(), scores[i:i + block].float(), lengths[i:i + block].long()
        b = w.shape[0]
        logp = ref.step_logps(dec, ref.tile(rc, K), w.reshape(b * K, T))
        rescored = ref.score_words(logp, w.reshape(b * K, T), n.reshape(-1)).view(b, K)
        score_err.append((s - rescored).abs().amax(dim=1))
        slack.append(search_slack(logp.view(b, K, T, -1), w, n, s, eos))
        del logp
    score_err, slack = torch.cat(score_err), torch.cat(slack)
    readings = {"score_err": float(score_err.max()), "search_slack": float(slack.max())}
    per_image = {"score_err": score_err, "search_slack": slack}
    if contexts is not None:
        readings["contexts_off10"] = off / max(live, 1)
        per_image["contexts_off10"] = torch.cat(ctx_off)
    return readings, per_image


def judge(readings: Dict[str, float], per_image: Dict[str, torch.Tensor], limits: Dict[str, float]):
    """(checks {number: {value, limit}}, sampled images over a limit).  A
    NaN reads as infinitely wide."""
    checks = {}
    for name, value in readings.items():
        checks[name] = {"value": value if value == value else float("inf"), "limit": float(limits[name])}
    bad = None
    for name, v in per_image.items():
        over = torch.nan_to_num(v.float(), nan=float("inf")) > limits[name]
        bad = over if bad is None else bad | over
    return checks, int(bad.sum()) if bad is not None else 0
