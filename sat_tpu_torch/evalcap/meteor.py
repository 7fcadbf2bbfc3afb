"""METEOR 1.5 — the port's copy of ``sat_tpu.evalcap.meteor``'s Python
scorer (no JVM, no native library).

The reference toolkit wraps the external ``meteor-1.5.jar``; the JAX
package reimplements METEOR 1.5 (Denkowski & Lavie 2014, "Meteor
Universal") in Python with a C++ twin, and the port keeps the Python one:

* the 1.5 English matcher set and weights — exact 1.0, Porter-stem 0.6,
  synonym 0.8, paraphrase phrase spans 0.6 — resolved jointly the way
  the jar's beam aligner does: every matcher proposes candidates and a
  beam search (width 40, the jar's default) selects the non-overlapping
  subset that maximizes covered words, then minimizes chunks, then
  minimizes summed start distance;
* the 1.5 scoring with the English rank-tuned parameters α=0.85, β=0.2,
  γ=0.6, δ=0.75: content/function-word-discounted weighted precision and
  recall, Fmean = P·R/(α·P+(1−α)·R), fragmentation penalty
  γ·(chunks/matches)^β applied only when the alignment has more than one
  chunk (an exact hypothesis scores exactly 1.0);
* multi-reference: score against every reference, keep the max.

The stem stage is ``evalcap.porter`` (the original Porter algorithm, as
the JAX package's C++ stemmer and nltk's ORIGINAL_ALGORITHM mode run it).
The synonym and paraphrase stages use the compact tables of
``evalcap.meteor_data`` instead of full WordNet and the jar's ~80MB
paraphrase table, and ``_candidates`` drops two paraphrase-candidate
classes (1×1 spans duplicating a word match, identical phrase spans);
the JAX package's module docstring quantifies both divergences from the
jar.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .meteor_data import (
    FUNCTION_WORDS,
    MAX_PARAPHRASE_LEN,
    build_paraphrase_index,
    build_synonym_index,
)
from .porter import stem

# METEOR 1.5 English (rank-tuned) parameters — Denkowski & Lavie 2014,
# Table 1 (the jar's `-l en` defaults, reference meteor.py:18-19).
ALPHA = 0.85
BETA = 0.2
GAMMA = 0.6
DELTA = 0.75

EXACT_WEIGHT = 1.0
STEM_WEIGHT = 0.6
SYNONYM_WEIGHT = 0.8
PARAPHRASE_WEIGHT = 0.6

_syn_index: Optional[Dict[str, Set[int]]] = None
_para_index: Optional[Dict[str, Set[int]]] = None


def _synonyms() -> Dict[str, Set[int]]:
    global _syn_index
    if _syn_index is None:
        _syn_index = build_synonym_index()
    return _syn_index


def _paraphrases() -> Dict[str, Set[int]]:
    global _para_index
    if _para_index is None:
        _para_index = build_paraphrase_index()
    return _para_index


# Beam width of the alignment resolution — the jar's default
# (Aligner.java's beamSize); at caption lengths the beam is effectively
# exhaustive.
ALIGN_BEAM = 40


def _candidates(hyp: Sequence[str], ref: Sequence[str]):
    """All matcher-generated candidate matches, jointly.

    Returns ``(word_cands, span_cands)`` where ``word_cands[i]`` is a list
    of ``(j, weight)`` single-word matches for hyp position i (weight from
    the highest-precedence applicable matcher: exact 1.0, stem 0.6,
    synonym 0.8 — matcher precedence, not weight order, mirroring the
    jar's module order) and ``span_cands[i]`` lists paraphrase phrase
    matches ``(L, j, M)`` starting at hyp position i (hyp span length L,
    ref start j, ref span length M, weight 0.6).
    """
    syn = _synonyms()
    para = _paraphrases()
    word_cands: List[List[Tuple[int, float]]] = [[] for _ in hyp]
    for i, h in enumerate(hyp):
        h_stem = stem(h)
        h_gids = syn.get(h)
        for j, r in enumerate(ref):
            if h == r:
                word_cands[i].append((j, EXACT_WEIGHT))
            elif h_stem == stem(r):
                word_cands[i].append((j, STEM_WEIGHT))
            elif h_gids and syn.get(r) and (h_gids & syn[r]):
                word_cands[i].append((j, SYNONYM_WEIGHT))

    span_cands: List[List[Tuple[int, int, int]]] = [[] for _ in hyp]
    ref_spans: Dict[int, List[Tuple[int, int]]] = {}  # gid -> [(j, M)]
    for M in range(1, MAX_PARAPHRASE_LEN + 1):
        for j in range(0, len(ref) - M + 1):
            for gid in para.get(" ".join(ref[j:j + M]), ()):
                ref_spans.setdefault(gid, []).append((j, M))
    for L in range(1, MAX_PARAPHRASE_LEN + 1):
        for i in range(0, len(hyp) - L + 1):
            gids = para.get(" ".join(hyp[i:i + L]))
            if not gids:
                continue
            seen: Set[Tuple[int, int]] = set()
            for gid in gids:
                for j, M in ref_spans.get(gid, ()):
                    if (j, M) in seen:
                        continue
                    # a 1×1 phrase match duplicating a word match adds no
                    # coverage and never more weight — drop it
                    if L == 1 and M == 1 and any(
                        cj == j for cj, _ in word_cands[i]
                    ):
                        continue
                    # identical phrases are fully served by exact word
                    # matches at weight 1.0; a 0.6 phrase match for the
                    # same string could only displace them (its single
                    # start-distance beats their per-word sum in the
                    # distance tiebreak) and lower the score
                    if L == M and list(hyp[i:i + L]) == list(ref[j:j + M]):
                        continue
                    seen.add((j, M))
                    span_cands[i].append((L, j, M))
    return word_cands, span_cands


def align(
    hyp: Sequence[str], ref: Sequence[str]
) -> Tuple[List[Tuple[int, int, float]], Dict[int, float], Dict[int, float]]:
    """Alignment resolution over all matcher candidates, beam-searched.

    METEOR 1.5's aligner does not consume words stage by stage: every
    matcher (exact / stem / synonym / paraphrase) proposes candidate
    matches and the aligner selects the non-overlapping subset that, in
    order of importance, (1) maximizes covered words across both
    sentences, (2) minimizes the number of chunks, (3) minimizes the sum
    of |hyp_start - ref_start| distances (Denkowski & Lavie 2014 §3;
    the jar's Aligner.resolve).  This beam search reproduces those
    semantics (width ALIGN_BEAM, exhaustive at caption lengths).

    Returns ``(pairs, hyp_matched, ref_matched)``: ``pairs`` are
    (hyp_idx, ref_idx, weight) word pairings used for chunk counting
    (paraphrase spans zip min(L, M) internally-monotone pairs); the two
    dicts map matched word index → match weight per side (they diverge
    from the pair list only for paraphrase span matches, whose sides may
    cover different word counts).
    """
    word_cands, span_cands = _candidates(hyp, ref)

    # state: (covered, chunks, dist, -weight) lexicographic score plus
    # (ref_mask, last_i, last_j, pairs, hyp_cov, ref_cov); smaller sort
    # key is better
    start = (0, 0, 0, 0.0, 0, -2, -2, (), (), ())
    pools: Dict[int, List] = {0: [start]}

    def key(st):
        covered, chunks, dist, weight = st[0], st[1], st[2], st[3]
        # hcov/rcov in the tiebreak: two optima can have identical pairs
        # but different per-side coverage (a 2→1 vs a 1→2 paraphrase span
        # anchored at the same positions), which changes P/R — without
        # them the winner would be insertion-order luck
        return (-covered, chunks, dist, -weight, st[7], st[8], st[9])

    for pos in range(len(hyp)):
        pool = pools.pop(pos, None)
        if not pool:
            continue
        # dedup on (ref_mask, run tail): states identical there extend
        # identically, keep the best-scored representative
        best_by: Dict[Tuple[int, int, int], tuple] = {}
        for st in pool:
            k = (st[4], st[5], st[6])
            if k not in best_by or key(st) < key(best_by[k]):
                best_by[k] = st
        pool = sorted(best_by.values(), key=key)[:ALIGN_BEAM]

        for st in pool:
            (covered, chunks, dist, weight, mask, li, lj,
             pairs, hcov, rcov) = st
            # option: leave hyp word `pos` uncovered
            pools.setdefault(pos + 1, []).append(st)
            for j, w in word_cands[pos]:
                if mask & (1 << j):
                    continue
                adj = pos == li + 1 and j == lj + 1
                pools.setdefault(pos + 1, []).append((
                    covered + 2, chunks + (0 if adj else 1),
                    dist + abs(pos - j), weight + w,
                    mask | (1 << j), pos, j,
                    pairs + ((pos, j, w),),
                    hcov + ((pos, w),), rcov + ((j, w),),
                ))
            for L, j, M in span_cands[pos]:
                span_mask = ((1 << M) - 1) << j
                if mask & span_mask:
                    continue
                z = min(L, M)
                adj = pos == li + 1 and j == lj + 1
                pools.setdefault(pos + L, []).append((
                    covered + L + M, chunks + (0 if adj else 1),
                    dist + abs(pos - j), weight + z * PARAPHRASE_WEIGHT,
                    mask | span_mask, pos + z - 1, j + z - 1,
                    pairs + tuple(
                        (pos + k, j + k, PARAPHRASE_WEIGHT) for k in range(z)
                    ),
                    hcov + tuple(
                        (pos + k, PARAPHRASE_WEIGHT) for k in range(L)
                    ),
                    rcov + tuple(
                        (j + k, PARAPHRASE_WEIGHT) for k in range(M)
                    ),
                ))

    finals = pools.get(len(hyp), [start])
    best = min(finals, key=key)
    return sorted(best[7]), dict(best[8]), dict(best[9])


def _chunks(matches: List[Tuple[int, int, float]]) -> int:
    """Number of maximal runs adjacent in both hyp and ref order."""
    if not matches:
        return 0
    chunks = 1
    for (i0, j0, _), (i1, j1, _) in zip(matches, matches[1:]):
        if not (i1 == i0 + 1 and j1 == j0 + 1):
            chunks += 1
    return chunks


def _weighted_split(
    words: Sequence[str], matched: Dict[int, float]
) -> Tuple[float, float]:
    """(Σ w over matched content words, Σ w over matched function words)."""
    wc = wf = 0.0
    for idx, w in matched.items():
        if words[idx] in FUNCTION_WORDS:
            wf += w
        else:
            wc += w
    return wc, wf


def _side_score(words: Sequence[str], matched: Dict[int, float]) -> float:
    """δ-discounted weighted match fraction for one side (P or R)."""
    n_f = sum(1 for w in words if w in FUNCTION_WORDS)
    n_c = len(words) - n_f
    denom = DELTA * n_c + (1.0 - DELTA) * n_f
    if denom == 0:
        return 0.0
    wc, wf = _weighted_split(words, matched)
    return (DELTA * wc + (1.0 - DELTA) * wf) / denom


def segment_stats(hypothesis: str, reference: str) -> Dict[str, float]:
    hyp, ref = hypothesis.split(), reference.split()
    pairs, hyp_matched, ref_matched = align(hyp, ref)
    # m for the fragmentation penalty: average matched-word count over the
    # two sides (METEOR 1.5; equals len(pairs) for word-level stages, and
    # generalizes to paraphrase spans covering unequal word counts)
    m = (len(hyp_matched) + len(ref_matched)) / 2.0
    return {
        "matches": m,
        "chunks": float(_chunks(pairs)),
        "p": _side_score(hyp, hyp_matched),
        "r": _side_score(ref, ref_matched),
        "len_h": float(len(hyp)),
        "len_r": float(len(ref)),
    }


def score_from_stats(s: Dict[str, float]) -> float:
    if s["matches"] == 0 or s["len_h"] == 0 or s["len_r"] == 0:
        return 0.0
    p, r = s["p"], s["r"]
    if p == 0 or r == 0:
        return 0.0
    fmean = (p * r) / (ALPHA * p + (1 - ALPHA) * r)
    # single-chunk alignments carry no fragmentation penalty (jar
    # behavior: identical sentences score exactly 1.0)
    if s["chunks"] <= 1:
        return fmean
    penalty = GAMMA * ((s["chunks"] / s["matches"]) ** BETA)
    return fmean * (1.0 - penalty)


def meteor_single(hypothesis: str, references: List[str]) -> float:
    """The best score over the references."""
    return max(score_from_stats(segment_stats(hypothesis, r)) for r in references)


class Meteor:
    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, np.ndarray]:
        assert sorted(gts.keys()) == sorted(res.keys())
        scores = [meteor_single(res[i][0], gts[i]) for i in sorted(gts.keys())]
        return float(np.mean(scores)), np.array(scores)

    def method(self) -> str:
        return "METEOR"
