"""Corpus BLEU-1..4 — the port's copy of ``sat_tpu.evalcap.bleu``.

BLEU (Papineni et al. 2002) with the numeric conventions of the COCO
caption toolkit's scorer, so scores are comparable digit for digit:

* clipped n-gram matches against the per-ngram max reference count;
* the 'closest' effective reference length per sentence;
* tiny/small epsilons (1e-15 / 1e-9) inside the precision ratios;
* brevity penalty exp(1 - 1/ratio) applied when ratio < 1, at both the
  corpus and the per-sentence level.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Sequence, Tuple

_TINY = 1e-15
_SMALL = 1e-9


def _ngrams(words: Sequence[str], n: int) -> Counter:
    return Counter(tuple(words[i : i + n]) for i in range(len(words) - n + 1))


class Bleu:
    def __init__(self, n: int = 4):
        self.n = n

    def compute_score(
        self, gts: Dict, res: Dict
    ) -> Tuple[List[float], List[List[float]]]:
        """gts/res: {image_id: [caption strings]}; res has exactly one
        caption per image.  Returns ([bleu1..4], per-sentence lists)."""
        assert sorted(gts.keys()) == sorted(res.keys())
        n = self.n
        total_guess = [0] * n
        total_correct = [0] * n
        total_testlen = 0
        total_reflen = 0.0
        per_sentence: List[List[float]] = [[] for _ in range(n)]

        for img_id in sorted(gts.keys()):
            hyp = res[img_id]
            assert isinstance(hyp, list) and len(hyp) == 1
            hyp_words = hyp[0].split()
            ref_words = [r.split() for r in gts[img_id]]
            assert ref_words

            testlen = len(hyp_words)
            reflen = min((abs(len(r) - testlen), len(r)) for r in ref_words)[1]
            total_testlen += testlen
            total_reflen += reflen

            guess = [max(0, testlen - k) for k in range(n)]
            correct = []
            for k in range(1, n + 1):
                hyp_counts = _ngrams(hyp_words, k)
                max_ref: Counter = Counter()
                for r in ref_words:
                    for g, c in _ngrams(r, k).items():
                        if c > max_ref[g]:
                            max_ref[g] = c
                correct.append(
                    sum(min(c, max_ref[g]) for g, c in hyp_counts.items())
                )
            for k in range(n):
                total_guess[k] += guess[k]
                total_correct[k] += correct[k]

            # per-sentence score with its own brevity penalty
            bleu = 1.0
            ratio = (testlen + _TINY) / (reflen + _SMALL)
            for k in range(n):
                bleu *= (correct[k] + _TINY) / (guess[k] + _SMALL)
                s = bleu ** (1.0 / (k + 1))
                if ratio < 1:
                    s *= math.exp(1 - 1 / ratio)
                per_sentence[k].append(s)

        scores = []
        bleu = 1.0
        ratio = (total_testlen + _TINY) / (total_reflen + _SMALL)
        for k in range(n):
            bleu *= (total_correct[k] + _TINY) / (total_guess[k] + _SMALL)
            s = bleu ** (1.0 / (k + 1))
            if ratio < 1:
                s *= math.exp(1 - 1 / ratio)
            scores.append(s)
        return scores, per_sentence

    def method(self) -> str:
        return "Bleu"
