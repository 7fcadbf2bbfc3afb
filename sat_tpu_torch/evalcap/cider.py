"""CIDEr (consensus-based image description evaluation) — the port's copy
of ``sat_tpu.evalcap.cider``.

Vedantam et al. (2015) with the COCO caption toolkit's semantics:

* n-grams 1..4, tf = raw count, idf = log(#images) - log(max(1, df)) with
  df counted over reference sets;
* clipped similarity: Σ min(hyp_g, ref_g)·ref_g per n, cosine-normalized;
* Gaussian length penalty exp(-Δlen²/(2σ²)) with σ=6;
* per-image score = mean over n of the per-ref-averaged similarity, ×10.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, Tuple

import numpy as np

N_GRAMS = 4
SIGMA = 6.0


def _counts(sentence: str, n: int = N_GRAMS) -> Counter:
    words = sentence.split()
    c: Counter = Counter()
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            c[tuple(words[i : i + k])] += 1
    return c


class Cider:
    def __init__(self, n: int = N_GRAMS, sigma: float = SIGMA):
        self.n = n
        self.sigma = sigma

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, np.ndarray]:
        assert sorted(gts.keys()) == sorted(res.keys())
        ids = sorted(gts.keys())
        ref_counts = [[_counts(r, self.n) for r in gts[i]] for i in ids]
        hyp_counts = [_counts(res[i][0], self.n) for i in ids]

        # document frequency over reference sets
        df: Dict = defaultdict(float)
        for refs in ref_counts:
            for g in set(g for ref in refs for g in ref):
                df[g] += 1
        log_num_images = math.log(len(ids))

        def tfidf(cnts: Counter):
            vec = [defaultdict(float) for _ in range(self.n)]
            norm = [0.0] * self.n
            length = 0
            for g, tf in cnts.items():
                idf = log_num_images - math.log(max(1.0, df[g]))
                k = len(g) - 1
                vec[k][g] = tf * idf
                norm[k] += vec[k][g] ** 2
                if k == 0:
                    length += tf
            return vec, [math.sqrt(x) for x in norm], length

        scores = []
        for refs, hyp in zip(ref_counts, hyp_counts):
            vec_h, norm_h, len_h = tfidf(hyp)
            total = np.zeros(self.n)
            for ref in refs:
                vec_r, norm_r, len_r = tfidf(ref)
                delta = float(len_h - len_r)
                val = np.zeros(self.n)
                for k in range(self.n):
                    for g, w in vec_h[k].items():
                        val[k] += min(w, vec_r[k][g]) * vec_r[k][g]
                    if norm_h[k] != 0 and norm_r[k] != 0:
                        val[k] /= norm_h[k] * norm_r[k]
                total += val * math.exp(-(delta**2) / (2 * self.sigma**2))
            scores.append(float(np.mean(total)) / len(refs) * 10.0)
        return float(np.mean(scores)), np.array(scores)

    def method(self) -> str:
        return "CIDEr"
