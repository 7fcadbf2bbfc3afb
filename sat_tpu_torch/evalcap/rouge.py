"""ROUGE-L (longest-common-subsequence F-measure) — the port's copy of
``sat_tpu.evalcap.rouge``.

Lin (2004) with the COCO caption toolkit's conventions: β=1.2, per-image
score = F(max precision over refs, max recall over refs), corpus score =
mean over images.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

BETA = 1.2


def lcs_length(a: Sequence[str], b: Sequence[str]) -> int:
    """Classic O(len(a)·len(b)) LCS dynamic program, O(min) memory."""
    if len(a) < len(b):
        a, b = b, a
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y else max(prev[j], cur[-1]))
        prev = cur
    return prev[-1]


def rouge_l_single(hypothesis: str, references: List[str]) -> float:
    hyp = hypothesis.split()
    precisions, recalls = [], []
    for ref in references:
        r = ref.split()
        lcs = lcs_length(r, hyp)
        precisions.append(lcs / len(hyp) if hyp else 0.0)
        recalls.append(lcs / len(r) if r else 0.0)
    p, r = max(precisions), max(recalls)
    if p != 0 and r != 0:
        return ((1 + BETA**2) * p * r) / (r + BETA**2 * p)
    return 0.0


class Rouge:
    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, np.ndarray]:
        assert sorted(gts.keys()) == sorted(res.keys())
        scores = [
            rouge_l_single(res[i][0], gts[i]) for i in sorted(gts.keys())
        ]
        return float(np.mean(scores)), np.array(scores)

    def method(self) -> str:
        return "Rouge"
