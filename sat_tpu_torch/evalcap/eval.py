"""Caption evaluation — the port's copy of ``sat_tpu.evalcap.eval``.

``CocoEvalCap`` gathers ground truths and results per image id
(optionally restricted to an eval subset), PTB-tokenizes both sides with
the port's Python rules (``data.tokenizer``), runs BLEU-1..4 / METEOR /
ROUGE-L / CIDEr, and records corpus and per-image scores.
"""

from __future__ import annotations

from typing import Dict, List

from ..data.coco import CocoCaptions
from ..data.tokenizer import tokenize_captions
from .bleu import Bleu
from .cider import Cider
from .meteor import Meteor
from .rouge import Rouge


class CocoEvalCap:
    def __init__(
        self,
        coco: CocoCaptions,
        coco_res: CocoCaptions,
        eval_data=None,
    ):
        """coco: ground-truth index; coco_res: result index from
        CocoCaptions.load_results; eval_data: optional DataSet whose
        image_ids restrict evaluation to the capped eval subset."""
        self.coco = coco
        self.coco_res = coco_res
        self.eval: Dict[str, float] = {}
        self.img_to_eval: Dict[int, Dict[str, float]] = {}
        if eval_data is not None:
            self.params = {"image_id": [int(i) for i in set(eval_data.image_ids)]}
        else:
            self.params = {"image_id": list(coco_res.imgs.keys())}

    def evaluate(self, verbose: bool = True) -> Dict[str, float]:
        img_ids = [i for i in self.params["image_id"] if i in self.coco_res.imgs]

        gts: Dict[int, List[str]] = {}
        res: Dict[int, List[str]] = {}
        for img_id in img_ids:
            gts[img_id] = [a["caption"] for a in self.coco.img_to_anns[img_id]]
            res[img_id] = [a["caption"] for a in self.coco_res.img_to_anns[img_id]]

        # PTB tokenization with punctuation stripping, both sides
        gts = {i: tokenize_captions(c) for i, c in gts.items()}
        res = {i: tokenize_captions(c) for i, c in res.items()}

        scorers = [
            (Bleu(4), ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4"]),
            (Meteor(), "METEOR"),
            (Rouge(), "ROUGE_L"),
            (Cider(), "CIDEr"),
        ]
        for scorer, method in scorers:
            score, scores = scorer.compute_score(gts, res)
            if isinstance(method, list):
                for sc, scs, m in zip(score, scores, method):
                    self._set_eval(m, sc)
                    self._set_img_scores(m, img_ids, scs)
                    if verbose:
                        print(f"{m}: {sc:.3f}")
            else:
                self._set_eval(method, score)
                self._set_img_scores(method, img_ids, scores)
                if verbose:
                    print(f"{method}: {score:.3f}")
        return dict(self.eval)

    def _set_eval(self, method: str, score: float) -> None:
        self.eval[method] = float(score)

    def _set_img_scores(self, method: str, img_ids, scores) -> None:
        for img_id, score in zip(sorted(img_ids), scores):
            self.img_to_eval.setdefault(img_id, {"image_id": img_id})[
                method
            ] = float(score)
