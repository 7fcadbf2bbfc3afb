"""sat_tpu_torch.evalcap — the COCO caption scorers: BLEU-1..4, METEOR,
ROUGE-L and CIDEr, and ``CocoEvalCap`` over them."""

from .bleu import Bleu
from .cider import Cider
from .eval import CocoEvalCap
from .meteor import Meteor
from .rouge import Rouge

__all__ = ["Bleu", "Cider", "CocoEvalCap", "Meteor", "Rouge"]
