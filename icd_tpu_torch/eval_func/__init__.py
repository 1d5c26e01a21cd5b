"""The COCO-caption scorers (a copy of ``icd_tpu/eval_func``)."""

from .bleu import Bleu
from .cider import Cider
from .meteor import Meteor
from .rouge import Rouge

__all__ = ["Bleu", "Cider", "Meteor", "Rouge"]
