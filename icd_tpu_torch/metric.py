"""Metric hub: BLEU / METEOR / ROUGE-L / CIDEr over token-id captions.

Reproduces the reference protocol exactly (reference: metric.py:7-27):
hypotheses and references arrive as lists of token-id lists and are
joined into space-separated **strings of ids** before scoring — the
scorers therefore operate on id 'words', not surface words. This quirk
must be preserved for metric parity with the reference eval_data JSONs.

A copy of ``icd_tpu/metric.py`` without its ``StepTimer`` (a
``jax.profiler`` hook): the port imports nothing of ``icd_tpu``.
"""

from .eval_func import Bleu, Cider, Meteor, Rouge


def probe_meteor():
    """Fail fast on a missing METEOR runtime: constructing the scorer
    raises when the jar/Java (or ICD_TPU_ALLOW_NO_METEOR) is absent —
    probing at eval STARTUP avoids burning the entire decode loop only
    to crash at scoring time (get_eval_score runs after the loop)."""
    Meteor()


def get_eval_score(references, hypotheses):
    """Score hypotheses against references.

    Args:
        references: list over samples of list of reference token-id lists.
        hypotheses: list over samples of hypothesis token-id lists.

    Returns:
        {'Bleu_1'..'Bleu_4', 'METEOR', 'ROUGE_L', 'CIDEr'} floats.
    """
    scorers = [
        (Bleu(4), ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4"]),
        (Meteor(), "METEOR"),
        (Rouge(), "ROUGE_L"),
        (Cider(), "CIDEr"),
    ]

    hypo = [[" ".join(str(x) for x in h)] for h in hypotheses]
    ref = [[" ".join(str(x) for x in r) for r in refs]
           for refs in references]

    score = []
    method = []
    for scorer, method_i in scorers:
        score_i, _ = scorer.compute_score(ref, hypo)
        if isinstance(score_i, list):
            score.extend(score_i)
        else:
            score.append(score_i)
        if isinstance(method_i, list):
            method.extend(method_i)
        else:
            method.append(method_i)
    return dict(zip(method, score))


class AccumulatingMetric:
    """Running value/sum/count average (reference: metric.py:29-46)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0
        self.sum = 0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n

    def avg(self):
        if self.count == 0:
            return 0
        return self.sum / self.count
