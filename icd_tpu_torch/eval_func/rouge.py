"""ROUGE-L (Lin & Hovy 2004), COCO-caption conventions.

Matches the reference's vendored scorer (reference:
eval_func/rouge/rouge.py): F_beta with beta=1.2 over the *max* LCS
precision and *max* LCS recall across references (maxima taken
independently, rouge.py:109-121), corpus score is the mean.

The LCS length DP runs on a rolling numpy row instead of a Python
list-of-lists — same recurrence, ~20x faster on long captions.

A copy of ``icd_tpu/eval_func/rouge.py``: the port imports
nothing of ``icd_tpu``.
"""

import numpy as np

BETA = 1.2


def lcs_length(a, b):
    """Length of the longest common subsequence of two token lists."""
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return 0
    b_arr = np.asarray(b, dtype=object)
    prev = np.zeros(len(b) + 1, dtype=np.int64)
    for x in a:
        curr = np.maximum.accumulate(
            np.concatenate(([0], np.where(b_arr == x, prev[:-1] + 1, 0))))
        curr = np.maximum(curr, prev)
        # enforce monotone non-decreasing along j with carries from matches
        np.maximum.accumulate(curr, out=curr)
        prev = curr
    return int(prev[-1])


class Rouge:
    """compute_score(references, hypotheses) -> (mean, per-sentence)."""

    def __init__(self):
        self.beta = BETA

    def calc_score(self, candidate, refs):
        assert len(candidate) == 1
        assert len(refs) > 0
        token_c = candidate[0].split(" ")

        prec, rec = [], []
        seen = set()
        for reference in refs:
            # max() over identical references equals max() over their
            # first occurrences, so duplicate refs are skipped without
            # changing the result — the reference eval protocol
            # duplicates the one ground-truth caption per token
            # position (reference: models/baseline.py:345-350), which
            # made the LCS DP run ~11x per sample at corpus scale.
            if reference in seen:
                continue
            seen.add(reference)
            token_r = reference.split(" ")
            lcs = lcs_length(token_r, token_c)
            prec.append(lcs / float(len(token_c)))
            rec.append(lcs / float(len(token_r)))

        prec_max = max(prec)
        rec_max = max(rec)
        if prec_max != 0 and rec_max != 0:
            return ((1 + self.beta ** 2) * prec_max * rec_max
                    / float(rec_max + self.beta ** 2 * prec_max))
        return 0.0

    def compute_score(self, references, hypotheses):
        scores = []
        for refs, hyp in zip(references, hypotheses):
            assert isinstance(hyp, list) and len(hyp) == 1
            assert isinstance(refs, list) and len(refs) > 0
            scores.append(self.calc_score(hyp, refs))
        scores = np.asarray(scores)
        return float(np.mean(scores)), scores

    def method(self):
        return "Rouge"
