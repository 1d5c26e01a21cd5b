"""Corpus BLEU-1..4 (Papineni et al. 2002), COCO-caption conventions.

Matches the numerics of the reference's vendored Chiang-style scorer
(reference: eval_func/bleu/bleu_scorer.py):
 - clipped n-gram precision against max reference counts
 - effective reference length: 'closest' to the hypothesis length, ties
   broken toward the shorter reference (bleu_scorer.py:190)
 - smoothing constants tiny=1e-15 (numerator) and small=1e-9
   (denominator) (bleu_scorer.py:200-201)
 - brevity penalty exp(1 - 1/ratio) applied when ratio < 1, with the
   tiny/small guard inside the ratio (bleu_scorer.py:236-256)
 - per-sentence scores use the *sentence's own* counts with the same
   formula; the corpus score uses summed counts.

A copy of ``icd_tpu/eval_func/bleu.py``: the port imports
nothing of ``icd_tpu``.
"""

import math
from collections import Counter

N_DEFAULT = 4
_TINY = 1e-15  # so that a zero 'guess' still yields 0
_SMALL = 1e-9


def ngram_counts(words, n):
    """Counts of all 1..n-grams of a token list."""
    counts = Counter()
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i: i + k])] += 1
    return counts


def _closest_reflen(reflens, testlen):
    # min over (|l - testlen|, l): ties prefer the shorter reference.
    return min((abs(l - testlen), l) for l in reflens)[1]


def _sentence_stats(hyp, refs, n):
    """Per-sentence BLEU sufficient statistics."""
    hyp_words = hyp.split()
    testlen = len(hyp_words)
    counts = ngram_counts(hyp_words, n)

    maxcounts = Counter()
    reflens = []
    for ref in refs:
        ref_words = ref.split()
        reflens.append(len(ref_words))
        for ngram, cnt in ngram_counts(ref_words, n).items():
            if cnt > maxcounts[ngram]:
                maxcounts[ngram] = cnt

    guess = [max(0, testlen - k + 1) for k in range(1, n + 1)]
    correct = [0] * n
    for ngram, cnt in counts.items():
        correct[len(ngram) - 1] += min(maxcounts.get(ngram, 0), cnt)
    return testlen, _closest_reflen(reflens, testlen), guess, correct


def _bleu_from_stats(testlen, reflen, guess, correct, n):
    bleus = []
    prod = 1.0
    for k in range(n):
        prod *= (float(correct[k]) + _TINY) / (float(guess[k]) + _SMALL)
        bleus.append(prod ** (1.0 / (k + 1)))
    ratio = (testlen + _TINY) / (reflen + _SMALL)
    if ratio < 1:
        bp = math.exp(1 - 1 / ratio)
        bleus = [b * bp for b in bleus]
    return bleus


class Bleu:
    """compute_score(gts, res) -> (corpus [b1..bn], per-sentence lists)."""

    def __init__(self, n=N_DEFAULT):
        self._n = n

    def compute_score(self, gts, res):
        n = self._n
        total_guess = [0] * n
        total_correct = [0] * n
        total_testlen = 0
        total_reflen = 0.0
        per_sentence = [[] for _ in range(n)]

        assert len(gts) == len(res)
        for refs, hyp in zip(gts, res):
            assert isinstance(hyp, list) and len(hyp) == 1
            assert isinstance(refs, list) and len(refs) >= 1
            testlen, reflen, guess, correct = _sentence_stats(
                hyp[0], refs, n)
            total_testlen += testlen
            total_reflen += reflen
            for k in range(n):
                total_guess[k] += guess[k]
                total_correct[k] += correct[k]
            sent = _bleu_from_stats(testlen, reflen, guess, correct, n)
            for k in range(n):
                per_sentence[k].append(sent[k])

        corpus = _bleu_from_stats(
            total_testlen, total_reflen, total_guess, total_correct, n)
        return corpus, per_sentence

    def method(self):
        return "Bleu"
