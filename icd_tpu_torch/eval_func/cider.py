"""CIDEr (Vedantam et al. 2015), COCO-caption conventions.

Matches the reference's vendored scorer (reference:
eval_func/cider/cider_scorer.py):
 - TF-IDF over 1..4-grams; document frequency counted over the
   reference sets (one document per image)
 - idf = ref_len - log(max(1, df)) where ref_len = log(#images), forced
   to 1 when there is a single image (cider_scorer.py:162-164)
 - clipped cosine similarity: min(h, r) * r per n-gram
   (cider_scorer.py:150)
 - gaussian length penalty exp(-delta^2 / (2*sigma^2)), sigma=6; delta
   uses the *bigram* token count as 'length' (cider_scorer.py:131 quirk:
   only n==1 index, which is bigrams, accumulates length)
 - mean over n-gram orders, averaged over references, scaled x10.

A copy of ``icd_tpu/eval_func/cider.py``: the port imports
nothing of ``icd_tpu``.
"""

import math
from collections import defaultdict

import numpy as np

from .bleu import ngram_counts as _word_ngram_counts

N_DEFAULT = 4
SIGMA_DEFAULT = 6.0


def ngram_counts(sentence, n):
    return _word_ngram_counts(sentence.split(), n)


def _tfidf_vec(cnts, doc_freq, ref_len, n):
    """Per-order tf-idf vectors, norms, and the reference 'length' quirk."""
    vec = [defaultdict(float) for _ in range(n)]
    norm = [0.0] * n
    length = 0
    for ngram, term_freq in cnts.items():
        df = math.log(max(1.0, doc_freq[ngram]))
        order = len(ngram) - 1
        weight = float(term_freq) * (ref_len - df)
        vec[order][ngram] = weight
        norm[order] += weight * weight
        if order == 1:
            length += term_freq
    return vec, [math.sqrt(x) for x in norm], length


def _sim(vec_h, vec_r, norm_h, norm_r, len_h, len_r, n, sigma):
    delta = float(len_h - len_r)
    penalty = math.exp(-(delta ** 2) / (2 * sigma ** 2))
    val = np.zeros(n)
    for order in range(n):
        s = 0.0
        for ngram, h_w in vec_h[order].items():
            s += min(h_w, vec_r[order][ngram]) * vec_r[order][ngram]
        if norm_h[order] != 0 and norm_r[order] != 0:
            s /= norm_h[order] * norm_r[order]
        assert not math.isnan(s)
        val[order] = s * penalty
    return val


class Cider:
    """compute_score(gts, res) -> (mean, per-image array)."""

    def __init__(self, test=None, refs=None, n=N_DEFAULT, sigma=SIGMA_DEFAULT):
        self._n = n
        self._sigma = sigma

    def compute_score(self, gts, res):
        n, sigma = self._n, self._sigma
        assert len(gts) == len(res)

        # Duplicate reference strings share one cooked counts object —
        # the eval protocol duplicates the single ground-truth caption
        # per token position (reference: models/baseline.py:345-350),
        # so cooking (and below, scoring) each copy is ~11x wasted work
        # at corpus scale. Dedup is bit-identical: the doc_freq pass
        # already sets over each sample's n-grams, and the scoring loop
        # still accumulates one (cached) sim term per duplicate.
        cooked_refs = []
        cooked_tests = []
        raw_refs = []
        for refs, hyp in zip(gts, res):
            assert isinstance(hyp, list) and len(hyp) == 1
            assert isinstance(refs, list) and len(refs) > 0
            cache = {}
            cooked = []
            for r in refs:
                c = cache.get(r)
                if c is None:
                    c = cache[r] = ngram_counts(r, n)
                cooked.append(c)
            cooked_refs.append(cooked)
            raw_refs.append(refs)
            cooked_tests.append(ngram_counts(hyp[0], n))

        # Document frequency over reference sets (one doc per image).
        doc_freq = defaultdict(float)
        for refs in cooked_refs:
            for ngram in set(ng for ref in refs for ng in ref):
                doc_freq[ngram] += 1
        if doc_freq:
            assert len(cooked_tests) >= max(doc_freq.values())

        ref_len = math.log(float(len(cooked_refs)))
        if len(cooked_refs) == 1:
            ref_len = 1

        scores = []
        for test, refs, raws in zip(cooked_tests, cooked_refs, raw_refs):
            vec, norm, length = _tfidf_vec(test, doc_freq, ref_len, n)
            score = np.zeros(n)
            sim_cache = {}
            for ref, raw in zip(refs, raws):
                sim = sim_cache.get(raw)
                if sim is None:
                    vec_r, norm_r, len_r = _tfidf_vec(ref, doc_freq,
                                                      ref_len, n)
                    sim = sim_cache[raw] = _sim(
                        vec, vec_r, norm, norm_r, length, len_r, n,
                        sigma)
                # accumulate once PER DUPLICATE (same order, same
                # values as the undeduped loop — bit-identical).
                score += sim
            scores.append(float(np.mean(score)) / len(refs) * 10.0)

        scores = np.asarray(scores)
        return float(np.mean(scores)), scores

    def method(self):
        return "CIDEr"
