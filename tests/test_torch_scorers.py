"""The port's scorers and tokenizer (icd_tpu_torch/metric.py,
eval_func/*, data/tokenize.py: copies) against icd_tpu's.

The copies must give exactly what icd_tpu gives: ``get_eval_score`` on
seeded token-id captions (with METEOR from the pure-Python backend and
without it), the metrics' running average, and ``word_tokenize`` on a
set of captions with punctuation, contractions, quotes and numbers.
"""

import numpy as np
import pytest

from icd_tpu.data.tokenize import word_tokenize as jax_word_tokenize
from icd_tpu.metric import AccumulatingMetric as JaxAccumulatingMetric
from icd_tpu.metric import get_eval_score as jax_get_eval_score
from icd_tpu_torch.data.tokenize import word_tokenize
from icd_tpu_torch.metric import AccumulatingMetric, get_eval_score

CAPTIONS = [
    "A man riding a horse on the beach.",
    "Two cats are sleeping on the couch.",
    "A man's dog isn't running; it's \"resting\" (maybe).",
    "The U.S. flag flies at 3.5 m... or so!",
    "People at the $10 sale -- don't miss it?",
    "A red-and-white bus, parked near St. Mary's church.",
    "Children's toys: blocks, balls & trains.",
    "  Many   spaces\tand\nnewlines  ",
    "'Quoted' words and `backticks` here.",
    "Cannot, gonna, wanna, gotta; I'd've come.",
]


def _corpus(n, vocab=40, seed=0):
    """Seeded id captions: 1-5 references an item, some hypotheses close
    to a reference, some empty."""
    rng = np.random.default_rng(seed)

    def caption():
        return [int(x) for x in rng.integers(0, vocab, rng.integers(1, 14))]

    refs = [[caption() for _ in range(rng.integers(1, 6))] for _ in range(n)]
    hyps = [caption() for _ in range(n)]
    for i in range(0, n, 3):
        hyps[i] = list(refs[i][0])
        if len(hyps[i]) > 2:
            hyps[i][1] = int(rng.integers(0, vocab))
    hyps[1] = []
    return refs, hyps


@pytest.mark.parametrize("meteor", ["meteor_py", "none"])
@pytest.mark.parametrize("seed", [0, 1])
def test_get_eval_score_equals_icd_tpu(monkeypatch, meteor, seed):
    if meteor == "meteor_py":
        monkeypatch.setenv("ICD_TPU_METEOR_PY", "1")
    else:
        monkeypatch.delenv("ICD_TPU_METEOR_PY", raising=False)
        monkeypatch.setenv("ICD_TPU_ALLOW_NO_METEOR", "1")
    refs, hyps = _corpus(30, seed=seed)
    want = jax_get_eval_score(refs, hyps)
    got = get_eval_score(refs, hyps)
    assert got == want
    assert (got["METEOR"] > 0) == (meteor == "meteor_py")


def test_accumulating_metric_equals_icd_tpu():
    ours, theirs = AccumulatingMetric(), JaxAccumulatingMetric()
    for val, n in [(1.5, 3), (0.25, 1), (2.0, 7)]:
        ours.update(val, n)
        theirs.update(val, n)
    assert (ours.val, ours.sum, ours.count, ours.avg()) == (
        theirs.val, theirs.sum, theirs.count, theirs.avg())


@pytest.mark.parametrize("caption", CAPTIONS)
def test_word_tokenize_equals_icd_tpu(caption):
    for text in (caption, caption.lower()):
        assert word_tokenize(text) == jax_word_tokenize(text)
