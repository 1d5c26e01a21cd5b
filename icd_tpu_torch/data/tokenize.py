"""Host-side word tokenization.

The reference tokenizes captions with ``nltk.tokenize.word_tokenize``
(reference: dataset.py:45, vocabulary.py:45). NLTK's word_tokenize is punkt
sentence splitting followed by the Penn Treebank word tokenizer per
sentence. In hermetic environments the punkt model is not downloadable, so
this module ships a faithful pure-Python implementation of the Treebank
tokenizer (the standard public rule set, differentially tested against
``nltk.tokenize.treebank.TreebankWordTokenizer`` on a generated caption
corpus — tests/test_tokenize.py) plus a light sentence splitter.

The built-in path is ALWAYS used by default so that vocabulary
construction is environment-invariant (the same corpus yields the same
vocab ids on every machine, punkt data installed or not). Set
``ICD_TPU_USE_NLTK=1`` to delegate to ``nltk.tokenize.word_tokenize``
instead (requires punkt data; exact-NLTK sentence splitting differs from
ours only on abbreviation-style boundaries — e.g. "no. 5" — which COCO's
single-sentence captions essentially never hit).

``word_tokenize(text)`` is the single public entry point.

A copy of ``icd_tpu/data/tokenize.py``: the port imports
nothing of ``icd_tpu``.
"""

import os
import re
from functools import lru_cache

# ---------------------------------------------------------------------------
# Penn Treebank word tokenizer (standard sed-script rule set).
# ---------------------------------------------------------------------------

_STARTING_QUOTES = [
    (re.compile(r"^\""), r"``"),
    (re.compile(r"(``)"), r" \1 "),
    (re.compile(r"([ \(\[{<])(\"|\'{2})"), r"\1 `` "),
]

_PUNCTUATION = [
    (re.compile(r"([:,])([^\d])"), r" \1 \2"),
    (re.compile(r"([:,])$"), r" \1 "),
    (re.compile(r"\.\.\."), r" ... "),
    (re.compile(r"[;@#$%&]"), r" \g<0> "),
    # Final-sentence period: split a period that ends the string (possibly
    # followed by closing brackets/quotes).
    (re.compile(r'([^\.])(\.)([\]\)}>"\']*)\s*$'), r"\1 \2\3 "),
    (re.compile(r"[?!]"), r" \g<0> "),
    (re.compile(r"([^'])' "), r"\1 ' "),
]

_PARENS_BRACKETS = [
    (re.compile(r"[\]\[\(\)\{\}<>]"), r" \g<0> "),
    (re.compile(r"--"), r" -- "),
]

_ENDING_QUOTES = [
    (re.compile(r'"'), " '' "),
    (re.compile(r"(\S)(\'\')"), r"\1 \2 "),
    (re.compile(r"([^' ])('[sS]|'[mM]|'[dD]|') "), r"\1 \2 "),
    (re.compile(r"([^' ])('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) "), r"\1 \2 "),
]

_CONTRACTIONS2 = [
    re.compile(pat, re.IGNORECASE)
    for pat in (
        r"\b(can)(not)\b",
        r"\b(d)('ye)\b",
        r"\b(gim)(me)\b",
        r"\b(gon)(na)\b",
        r"\b(got)(ta)\b",
        r"\b(lem)(me)\b",
        r"\b(mor)('n)\b",
        r"\b(wan)(na)(?=\s)",
    )
]
_CONTRACTIONS3 = [
    re.compile(pat, re.IGNORECASE)
    for pat in (r" ('t)(is)\b", r" ('t)(was)\b")
]


def treebank_word_tokenize(text: str) -> list:
    """Tokenize one sentence with the Penn Treebank rules."""
    for regexp, substitution in _STARTING_QUOTES:
        text = regexp.sub(substitution, text)
    for regexp, substitution in _PUNCTUATION:
        text = regexp.sub(substitution, text)
    for regexp, substitution in _PARENS_BRACKETS:
        text = regexp.sub(substitution, text)
    text = " " + text + " "
    for regexp, substitution in _ENDING_QUOTES:
        text = regexp.sub(substitution, text)
    for regexp in _CONTRACTIONS2:
        text = regexp.sub(r" \1 \2 ", text)
    for regexp in _CONTRACTIONS3:
        text = regexp.sub(r" \1 \2 ", text)
    return text.split()


# Lightweight sentence splitter: break after ./!/? when followed by
# whitespace and a plausible sentence start. COCO captions are almost
# always single sentences, so this only has to be sane, not punkt-exact.
_SENT_BOUNDARY = re.compile(r"(?<=[.!?])\s+(?=[\"'(\[{]?\w)")


def _split_sentences(text: str) -> list:
    parts = _SENT_BOUNDARY.split(text)
    return [p for p in parts if p.strip()]


@lru_cache(maxsize=1)
def _nltk_word_tokenize():
    """nltk.word_tokenize, required to work (ICD_TPU_USE_NLTK opt-in)."""
    import nltk

    nltk.tokenize.word_tokenize("probe sentence.")  # raises without punkt
    return nltk.tokenize.word_tokenize


def word_tokenize(text: str) -> list:
    """Drop-in equivalent of ``nltk.tokenize.word_tokenize``.

    Always uses the built-in implementation (environment-invariant
    vocabularies) unless ``ICD_TPU_USE_NLTK=1`` explicitly delegates to
    NLTK — which then must have its punkt data installed; a silent
    fallback here would let two machines build different vocab id maps
    for the same corpus.
    """
    if os.environ.get("ICD_TPU_USE_NLTK"):
        return _nltk_word_tokenize()(text)
    tokens = []
    for sentence in _split_sentences(text):
        tokens.extend(treebank_word_tokenize(sentence))
    return tokens
