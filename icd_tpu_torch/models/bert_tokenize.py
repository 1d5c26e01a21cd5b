"""The uncased WordPiece tokenizer of BERT (``transformers.BertTokenizer``
with ``do_lower_case=True``, as the JAX package builds it,
``icd_tpu/models/bert_embed.py:128-133``), in plain Python.

The machine with the card has no ``transformers``, so the port keeps its
own copy of the tokenizer. It reads a ``vocab.txt`` (one piece a line,
the line number its id) and splits a text in the same steps:

1. every character that is not one of the special tokens ``[UNK] [SEP]
   [PAD] [CLS] [MASK]`` is lower-cased, one character at a time;
2. the text is cut at the special tokens, which are kept whole;
3. each other part goes through the basic tokenizer: NUL, U+FFFD and
   control characters removed, other whitespace made a space; spaces put
   around CJK ideographs; NFC; split on whitespace; each word lower-cased,
   its accents stripped (NFD minus the category ``Mn``) and split at
   every punctuation character (ASCII 33-47, 58-64, 91-96, 123-126 and
   every Unicode ``P*``), so ``<start>`` becomes ``<``, ``start``, ``>``;
4. each resulting word goes through WordPiece: the greedy longest match
   from the left, continuations prefixed ``##``; a word that cannot be
   covered, or of more than 100 characters, becomes ``[UNK]``.
"""

import re
import unicodedata

SPECIAL_TOKENS = ("[UNK]", "[SEP]", "[PAD]", "[CLS]", "[MASK]")
UNK_TOKEN = "[UNK]"
MAX_INPUT_CHARS_PER_WORD = 100

_SPECIAL_SPLIT = re.compile(
    "(" + "|".join(re.escape(t) for t in SPECIAL_TOKENS) + ")")
_LOWER = re.compile(
    "(" + "|".join(re.escape(t) for t in SPECIAL_TOKENS) + ")|(.+?)")


def load_vocab(path):
    """``vocab.txt`` -> {piece: id}, the id its line number (a piece that
    appears twice keeps its last line)."""
    vocab = {}
    with open(path, "r", encoding="utf-8") as f:
        for index, line in enumerate(f.readlines()):
            vocab[line.rstrip("\n")] = index
    return vocab


def _is_whitespace(char):
    if char in " \t\n\r":
        return True
    return unicodedata.category(char) == "Zs"


def _is_control(char):
    if char in "\t\n\r":
        return False
    return unicodedata.category(char).startswith("C")


def _is_punctuation(char):
    cp = ord(char)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(char).startswith("P")


def _is_cjk(cp):
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def _clean_text(text):
    out = []
    for char in text:
        cp = ord(char)
        if cp == 0 or cp == 0xFFFD or _is_control(char):
            continue
        out.append(" " if _is_whitespace(char) else char)
    return "".join(out)


def _space_cjk(text):
    return "".join(" {} ".format(c) if _is_cjk(ord(c)) else c for c in text)


def _strip_accents(text):
    return "".join(c for c in unicodedata.normalize("NFD", text)
                   if unicodedata.category(c) != "Mn")


def _split_on_punctuation(text):
    out, start_new_word = [], True
    for char in text:
        if _is_punctuation(char):
            out.append(char)
            start_new_word = True
        else:
            if start_new_word:
                out.append("")
            start_new_word = False
            out[-1] += char
    return out


def basic_tokenize(text, never_split=SPECIAL_TOKENS):
    """Step 3: a text without special tokens -> its words, lower-cased,
    accents stripped, split at punctuation (``never_split`` words are
    kept as they are)."""
    text = unicodedata.normalize("NFC", _space_cjk(_clean_text(text)))
    words = []
    for token in text.split():
        if token in never_split:
            words.append(token)
            continue
        words.extend(_split_on_punctuation(_strip_accents(token.lower())))
    return " ".join(words).split()


def wordpiece_tokenize(word, vocab):
    """Step 4: one word -> its pieces, or ``[UNK]``."""
    if len(word) > MAX_INPUT_CHARS_PER_WORD:
        return [UNK_TOKEN]
    pieces, start = [], 0
    while start < len(word):
        end, piece = len(word), None
        while start < end:
            sub = word[start:end]
            if start > 0:
                sub = "##" + sub
            if sub in vocab:
                piece = sub
                break
            end -= 1
        if piece is None:
            return [UNK_TOKEN]
        pieces.append(piece)
        start = end
    return pieces


class BertTokenizer:
    """``transformers.BertTokenizer(vocab_file, do_lower_case=True)``:
    ``tokenize`` and ``convert_tokens_to_ids``."""

    def __init__(self, vocab_file):
        self.vocab = load_vocab(vocab_file)

    def tokenize(self, text):
        text = _LOWER.sub(lambda m: m.group(1) or m.group(2).lower(), text)
        pieces = []
        for part in _SPECIAL_SPLIT.split(text):
            if not part:
                continue
            if part in SPECIAL_TOKENS:
                pieces.append(part)
                continue
            for word in basic_tokenize(part):
                pieces.extend(wordpiece_tokenize(word, self.vocab))
        return pieces

    def convert_tokens_to_ids(self, tokens):
        unk = self.vocab.get(UNK_TOKEN)
        return [self.vocab.get(t, unk) for t in tokens]
