"""Vocabulary: word <-> id maps (copy of ``icd_tpu/vocabulary.py``;
reference: vocabulary.py).

Token constants and ``Vocabulary`` match the reference exactly
(``<pad>`` = 0, OOV -> ``<unk>``). ``load_vocab`` reads both pickles in
use: the reference's (class path ``vocabulary.Vocabulary``) and
``icd_tpu.vocabulary.save_vocab``'s (``icd_tpu.vocabulary.Vocabulary``),
mapping either to this module's class without importing ``icd_tpu``.
``build_vocab`` keeps the reference's id order: ``<pad>`` first, then
the corpus words in first-seen order, then ``<start>``, ``<end>`` and
``<unk>`` (vocabulary.py:53-58).
"""

import pickle
from collections import Counter

from .data.tokenize import word_tokenize
from .pathconf import PathConfig

PAD_TOKEN = "<pad>"  # Padding
START_TOKEN = "<start>"  # Start of sentence
END_TOKEN = "<end>"  # End of sentence
UNK_TOKEN = "<unk>"  # Out of vocabulary (unknown)


class Vocabulary:
    """Word <-> id bijection with <unk> fallback
    (reference: vocabulary.py:15-35)."""

    def __init__(self):
        self.w2i = {}
        self.i2w = {}
        self.idx = 0

    def add_word(self, word):
        if word not in self.w2i:
            self.w2i[word] = self.idx
            self.i2w[self.idx] = word
            self.idx += 1

    def __call__(self, word):
        if word not in self.w2i:
            return self.w2i[UNK_TOKEN]
        return self.w2i[word]

    def __len__(self):
        return len(self.w2i)


def build_vocab(threshold=6, coco=None):
    """The vocabulary of the train2014 captions (icd_tpu/vocabulary.py:48):
    the words of ``word_tokenize(caption.lower())`` seen at least
    ``threshold`` times. ``coco`` is a ``data.coco.COCO`` index, loaded
    from ``PathConfig.train_anno_file`` when None."""
    if coco is None:
        from .data.coco import COCO

        coco = COCO(PathConfig.train_anno_file)
    counter = Counter()
    for ann_id in coco.anns.keys():
        counter.update(word_tokenize(str(coco.anns[ann_id]["caption"])
                                     .lower()))
    vocab = Vocabulary()
    vocab.add_word(PAD_TOKEN)
    for word, count in counter.items():
        if count >= threshold:
            vocab.add_word(word)
    vocab.add_word(START_TOKEN)
    vocab.add_word(END_TOKEN)
    vocab.add_word(UNK_TOKEN)
    return vocab


def save_vocab(vocab, path=None):
    """Pickle the vocabulary (reference: vocabulary.py:63-65). Its class
    path is this module's; ``icd_tpu.vocabulary.load_vocab`` reads it
    where ``icd_tpu_torch`` is importable."""
    path = path or PathConfig.vocab_file
    with open(path, "wb") as f:
        pickle.dump(vocab, f)


_VOCAB_MODULES = ("vocabulary", "icd_tpu.vocabulary")


class _CompatUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module in _VOCAB_MODULES:
            module = __name__
        return super().find_class(module, name)


def load_vocab(path=None):
    path = path or PathConfig.vocab_file
    with open(path, "rb") as f:
        return _CompatUnpickler(f).load()
