"""Vocabulary: word <-> id maps (copy of ``icd_tpu/vocabulary.py``'s
loading half; reference: vocabulary.py).

Token constants and ``Vocabulary`` match the reference exactly
(``<pad>`` = 0, OOV -> ``<unk>``). ``load_vocab`` reads both pickles in
use: the reference's (class path ``vocabulary.Vocabulary``) and
``icd_tpu.vocabulary.save_vocab``'s (``icd_tpu.vocabulary.Vocabulary``),
mapping either to this module's class without importing ``icd_tpu``.
``build_vocab`` and its tokenizer come with the training slice.
"""

import pickle

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
