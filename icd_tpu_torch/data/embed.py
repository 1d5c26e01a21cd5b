"""GloVe pretrained embedding matrix construction.

Reproduces reference embed.py:12-68 without the bcolz dependency: parses
``glove.6B/glove.6B.300d.txt``, builds a ``len(vocab) x 300`` matrix
aligned to vocabulary ids, fills OOV rows from N(0, 0.6^2)
(embed.py:47-56), and pickles it to ``glove.6B/glove_vectors.pkl``. The
loader returns a numpy float32 array.

KNOWN REFERENCE BUG (deliberately not inherited by default): the
reference's fill loop iterates ``enumerate(vocab.i2w)`` over the dict
(embed.py:51), so ``word`` is the integer id, ``glove[word]`` KeyErrors
for EVERY row, and the published "GloVe" models actually trained on a
fully random N(0, 0.6^2) matrix (words_found = 0 — consistent with the
published glove_baseline metrics matching plain baseline, BASELINE.md).
By default this module looks words up correctly; set
``ICD_TPU_GLOVE_REFBUG=1`` (or ``reference_bug_compat=True``) to
reproduce the reference's all-random matrix for training-parity runs.

A copy of ``icd_tpu/data/embed.py``; it reads a local file only.
"""

import os
import pickle

import numpy as np

from ..pathconf import PathConfig

GLOVE_DIM = 300


def generate_glove_vectors(vocab=None, glove_txt=None, out_path=None,
                           rng=None, reference_bug_compat=None):
    """Build and pickle the vocab-aligned GloVe weight matrix.

    ``reference_bug_compat`` (default: the ICD_TPU_GLOVE_REFBUG env
    var) reproduces the reference's broken id-keyed lookup — every row
    random, words_found 0 (see module docstring)."""
    from ..vocabulary import load_vocab

    if vocab is None:
        vocab = load_vocab()
    if glove_txt is None:
        glove_txt = os.path.join(PathConfig.glove, "glove.6B.300d.txt")
    if out_path is None:
        out_path = PathConfig.glove_vectors
    if rng is None:
        rng = np.random.default_rng(0)
    if reference_bug_compat is None:
        reference_bug_compat = bool(os.environ.get("ICD_TPU_GLOVE_REFBUG"))

    glove = {}
    with open(glove_txt, "rb") as f:
        for raw in f:
            line = raw.decode().split()
            glove[line[0]] = np.asarray(line[1:], dtype=np.float64)

    weights_matrix = np.zeros((len(vocab), GLOVE_DIM))
    words_found = 0
    for i in range(len(vocab)):
        # Reference iterates dict KEYS, so its lookup key is the int id
        # and never hits (embed.py:51-56).
        word = i if reference_bug_compat else vocab.i2w[i]
        if word in glove:
            weights_matrix[i] = glove[word]
            words_found += 1
        else:
            weights_matrix[i] = rng.normal(scale=0.6, size=(GLOVE_DIM,))

    with open(out_path, "wb") as f:
        pickle.dump(weights_matrix, f, protocol=2)
    print("weights_matrix is created ({} / {} words found)".format(
        words_found, len(vocab)))
    return weights_matrix


def load_glove_vectors(path=None):
    """Load the pickled GloVe matrix as float32 numpy (embed.py:64-68)."""
    path = path or PathConfig.glove_vectors
    with open(path, "rb") as f:
        glove_vectors = pickle.load(f)
    return np.asarray(glove_vectors, dtype=np.float32)
