"""Global path registry (copy of ``icd_tpu/pathconf.py``).

Mirrors the reference's static path config (reference: pathconf.py:4-20)
so data and checkpoints are found where ``icd_tpu`` puts them. Paths are
relative to the process working directory; the environment variable
``ICD_TPU_ROOT`` re-roots everything, as it does for ``icd_tpu``.
"""

import os


def _root() -> str:
    return os.environ.get("ICD_TPU_ROOT", ".")


class _PathProp:
    def __init__(self, *parts):
        self._parts = parts

    def __get__(self, obj, objtype=None):
        return os.path.join(_root(), *self._parts)


class PathConfig:
    """Global paths (reference: pathconf.py:4-20), read at access time."""

    pkldata_dir = _PathProp("pkldata")
    vocab_file = _PathProp("pkldata", "vocab.pkl")

    anno_dir = _PathProp("cocoapi", "annotations")
    train_anno_file = _PathProp(
        "cocoapi", "annotations", "captions_train2014.json")
    val_anno_file = _PathProp(
        "cocoapi", "annotations", "captions_val2014.json")
    img_dir = _PathProp("cocoapi", "images")
    train_img_dir = _PathProp("cocoapi", "images", "train2014")
    val_img_dir = _PathProp("cocoapi", "images", "val2014")

    glove = _PathProp("glove.6B")
    glove_vectors = _PathProp("glove.6B", "glove_vectors.pkl")

    eval_data = _PathProp("eval_data")
    checkpoints_dir = _PathProp("checkpoints")
