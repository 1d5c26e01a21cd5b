"""Checkpoint load / unpack (port of ``icd_tpu/checkpoint.py:143-170``).

A ``.ckpt`` that ``icd_tpu`` writes is a pickle of numpy pytrees
(reference protocol: checkpoint.py:8-62), except that
``decoder_optimizer`` holds optax state namedtuples
(``icd_tpu/training/attention.py:315-317``). A plain ``pickle.load``
would import optax, and with it jax. The unpickler here maps every class
of optax, jax and their companions to an inert stand-in instead, so
loading never imports them; the weights come through as numpy arrays.
"""

import os
import pickle

from .pathconf import PathConfig

_FOREIGN_PACKAGES = ("optax", "jax", "jaxlib", "chex", "flax")


class InertState(tuple):
    """Stand-in for an optax/jax object found in a checkpoint. It keeps
    the values it was rebuilt from (its tuple items, and ``state`` when
    pickle restores one) and does nothing else."""

    source = None  # "module.Name" of the class it stands in for

    def __new__(cls, *args):
        return tuple.__new__(cls, args)

    def __init__(self, *args):
        pass

    def __setstate__(self, state):
        self.__dict__["state"] = state

    def __repr__(self):
        return "InertState[{}]{}".format(self.source, tuple.__repr__(self))


_stand_ins = {}


def _stand_in(module, name):
    source = "{}.{}".format(module, name)
    cls = _stand_ins.get(source)
    if cls is None:
        cls = type(name, (InertState,), {"source": source})
        _stand_ins[source] = cls
    return cls


class _CheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in _FOREIGN_PACKAGES:
            return _stand_in(module, name)
        return super().find_class(module, name)


def load_checkpoint(args=None, name=None, verbose=True):
    """Load a ``.ckpt`` by name from the checkpoints dir
    (checkpoint.py:143; reference: checkpoint.py:8-18)."""
    name = name if name is not None else args.checkpoint
    path = os.path.join(PathConfig.checkpoints_dir, name)
    if verbose:
        print("Loading checkpoint {}".format(path))
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"PK" or name.endswith(".pth.tar"):
        raise NotImplementedError(
            "{}: reference .pth.tar conversion is not ported to "
            "icd_tpu_torch yet (ROADMAP.md, Queue 1); convert it with "
            "icd_tpu first".format(path))
    with open(path, "rb") as f:
        return _CheckpointUnpickler(f).load()


def unpack_checkpoint(chkpt):
    """Reference 6-tuple order (checkpoint.py:36)."""
    return (chkpt["epoch"], chkpt["encoder"], chkpt["decoder"],
            chkpt["encoder_optimizer"], chkpt["decoder_optimizer"],
            chkpt["metrics"])
