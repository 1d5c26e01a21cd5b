"""Checkpoint save / load / unpack (port of ``icd_tpu/checkpoint.py:87-170``).

A ``.ckpt`` that ``icd_tpu`` writes is a pickle of numpy pytrees
(reference protocol: checkpoint.py:8-62), except that
``decoder_optimizer`` holds optax state namedtuples
(``icd_tpu/training/attention.py:315-317``). A plain ``pickle.load``
would import optax, and with it jax. The unpickler here maps every class
of optax, jax and their companions to an inert stand-in instead, so
loading never imports them; the weights come through as numpy arrays.

``save_checkpoint`` writes the same payload from numpy trees
(``params.encoder_to_jax`` / ``decoder_to_jax``), so ``icd_tpu`` loads,
evaluates and resumes a checkpoint of the port. The port's Adam state
(``params.adam_state_to_jax``: ``count``, ``mu``, ``nu``) is written as
the state of icd_tpu's two-group optimizer (``optax_adam_state``), its
classes named as optax names them (``_OptaxPickler``), without importing
optax.
"""

import os
import pickle

import numpy as np

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

    def __getnewargs__(self):
        # The fields, as a NamedTuple's: pickle rebuilds the object with
        # ``cls.__new__(cls, *fields)``, the real class too.
        return tuple(self)

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


class _OptaxPickler(pickle._Pickler):
    """The pure-Python pickler, which writes a stand-in class by the name
    of the class it stands in for (a ``GLOBAL module name`` opcode), so
    that unpickling it with optax installed makes the real object."""

    def save_global(self, obj, name=None):
        if isinstance(obj, type) and issubclass(obj, InertState):
            module, _, qualname = obj.source.rpartition(".")
            self.write(pickle.GLOBAL + "{}\n{}\n".format(
                module, qualname).encode("utf-8"))
            self.memoize(obj)
            return
        super().save_global(obj, name)


# The classes of icd_tpu's optimizer state, ``optax.multi_transform`` of
# an encoder and a decoder group, each ``optax.chain(clip_value, adam)``
# (icd_tpu/training/baseline.py:156-163, common.py:177-182), as the
# pickles icd_tpu writes name them (optax 0.2.6).
_PARTITION = ("optax.transforms._combining", "PartitionState")
_MASKED = ("optax.transforms._masking", "MaskedState")
_MASKED_NODE = ("optax.transforms._masking", "MaskedNode")
_EMPTY = ("optax._src.base", "EmptyState")
_ADAM = ("optax._src.transform", "ScaleByAdamState")


def _child(tree, key):
    if isinstance(tree, dict):
        return tree.get(key)
    if isinstance(tree, list) and key < len(tree):
        return tree[key]
    return None


def _group_moments(tree, moments, own):
    """``tree``'s shape with ``moments``' arrays where this group trains
    (``own``), optax's ``MaskedNode`` where the other group trains, and
    None at the frozen leaves."""
    if isinstance(tree, dict):
        return {k: _group_moments(v, _child(moments, k), own)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_group_moments(v, _child(moments, i), own)
                for i, v in enumerate(tree)]
    if moments is None:
        return None
    return moments if own else _stand_in(*_MASKED_NODE)()


def optax_adam_state(adam, encoder, decoder, grad_clip):
    """The port's Adam state ``adam`` ({"count", "mu", "nu"}, trees keyed
    like the trainable tree, ``params.adam_state_to_jax``) as icd_tpu's
    ``tx.init(trainable)`` lays it out over the checkpoint's ``encoder``
    and ``decoder`` trees: a ``PartitionState`` of the encoder and the
    decoder group, each a ``MaskedState`` over (clip's ``EmptyState``,
    (``ScaleByAdamState(count, mu, nu)``, the learning rate's
    ``EmptyState``)), without the clip's state when ``grad_clip`` is
    None. Both groups count every step."""
    trees = {"encoder": encoder, "decoder": decoder}
    empty = _stand_in(*_EMPTY)
    groups = {}
    for group in trees:
        mu, nu = ({part: _group_moments(tree, _child(adam[key], part),
                                        part == group)
                   for part, tree in trees.items()} for key in ("mu", "nu"))
        inner = (_stand_in(*_ADAM)(np.asarray(adam["count"], np.int32), mu,
                                   nu), empty())
        if grad_clip is not None:
            inner = (empty(), inner)
        groups[group] = _stand_in(*_MASKED)(inner)
    return _stand_in(*_PARTITION)(groups)


def save_checkpoint(args, epoch, encoder, decoder, encoder_optimizer,
                    decoder_optimizer, metrics):
    """Write one epoch's training state to
    ``checkpoints/{model_name}_{epoch}.ckpt`` (checkpoint.py:87;
    reference: checkpoint.py:39-62). The trees are numpy; the file is
    written to ``.tmp`` and published with ``os.replace``, so a run
    killed mid-write never leaves a truncated checkpoint under the real
    name. A ``decoder_optimizer`` in the port's form ({"count", "mu",
    "nu"}) is written as icd_tpu's optax state (``optax_adam_state``).
    Returns the path."""
    if isinstance(decoder_optimizer, dict) and "mu" in decoder_optimizer:
        decoder_optimizer = optax_adam_state(
            decoder_optimizer, encoder, decoder,
            getattr(args, "grad_clip", None))
    state = {
        "epoch": epoch,
        "metrics": metrics,
        "encoder": encoder,
        "decoder": decoder,
        "encoder_optimizer": encoder_optimizer,
        "decoder_optimizer": decoder_optimizer,
        "config": {
            "model_name": getattr(args, "model_name", None),
            "model": getattr(args, "model", getattr(args, "model_type", None)),
            "embed_size": getattr(args, "embed_size", None),
            "decoder_dim": getattr(args, "decoder_dim", None),
            "attention_dim": getattr(args, "attention_dim", None),
            "decoder_dropout": getattr(args, "decoder_dropout", None),
            "use_glove": getattr(args, "use_glove", False),
            "use_bert": getattr(args, "use_bert", False),
        },
    }
    os.makedirs(PathConfig.checkpoints_dir, exist_ok=True)
    path = os.path.join(PathConfig.checkpoints_dir,
                        "{}_{}.ckpt".format(args.model_name, epoch))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        _OptaxPickler(f, pickle.DEFAULT_PROTOCOL).dump(state)
    os.replace(tmp, path)
    print("Saved checkpoint to {}".format(path))
    return path


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
