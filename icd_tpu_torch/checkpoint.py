"""Checkpoint save / load / unpack (port of ``icd_tpu/checkpoint.py:87-170``).

A ``.ckpt`` that ``icd_tpu`` writes is a pickle of numpy pytrees
(reference protocol: checkpoint.py:8-62), except that
``decoder_optimizer`` holds optax state namedtuples
(``icd_tpu/training/attention.py:315-317``). A plain ``pickle.load``
would import optax, and with it jax. The unpickler here maps every class
of optax, jax and their companions to an inert stand-in instead, so
loading never imports them; the weights come through as numpy arrays.

``save_checkpoint`` writes the same payload from numpy trees
(``params.encoder_to_jax`` / ``decoder_to_jax``), so ``icd_tpu`` loads
and evaluates a checkpoint of the port. The port's optimizer state is a
plain numpy dict (``params.adam_state_to_jax``), which ``icd_tpu``
cannot resume from.
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


def save_checkpoint(args, epoch, encoder, decoder, encoder_optimizer,
                    decoder_optimizer, metrics):
    """Write one epoch's training state to
    ``checkpoints/{model_name}_{epoch}.ckpt`` (checkpoint.py:87;
    reference: checkpoint.py:39-62). The trees are numpy; the file is
    written to ``.tmp`` and published with ``os.replace``, so a run
    killed mid-write never leaves a truncated checkpoint under the real
    name. Returns the path."""
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
        pickle.dump(state, f)
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
