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
optax. With ``ICD_TPU_CKPT_ASYNC`` set the pickle and the write go to
one background writer thread (checkpoint.py:33-62, 136).

The reference's own checkpoints (``.pth.tar``, ``torch.save`` of live
``nn.Module``s and an optimizer, reference: checkpoint.py:51-60) are
read by ``load_torch_archive`` without running the reference's code:
every global the pickle names goes through ``_ReferenceUnpickler``,
which admits torch's tensor and storage rebuild functions, the classes of
``torch.nn.modules`` and ``torch.optim`` and a few plain containers,
gives every class of a module outside torch and the standard library
(the reference's ``models.*`` and ``vocabulary``, torchvision,
pytorch_pretrained_bert) an inert stand-in that keeps the object's
state, and refuses any other name. ``load_checkpoint`` converts such a
file with ``convert.convert_reference_checkpoint``.
"""

import _compat_pickle
import atexit
import importlib
import io
import os
import pickle
import struct
import sys
import threading
import warnings
import zipfile

import numpy as np
import torch

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


# ---------------------------------------------------------------------------
# The reference's whole-module pickles
# ---------------------------------------------------------------------------

_TORCH_REBUILD = {
    ("torch._utils", "_rebuild_tensor"), ("torch._utils", "_rebuild_tensor_v2"),
    ("torch._utils", "_rebuild_parameter"),
    ("torch._utils", "_rebuild_parameter_with_state"),
    ("torch._tensor", "_rebuild_from_type_v2"),
    ("torch.nn.parameter", "Parameter"), ("torch", "Tensor"),
    ("torch", "Size"), ("torch", "device"), ("torch", "UntypedStorage")}
_PLAIN = {
    ("collections", "OrderedDict"), ("collections", "defaultdict"),
    ("builtins", "dict"), ("builtins", "list"), ("builtins", "set"),
    ("builtins", "frozenset"), ("builtins", "tuple"), ("builtins", "int"),
    ("builtins", "float"), ("builtins", "bool"), ("builtins", "str"),
    ("builtins", "bytes"), ("builtins", "bytearray"), ("builtins", "complex"),
    ("builtins", "slice"), ("builtins", "range"), ("_codecs", "encode"),
    # numpy's array and scalar rebuild functions (a metric kept as a numpy
    # float).
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"), ("numpy._core.multiarray", "scalar"),
    ("numpy", "ndarray"), ("numpy", "dtype")}


class InertObject:
    """Stand-in for a class of a whole-module pickle that lives outside
    torch and the standard library (``source``: its "module.Name"). It
    runs none of that class's code: it keeps the arguments it was called
    with and the state pickle restores. Restored with an ``nn.Module``'s
    state (``_parameters`` / ``_buffers`` / ``_modules``) it becomes an
    ``InertModule``, so that ``state_dict()`` walks it as usual."""

    source = None

    def __init__(self, *args, **kwargs):
        self.__dict__["_args"] = (args, kwargs)

    def __setstate__(self, state):
        if isinstance(state, tuple) and len(state) == 2:
            state, slots = state  # (dict state, slot state)
            state = dict(state or {}, **(slots or {}))
        if isinstance(state, dict) and "_parameters" in state:
            self.__class__ = _stand_in_class(self.source, module=True)
            torch.nn.Module.__setstate__(self, state)
        elif isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["state"] = state

    def __repr__(self):
        return "{}[{}]".format(type(self).__mro__[1].__name__, self.source)


class InertModule(torch.nn.Module):
    """``InertObject`` restored as an ``nn.Module`` (it has no forward)."""

    source = None
    __repr__ = InertObject.__repr__


_reference_stand_ins = {}


def _stand_in_class(source, module=False):
    """The stand-in class of ``source`` ("module.Name"), one per name."""
    key = (source, module)
    if key not in _reference_stand_ins:
        _reference_stand_ins[key] = type(
            source.rpartition(".")[2],
            (InertModule if module else InertObject,), {"source": source})
    return _reference_stand_ins[key]


def _torch_global(module, name):
    """The torch object a whole-module pickle may name, else None: the
    rebuild functions, a storage class, a dtype, a class of
    ``torch.nn.modules``
    or ``torch.optim``."""
    if (module, name) in _TORCH_REBUILD:
        return getattr(importlib.import_module(module), name)
    if module == "torch":
        obj = getattr(torch, name, None)
        if isinstance(obj, torch.dtype) or (
                isinstance(obj, type) and name.endswith("Storage")):
            return obj
        return None
    if module.startswith(("torch.nn.modules.", "torch.optim.")) or module in (
            "torch.nn.modules", "torch.optim"):
        obj = getattr(importlib.import_module(module), name, None)
        if isinstance(obj, type) and issubclass(
                obj, (torch.nn.Module, torch.optim.Optimizer)):
            return obj
    return None


class _ReferenceUnpickler(pickle.Unpickler):
    """Unpickler of the reference's ``.pth.tar`` files: see the module
    docstring. ``storage(storage_type, key, location, numel, *view)``
    gives the storages that the pickle's persistent ids name."""

    def __init__(self, f, storage=None):
        super().__init__(f)
        self._storage = storage

    def find_class(self, module, name):
        # Python 2 names (``__builtin__``), as pickle maps them below
        # protocol 3 (torch.save writes protocol 2).
        if (module, name) in _compat_pickle.NAME_MAPPING:
            module, name = _compat_pickle.NAME_MAPPING[(module, name)]
        module = _compat_pickle.IMPORT_MAPPING.get(module, module)
        top = module.split(".")[0]
        if top == "torch":
            obj = _torch_global(module, name)
        elif (module, name) in _PLAIN:
            obj = getattr(importlib.import_module(module), name)
        elif top in sys.stdlib_module_names or top == "numpy":
            obj = None
        else:
            return _stand_in_class("{}.{}".format(module, name))
        if obj is None:
            raise pickle.UnpicklingError(
                "refusing global {}.{} in a reference checkpoint".format(
                    module, name))
        return obj

    def persistent_load(self, pid):
        kind = pid[0] if isinstance(pid, tuple) else None
        if kind in ("module", b"module"):
            # The legacy format names each module class with its source
            # (to warn when it changed): the class, resolved above.
            return pid[1]
        if kind not in ("storage", b"storage") or self._storage is None:
            raise pickle.UnpicklingError(
                "unexpected persistent id {!r}".format(pid))
        return self._storage(*pid[1:])


def _storage_dtype(storage_type):
    return (torch.uint8 if storage_type is torch.UntypedStorage
            else storage_type._dtype)


def _typed_storage(storage_type, untyped):
    """``untyped`` (an ``UntypedStorage``) as a storage of ``storage_type``
    (a torch storage class, whose dtype it names)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # TypedStorage's
        return torch.storage.TypedStorage(
            wrap_storage=untyped, dtype=_storage_dtype(storage_type),
            _internal=True)


def _bytes_storage(data):
    if not data:
        return torch.UntypedStorage(0)
    return torch.frombuffer(bytearray(data), dtype=torch.uint8).untyped_storage()


def _load_zip(path):
    """torch's zip format (``<archive>/data.pkl`` and one record a
    storage, ``<archive>/data/<key>``)."""
    with zipfile.ZipFile(path) as z:
        names = z.namelist()
        pkl = next(n for n in names if n.endswith("/data.pkl")
                   or n == "data.pkl")
        prefix = pkl[:-len("data.pkl")]
        order = prefix + "byteorder"
        if order in names and z.read(order).decode() != "little":
            raise ValueError("{}: big-endian checkpoints are not read"
                             .format(path))
        storages = {}

        def storage(storage_type, key, location, numel):
            key = key.decode() if isinstance(key, bytes) else str(key)
            if key not in storages:
                storages[key] = _typed_storage(storage_type, _bytes_storage(
                    z.read("{}data/{}".format(prefix, key))))
            return storages[key]

        return _ReferenceUnpickler(io.BytesIO(z.read(pkl)), storage).load()


def _load_legacy(path):
    """torch's legacy format (``_use_new_zipfile_serialization=False``):
    pickles of the magic number, the protocol version and the system
    info, the object, the list of storage keys, then each storage as an
    int64 element count and its bytes, in that order. (Storage views,
    which only torch before 1.0 wrote, are refused.)"""
    roots, numels = {}, {}

    def storage(storage_type, key, location, numel, view=None):
        if view is not None:
            raise pickle.UnpicklingError("storage views are not read")
        if key not in roots:
            size = torch.empty(0, dtype=_storage_dtype(
                storage_type)).element_size()
            roots[key] = _typed_storage(storage_type,
                                        torch.UntypedStorage(numel * size))
            numels[key] = numel
        return roots[key]

    with open(path, "rb") as f:
        magic, protocol, info = (_ReferenceUnpickler(f).load()
                                 for _ in range(3))
        if magic != 0x1950a86a20f9469cfc6c or protocol != 1001:
            raise ValueError("{}: not a torch checkpoint".format(path))
        if not info.get("little_endian", True):
            raise ValueError("{}: big-endian checkpoints are not read"
                             .format(path))
        result = _ReferenceUnpickler(f, storage).load()
        for key in _ReferenceUnpickler(f).load():
            untyped = roots[key]._untyped_storage
            (count,) = struct.unpack("<q", f.read(8))
            data = f.read(untyped.nbytes())
            if count != numels[key] or len(data) != untyped.nbytes():
                raise ValueError("{}: truncated storage {}".format(path, key))
            untyped.copy_(_bytes_storage(data))
    return result


def load_torch_archive(path):
    """The object a ``torch.save`` file holds, in either of torch's
    formats, read through ``_ReferenceUnpickler`` on the CPU: no global
    outside its admitted set is resolved and no constructor of the
    reference's classes runs."""
    with open(path, "rb") as f:
        magic = f.read(2)
    return _load_zip(path) if magic == b"PK" else _load_legacy(path)


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


_async_pool = None
_async_futures = []
_async_lock = threading.Lock()


def async_saves():
    """Whether ``save_checkpoint`` writes on a background thread
    (``ICD_TPU_CKPT_ASYNC`` set and not empty)."""
    return bool(os.environ.get("ICD_TPU_CKPT_ASYNC"))


def _get_async_pool():
    """The one writer thread (checkpoint.py:33): saves stay FIFO, and
    interpreter exit drains them, reporting any failure."""
    global _async_pool
    with _async_lock:
        if _async_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            _async_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="icd-ckpt")
            atexit.register(_drain_at_exit)
    return _async_pool


def _drain_at_exit():
    try:
        wait_pending_saves()
    except Exception as e:  # atexit: report, cannot re-raise
        print("icd_tpu_torch.checkpoint: async checkpoint write FAILED at "
              "exit: {}".format(e), file=sys.stderr, flush=True)
    finally:
        _async_pool.shutdown(wait=True)


def wait_pending_saves():
    """Block until every async checkpoint write has finished; then
    re-raise the first failure, after collecting every pending result
    (later failures are printed, not lost) (checkpoint.py:51)."""
    pending, _async_futures[:] = _async_futures[:], []
    first_error = None
    for f in pending:
        try:
            f.result()
        except Exception as e:
            if first_error is None:
                first_error = e
            else:
                print("icd_tpu_torch.checkpoint: additional async write "
                      "failure: {}".format(e), file=sys.stderr, flush=True)
    if first_error is not None:
        raise first_error


def save_checkpoint(args, epoch, encoder, decoder, encoder_optimizer,
                    decoder_optimizer, metrics, snapshot=None):
    """Write one epoch's training state to
    ``checkpoints/{model_name}_{epoch}.ckpt`` (checkpoint.py:87;
    reference: checkpoint.py:39-62). The trees are numpy; the file is
    written to ``.tmp`` and published with ``os.replace``, so a run
    killed mid-write never leaves a truncated checkpoint under the real
    name. A ``decoder_optimizer`` in the port's form ({"count", "mu",
    "nu"}) is written as icd_tpu's optax state (``optax_adam_state``).
    ``snapshot``, when given, is a callable that returns the (encoder,
    decoder, decoder_optimizer) trees in place of those arguments; the
    writer calls it. With ``ICD_TPU_CKPT_ASYNC`` the pickle and the
    write (and ``snapshot``) run on the writer thread, in save order,
    after this returns: what it reads must be a copy that training no
    longer changes (``training.common.checkpoint_snapshot``).
    ``wait_pending_saves`` or interpreter exit flushes. Returns the
    path."""
    config = {
        "model_name": getattr(args, "model_name", None),
        "model": getattr(args, "model", getattr(args, "model_type", None)),
        "embed_size": getattr(args, "embed_size", None),
        "decoder_dim": getattr(args, "decoder_dim", None),
        "attention_dim": getattr(args, "attention_dim", None),
        "decoder_dropout": getattr(args, "decoder_dropout", None),
        "use_glove": getattr(args, "use_glove", False),
        "use_bert": getattr(args, "use_bert", False),
    }
    grad_clip = getattr(args, "grad_clip", None)
    os.makedirs(PathConfig.checkpoints_dir, exist_ok=True)
    path = os.path.join(PathConfig.checkpoints_dir,
                        "{}_{}.ckpt".format(args.model_name, epoch))

    def write():
        enc, dec, opt = ((encoder, decoder, decoder_optimizer)
                         if snapshot is None else snapshot())
        if isinstance(opt, dict) and "mu" in opt:
            opt = optax_adam_state(opt, enc, dec, grad_clip)
        state = {"epoch": epoch, "metrics": metrics, "encoder": enc,
                 "decoder": dec, "encoder_optimizer": encoder_optimizer,
                 "decoder_optimizer": opt, "config": config}
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            _OptaxPickler(f, pickle.DEFAULT_PROTOCOL).dump(state)
        os.replace(tmp, path)
        print("Saved checkpoint to {}".format(path), flush=True)

    if async_saves():
        _async_futures.append(_get_async_pool().submit(write))
    else:
        write()
    return path


def load_checkpoint(args=None, name=None, verbose=True):
    """Load a checkpoint by name from the checkpoints dir
    (checkpoint.py:143; reference: checkpoint.py:8-18): a ``.ckpt`` of
    either package, or a reference ``.pth.tar`` (torch's zip or legacy
    format), converted to the same dict (``convert``)."""
    name = name if name is not None else args.checkpoint
    path = os.path.join(PathConfig.checkpoints_dir, name)
    if verbose:
        print("Loading checkpoint {}".format(path))
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"PK" or name.endswith(".pth.tar"):
        from .convert import convert_reference_checkpoint

        if verbose:
            print("Detected reference torch checkpoint; converting.")
        return convert_reference_checkpoint(path)
    with open(path, "rb") as f:
        return _CheckpointUnpickler(f).load()


def unpack_checkpoint(chkpt):
    """Reference 6-tuple order (checkpoint.py:36)."""
    return (chkpt["epoch"], chkpt["encoder"], chkpt["decoder"],
            chkpt["encoder_optimizer"], chkpt["decoder_optimizer"],
            chkpt["metrics"])
