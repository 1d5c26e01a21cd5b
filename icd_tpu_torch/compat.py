"""Import shims for the reference's classes (port of the parts of
``icd_tpu/compat.py`` that export needs).

``export.export_reference_checkpoint`` builds the reference's own
``nn.Module``s from a checkout of the reference (``--reference_root``)
and pickles them, as the reference's ``save_checkpoint`` does. Those
modules import packages that may be absent: torchvision (the ResNet-101
backbone, models/encoder.py:9-20), pytorch_pretrained_bert (the BERT
decoder, models/attention.py:96-100), bcolz (embed.py) and pycocotools
(vocabulary.py, dataset.py). ``install_reference_shims`` registers
stand-ins under those names when the real package is missing:

- ``torchvision.models.resnet.{ResNet, Bottleneck}`` and ``resnet101``:
  a working torch ResNet written against the architecture, with
  torchvision's module registration order (conv1, bn1, relu, maxpool,
  layer1-4, avgpool, fc), so that the reference's
  ``list(resnet.children())`` slicing (models/encoder.py:38-39, 90-91)
  behaves as with torchvision; and ``torchvision.transforms``'
  ``Compose`` / ``Resize`` / ``ToTensor`` / ``Normalize`` with
  torchvision's PIL semantics (PIL imported when one runs);
- ``pytorch_pretrained_bert.{BertModel, BertTokenizer}``, whose
  ``from_pretrained`` read the ``save_pretrained`` directory in
  ``BERT_MODEL_DIR`` through the port's own reader and tokenizer
  (``models/bert_load.py``, ``models/bert_tokenize.py``): no download,
  no ``transformers``;
- ``bcolz``, a module whose every attribute raises;
- ``pycocotools`` with ``coco``, ``mask`` and ``cocoeval``: the port's
  own ``data/coco.py``, ``native/mask.py`` and ``data/cocoeval.py``.
  The repository's ``cocoapi/PythonAPI`` shim is icd_tpu's and would
  import the JAX package, so it is never used: where ``sys.modules``
  already holds it, the stand-ins take its place for the call and it is
  put back after.

Reading a reference checkpoint needs none of this: the port's loader
(``checkpoint.load_torch_archive``) never imports the reference's
classes.
"""

import importlib
import importlib.machinery
import os
import sys
import types

_PYCOCOTOOLS = ("pycocotools", "pycocotools.coco", "pycocotools.mask",
                "pycocotools.cocoeval")
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_COCOAPI = os.path.join(_REPO_ROOT, "cocoapi", "PythonAPI")


def _module_missing(name):
    if name in sys.modules:
        return False
    try:
        importlib.import_module(name)
        return False
    except ImportError:
        return True


def _build_torchvision_stub():
    import torch
    from torch import nn

    class Bottleneck(nn.Module):
        expansion = 4

        def __init__(self, inplanes, planes, stride=1, downsample=None):
            super().__init__()
            self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
            self.bn1 = nn.BatchNorm2d(planes)
            self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride,
                                   padding=1, bias=False)
            self.bn2 = nn.BatchNorm2d(planes)
            self.conv3 = nn.Conv2d(planes, planes * self.expansion, 1,
                                   bias=False)
            self.bn3 = nn.BatchNorm2d(planes * self.expansion)
            self.relu = nn.ReLU(inplace=True)
            self.downsample = downsample
            self.stride = stride

        def forward(self, x):
            identity = x
            out = self.relu(self.bn1(self.conv1(x)))
            out = self.relu(self.bn2(self.conv2(out)))
            out = self.bn3(self.conv3(out))
            if self.downsample is not None:
                identity = self.downsample(x)
            return self.relu(out + identity)

    class ResNet(nn.Module):
        def __init__(self, block, layers, num_classes=1000):
            super().__init__()
            self.inplanes = 64
            self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3,
                                   bias=False)
            self.bn1 = nn.BatchNorm2d(64)
            self.relu = nn.ReLU(inplace=True)
            self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
            self.layer1 = self._make_layer(block, 64, layers[0])
            self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
            self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
            self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
            self.avgpool = nn.AdaptiveAvgPool2d((1, 1))
            self.fc = nn.Linear(512 * block.expansion, num_classes)

        def _make_layer(self, block, planes, depth, stride=1):
            downsample = None
            if stride != 1 or self.inplanes != planes * block.expansion:
                downsample = nn.Sequential(
                    nn.Conv2d(self.inplanes, planes * block.expansion, 1,
                              stride=stride, bias=False),
                    nn.BatchNorm2d(planes * block.expansion))
            blocks = [block(self.inplanes, planes, stride, downsample)]
            self.inplanes = planes * block.expansion
            for _ in range(1, depth):
                blocks.append(block(self.inplanes, planes))
            return nn.Sequential(*blocks)

        def forward(self, x):
            x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
            x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
            x = torch.flatten(self.avgpool(x), 1)
            return self.fc(x)

    def resnet101(pretrained=False, **kwargs):
        if pretrained:
            raise RuntimeError(
                "the torchvision stand-in cannot download weights; put "
                "the file at models/resnet101.pth (convert."
                "load_resnet101_pth reads it)")
        return ResNet(Bottleneck, [3, 4, 23, 3], **kwargs)

    resnet_mod = types.ModuleType("torchvision.models.resnet")
    for obj in (Bottleneck, ResNet):
        obj.__module__ = "torchvision.models.resnet"
        obj.__qualname__ = obj.__name__
    resnet_mod.Bottleneck = Bottleneck
    resnet_mod.ResNet = ResNet
    resnet_mod.resnet101 = resnet101

    models_mod = types.ModuleType("torchvision.models")
    models_mod.resnet = resnet_mod
    models_mod.ResNet = ResNet
    models_mod.resnet101 = resnet101

    transforms_mod = _build_transforms_module()
    tv = types.ModuleType("torchvision")
    tv.__is_icd_tpu_shim__ = True
    tv.models = models_mod
    tv.transforms = transforms_mod
    return {"torchvision": tv,
            "torchvision.models": models_mod,
            "torchvision.models.resnet": resnet_mod,
            "torchvision.transforms": transforms_mod}


def _build_transforms_module():
    """Compose / Resize / ToTensor / Normalize with torchvision's PIL
    semantics (the reference's entry points: models/baseline.py:123-128,
    models/attention.py:296-301): Resize takes an (h, w) tuple or the
    short side (the long side truncated, as torchvision's PIL path does),
    bilinear; ToTensor is HWC uint8 -> CHW float32 / 255; Normalize is
    per channel."""
    import numpy as np
    import torch

    class Compose:
        def __init__(self, transforms):
            self.transforms = list(transforms)

        def __call__(self, img):
            for t in self.transforms:
                img = t(img)
            return img

    class Resize:
        def __init__(self, size, interpolation=None):
            self.size = size
            self.interpolation = interpolation

        def __call__(self, img):
            from PIL import Image

            if isinstance(self.size, int):
                w, h = img.size
                short, long = (w, h) if w <= h else (h, w)
                new_long = int(self.size * long / short)
                nw, nh = ((self.size, new_long) if w <= h
                          else (new_long, self.size))
            else:
                nh, nw = self.size  # torchvision's order is (h, w)
            return img.resize((nw, nh), Image.BILINEAR
                              if self.interpolation is None
                              else self.interpolation)

    class ToTensor:
        def __call__(self, img):
            arr = np.asarray(img, dtype=np.uint8)
            if arr.ndim == 2:
                arr = arr[:, :, None]
            t = torch.from_numpy(arr.transpose(2, 0, 1).copy())
            return t.to(torch.float32).div(255)

    class Normalize:
        def __init__(self, mean, std):
            self.mean = mean
            self.std = std

        def __call__(self, t):
            mean = torch.as_tensor(self.mean, dtype=t.dtype)
            std = torch.as_tensor(self.std, dtype=t.dtype)
            return (t - mean[:, None, None]) / std[:, None, None]

    transforms_mod = types.ModuleType("torchvision.transforms")
    for cls in (Compose, Resize, ToTensor, Normalize):
        cls.__module__ = "torchvision.transforms"
        setattr(transforms_mod, cls.__name__, cls)
    return transforms_mod


def _bert_dir():
    src = os.environ.get("BERT_MODEL_DIR")
    if not src:
        raise RuntimeError(
            "the pytorch_pretrained_bert stand-in cannot download weights; "
            "set BERT_MODEL_DIR to a save_pretrained directory "
            "(config.json, model.safetensors or pytorch_model.bin, "
            "vocab.txt)")
    return src


def _build_bert_stub():
    from torch import nn

    class BertModel(nn.Module):
        """pytorch_pretrained_bert.BertModel stand-in: it unpickles (the
        class only has to resolve by name), and ``from_pretrained``
        holds the port's ``BertEncoder`` read from ``BERT_MODEL_DIR``
        (what the reference's decoder constructor calls,
        attention.py:96-100)."""

        @classmethod
        def from_pretrained(cls, *args, **kwargs):
            from .models.bert_load import bert_from_state_dict, load_bert_dir

            self = cls()
            self.bert = bert_from_state_dict(*load_bert_dir(_bert_dir()))
            return self

    class BertTokenizer:
        @classmethod
        def from_pretrained(cls, *args, **kwargs):
            from .models.bert_tokenize import BertTokenizer as _Tokenizer

            return _Tokenizer(os.path.join(_bert_dir(), "vocab.txt"))

    modeling = types.ModuleType("pytorch_pretrained_bert.modeling")
    tokenization = types.ModuleType("pytorch_pretrained_bert.tokenization")
    BertModel.__module__ = "pytorch_pretrained_bert.modeling"
    BertModel.__qualname__ = "BertModel"
    BertTokenizer.__module__ = "pytorch_pretrained_bert.tokenization"
    BertTokenizer.__qualname__ = "BertTokenizer"
    modeling.BertModel = BertModel
    tokenization.BertTokenizer = BertTokenizer

    pkg = types.ModuleType("pytorch_pretrained_bert")
    pkg.__is_icd_tpu_shim__ = True
    pkg.modeling = modeling
    pkg.tokenization = tokenization
    pkg.BertModel = BertModel
    pkg.BertTokenizer = BertTokenizer
    return {"pytorch_pretrained_bert": pkg,
            "pytorch_pretrained_bert.modeling": modeling,
            "pytorch_pretrained_bert.tokenization": tokenization}


def _installed_pycocotools():
    """Whether a pycocotools other than the repository's icd_tpu shim (and
    other than these stand-ins) is importable, found without importing
    it: importing the shim would import the JAX package."""
    mod = sys.modules.get("pycocotools")
    if mod is not None:
        origin = os.path.abspath(getattr(mod, "__file__", None) or "")
        return not (origin.startswith(_REPO_COCOAPI + os.sep)
                    or getattr(mod, "__is_icd_tpu_shim__", False))
    paths = [p for p in sys.path
             if os.path.abspath(p or os.curdir) != _REPO_COCOAPI]
    return importlib.machinery.PathFinder.find_spec(
        "pycocotools", paths) is not None


def _build_pycocotools_stub():
    """``pycocotools``, ``.coco``, ``.mask`` and ``.cocoeval`` over the
    port's modules."""
    from .data import coco, cocoeval
    from .native import mask

    coco_mod = types.ModuleType("pycocotools.coco")
    coco_mod.COCO = coco.COCO
    coco_mod._is_array_like = coco._is_array_like
    mask_mod = types.ModuleType("pycocotools.mask")
    for name in ("encode", "decode", "merge", "area", "iou", "toBbox",
                 "frBbox", "frPoly", "frUncompressedRLE", "frPyObjects",
                 "nms", "bbNms"):
        setattr(mask_mod, name, getattr(mask, name))
    eval_mod = types.ModuleType("pycocotools.cocoeval")
    eval_mod.COCOeval = cocoeval.COCOeval
    eval_mod.Params = cocoeval.Params
    pkg = types.ModuleType("pycocotools")
    pkg.__path__ = []  # a package: its submodules resolve in sys.modules
    pkg.__is_icd_tpu_shim__ = True
    pkg.coco, pkg.mask, pkg.cocoeval = coco_mod, mask_mod, eval_mod
    return dict(zip(_PYCOCOTOOLS, (pkg, coco_mod, mask_mod, eval_mod)))


class _RaisingModule(types.ModuleType):
    def __getattr__(self, name):
        if name.startswith("__") and name.endswith("__"):
            raise AttributeError(name)  # introspection probes dunders
        raise RuntimeError(
            "{}.{} is a stand-in for importing the reference's modules "
            "only; the real package is not installed.".format(
                self.__name__, name))


def _with_specs(mods):
    """Stand-in modules get a ``__spec__``: ``importlib.util.find_spec``
    raises ``ValueError`` on a spec-less ``sys.modules`` entry."""
    for name, mod in mods.items():
        if mod.__spec__ is None:
            mod.__spec__ = importlib.machinery.ModuleSpec(name, None)
    return mods


def install_reference_shims(reference_root):
    """Make the reference's modules importable: its root APPENDED to
    ``sys.path`` (its ``models``, ``vocabulary``, ``train`` and ``eval``
    would otherwise shadow same-named modules; appended, they resolve
    only where nothing else has the name), and stand-ins for the missing
    packages above. Returns the state ``uninstall_reference_shims``
    undoes."""
    state = {"root": os.path.abspath(reference_root), "paths": [],
             "modules": [], "displaced": {}}
    if reference_root not in sys.path and os.path.isdir(reference_root):
        sys.path.append(reference_root)
        state["paths"].append(reference_root)

    stubs = {}
    if not _installed_pycocotools():
        stubs.update(_build_pycocotools_stub())
        state["displaced"] = {name: sys.modules[name]
                              for name in _PYCOCOTOOLS if name in sys.modules}
    if _module_missing("torchvision"):
        stubs.update(_build_torchvision_stub())
    if _module_missing("pytorch_pretrained_bert"):
        stubs.update(_build_bert_stub())
    if _module_missing("bcolz"):
        bcolz = _RaisingModule("bcolz")
        bcolz.__is_icd_tpu_shim__ = True
        stubs["bcolz"] = bcolz
    sys.modules.update(_with_specs(stubs))
    state["modules"].extend(stubs)
    return state


def uninstall_reference_shims(state):
    """Undo ``install_reference_shims``: restore ``sys.path``, evict the
    stand-ins and every module imported from the reference root, and put
    back the modules the stand-ins displaced."""
    for p in state["paths"]:
        if p in sys.path:
            sys.path.remove(p)
    for name in state["modules"]:
        sys.modules.pop(name, None)
    sys.modules.update(state["displaced"])
    root = state["root"] + os.sep
    for name, mod in list(sys.modules.items()):
        f = getattr(mod, "__file__", None)
        if f and os.path.abspath(f).startswith(root):
            del sys.modules[name]
