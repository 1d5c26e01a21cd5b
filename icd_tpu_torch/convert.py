"""Converters from the reference's PyTorch artifacts to the JAX-layout
numpy trees (port of ``icd_tpu/convert.py``).

- torchvision ResNet-101 ``resnet101.pth`` state dicts (the file the
  reference downloads, models/encoder.py:9-20): ``load_resnet101_pth``;
- the reference's whole-module checkpoints (``torch.save`` of the
  modules themselves, checkpoint.py:51-60): ``convert_reference_checkpoint``,
  read through ``checkpoint.load_torch_archive``, which runs none of the
  reference's code and needs neither its checkout nor torchvision;
- plain state dicts of the reference's Encoder / BaselineDecoder /
  AttentionDecoder modules (the encoder wraps the backbone in
  ``nn.Sequential``, so keys read ``resnet.4.0.conv1.weight``).

The trees are the ones ``icd_tpu``'s converters return, as float32
numpy arrays: convolution kernels HWIO, linears (in, out), LSTM weights
(in, 4H) in PyTorch's (i, f, g, o) gate order. ``params.py`` turns them
into the port's modules.
"""

import numpy as np
import torch

RESNET101_DEPTHS = (3, 4, 23, 3)

# torch nn.Sequential(list(resnet.children())[:k]) index -> torchvision name
_SEQ_TO_NAME = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2",
                "6": "layer3", "7": "layer4"}


def _arr(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


def _lin(sd, prefix):
    return {"w": _arr(sd[prefix + ".weight"]).T.copy(),
            "b": _arr(sd[prefix + ".bias"])}


def resnet_from_torch_state_dict(sd, depths=RESNET101_DEPTHS):
    """A torchvision-named ResNet state dict (conv1.*, bn1.*,
    layer{1..4}.{i}.conv{1..3} / bn{1..3}, layer{x}.0.downsample.{0,1})
    -> the JAX ResNet tree (``icd_tpu/models/resnet.py:266``); the
    classifier ``fc.*`` is dropped, as the reference drops it
    (models/encoder.py:38-39)."""

    def conv(name):
        return np.ascontiguousarray(_arr(sd[name]).transpose(2, 3, 1, 0))

    def bn(prefix):
        return {"scale": _arr(sd[prefix + ".weight"]),
                "bias": _arr(sd[prefix + ".bias"]),
                "mean": _arr(sd[prefix + ".running_mean"]),
                "var": _arr(sd[prefix + ".running_var"])}

    tree = {"stem": {"conv": conv("conv1.weight"), "bn": bn("bn1")},
            "layers": []}
    for stage, depth in enumerate(depths):
        blocks = []
        for b in range(depth):
            p = "layer{}.{}".format(stage + 1, b)
            block = {}
            for i in (1, 2, 3):
                block["conv{}".format(i)] = conv("{}.conv{}.weight".format(p, i))
                block["bn{}".format(i)] = bn("{}.bn{}".format(p, i))
            if p + ".downsample.0.weight" in sd:
                block["downsample"] = {"conv": conv(p + ".downsample.0.weight"),
                                       "bn": bn(p + ".downsample.1")}
            blocks.append(block)
        tree["layers"].append(blocks)
    return tree


def from_torch_lstm(weight_ih, weight_hh, bias_ih, bias_hh):
    """torch (4H, in) / (4H, H) LSTM weights -> {wi (in, 4H), wh (H, 4H),
    bi, bh} (``icd_tpu/models/lstm.py:32``)."""
    return {"wi": _arr(weight_ih).T.copy(), "wh": _arr(weight_hh).T.copy(),
            "bi": _arr(bias_ih), "bh": _arr(bias_hh)}


def _unwrap_sequential(sd, wrapper="resnet."):
    """Map 'resnet.4.0.conv1.weight' -> 'layer1.0.conv1.weight'."""
    out = {}
    for key, val in sd.items():
        if key.startswith(wrapper):
            rest = key[len(wrapper):]
            idx, _, tail = rest.partition(".")
            name = _SEQ_TO_NAME.get(idx)
            if name is None:
                continue  # relu/maxpool/avgpool have no params
            out[name + ("." + tail if tail else "")] = val
    return out


def _infer_depths(resnet_sd):
    depths = []
    for stage in range(1, 5):
        blocks = {int(k.split(".")[1]) for k in resnet_sd
                  if k.startswith("layer{}.".format(stage))}
        depths.append(max(blocks) + 1 if blocks else 0)
    return tuple(depths)


def convert_encoder_state_dict(sd):
    """Reference Encoder/EncoderAttention state dict -> the encoder tree."""
    resnet_sd = _unwrap_sequential(sd)
    tree = {"resnet": resnet_from_torch_state_dict(
        resnet_sd, depths=_infer_depths(resnet_sd))}
    if "embed.weight" in sd:
        tree["embed"] = _lin(sd, "embed")
    return tree


def load_resnet101_pth(path):
    """torchvision ``resnet101.pth`` -> the backbone tree (classifier
    dropped). The file is read with ``weights_only=True``: tensors and
    containers only. The depths are read off its keys, (3, 4, 23, 3) for
    ResNet-101."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return resnet_from_torch_state_dict(sd, depths=_infer_depths(sd))


def convert_baseline_decoder_state_dict(sd):
    """Reference BaselineDecoder state dict -> the baseline decoder tree
    (models/baseline.py:43-57 naming)."""
    return {
        "embedding": _arr(sd["embedding.weight"]),
        "lstm": from_torch_lstm(
            sd["lstm.weight_ih_l0"], sd["lstm.weight_hh_l0"],
            sd["lstm.bias_ih_l0"], sd["lstm.bias_hh_l0"]),
        "linear": _lin(sd, "linear"),
    }


def convert_attention_decoder_state_dict(sd):
    """Reference AttentionDecoder state dict -> the attention decoder tree
    (models/attention.py:102-123 naming)."""
    return {
        "attention": {
            "enc_att": _lin(sd, "attention.enc_att"),
            "dec_att": _lin(sd, "attention.dec_att"),
            "full_att": _lin(sd, "attention.full_att"),
        },
        "lstm": from_torch_lstm(
            sd["decode_step.weight_ih"], sd["decode_step.weight_hh"],
            sd["decode_step.bias_ih"], sd["decode_step.bias_hh"]),
        "h_lin": _lin(sd, "h_lin"),
        "c_lin": _lin(sd, "c_lin"),
        "f_beta": _lin(sd, "f_beta"),
        "fc": _lin(sd, "fc"),
        "embedding": _arr(sd["embedding.weight"]),
    }


def convert_reference_checkpoint(path, model_type=None):
    """A reference ``.pth.tar`` (whole pickled modules,
    checkpoint.py:51-60) -> the port's checkpoint dict
    (``icd_tpu/convert.py:115``): epoch, metrics, the encoder and decoder
    trees, no optimizer state, and a ``config`` with ``model``
    (``model_type``, else "attention" when the decoder has an
    ``attention`` submodule) and ``use_bert`` as the pickled decoder
    carries it (the reference's eval relies on it, attention.py:96,242).

    The pickle is read by ``checkpoint.load_torch_archive``: the
    reference's classes become inert stand-ins that keep their state,
    and a global outside its admitted set is refused before anything
    runs."""
    from .checkpoint import load_torch_archive

    chkpt = load_torch_archive(path)
    encoder_sd = chkpt["encoder"].state_dict()
    decoder = chkpt["decoder"]
    decoder_sd = decoder.state_dict()
    if model_type is None:
        model_type = ("attention" if any(
            k.startswith("attention.") for k in decoder_sd) else "baseline")
    if model_type == "attention":
        dec_tree = convert_attention_decoder_state_dict(decoder_sd)
    else:
        dec_tree = convert_baseline_decoder_state_dict(decoder_sd)
    return {
        "epoch": chkpt["epoch"],
        "metrics": chkpt.get("metrics", {}),
        "encoder": convert_encoder_state_dict(encoder_sd),
        "decoder": dec_tree,
        "encoder_optimizer": None,
        "decoder_optimizer": None,
        "config": {"model": model_type,
                   "use_bert": bool(getattr(decoder, "use_bert", False))},
    }
