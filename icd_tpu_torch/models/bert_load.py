"""Read a BERT ``save_pretrained`` directory without ``transformers``.

The JAX package loads bert-base with ``BertModel.from_pretrained``
(``icd_tpu/models/bert_embed.py:291-305``). The machine with the card
has no ``transformers`` and may have no ``safetensors``, so the port
reads the directory itself:

- ``config.json``: the geometry (``num_hidden_layers``,
  ``num_attention_heads``, ``hidden_size``, ``intermediate_size``,
  ``layer_norm_eps``, ``vocab_size``, ``max_position_embeddings``);
- ``model.safetensors``, parsed here: an 8-byte little-endian header
  length, a JSON header naming each tensor's dtype, shape and byte
  range, then the raw data (``F32``, ``F16`` or ``BF16``);
- or else ``pytorch_model.bin`` (``torch.load(weights_only=True)``).

Keys may carry a ``bert.`` prefix (a checkpoint of a model with a head)
and old LayerNorm names (``gamma``/``beta``); the pooler and any head
are ignored.
"""

import json
import os

import numpy as np
import torch

from .bert import BertEncoder

_SAFETENSORS_DTYPES = {"F32": np.float32, "F16": np.float16,
                       "BF16": np.uint16}


def read_safetensors(path):
    """{name: float32 array} of a ``.safetensors`` file."""
    with open(path, "rb") as f:
        raw = f.read()
    n = int.from_bytes(raw[:8], "little")
    header = json.loads(raw[8:8 + n].decode("utf-8"))
    data = memoryview(raw)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = info["dtype"]
        if dtype not in _SAFETENSORS_DTYPES:
            raise ValueError("{}: tensor {} has dtype {}, not one of {}".format(
                path, name, dtype, sorted(_SAFETENSORS_DTYPES)))
        begin, end = info["data_offsets"]
        a = np.frombuffer(data[begin:end], _SAFETENSORS_DTYPES[dtype])
        if dtype == "BF16":  # the high half of an f32
            a = (a.astype(np.uint32) << 16).view(np.float32)
        out[name] = a.astype(np.float32).reshape(info["shape"])
    return out


def _canonical(name):
    if name.startswith("bert."):
        name = name[len("bert."):]
    return name.replace("LayerNorm.gamma", "LayerNorm.weight").replace(
        "LayerNorm.beta", "LayerNorm.bias")


def load_bert_dir(path):
    """(state dict of float32 numpy arrays keyed as ``BertModel``'s, without
    a ``bert.`` prefix; config dict) of a ``save_pretrained`` directory."""
    with open(os.path.join(path, "config.json")) as f:
        config = json.load(f)
    safetensors = os.path.join(path, "model.safetensors")
    if os.path.exists(safetensors):
        raw = read_safetensors(safetensors)
    else:
        bin_path = os.path.join(path, "pytorch_model.bin")
        if not os.path.exists(bin_path):
            raise FileNotFoundError(
                "{} holds neither model.safetensors nor pytorch_model.bin"
                .format(path))
        raw = {k: v.float().numpy() for k, v in torch.load(
            bin_path, map_location="cpu", weights_only=True).items()}
    state = {}
    for name, value in raw.items():
        name = _canonical(name)
        if name.startswith(("embeddings.", "encoder.")):
            state[name] = value
    return state, config


def _copy(param, value):
    param.copy_(torch.from_numpy(np.asarray(value, np.float32)))


def bert_from_state_dict(state, config):
    """A ``BertEncoder`` (CPU, eval mode, frozen) holding a ``BertModel``
    state dict's weights (``bert_jax.bert_from_torch``, bert_jax.py:45)."""
    bert = BertEncoder.from_config(config)
    parts = {"q": "attention.self.query", "k": "attention.self.key",
             "v": "attention.self.value", "o": "attention.output.dense",
             "ln_att": "attention.output.LayerNorm",
             "ffn_in": "intermediate.dense", "ffn_out": "output.dense",
             "ln_out": "output.LayerNorm"}
    with torch.no_grad():
        for ours, theirs in (("word", "word_embeddings"),
                             ("pos", "position_embeddings"),
                             ("token_type", "token_type_embeddings")):
            _copy(getattr(bert, ours).weight,
                  state["embeddings.{}.weight".format(theirs)])
        for key in ("weight", "bias"):
            _copy(getattr(bert.ln_emb, key),
                  state["embeddings.LayerNorm." + key])
        for i, layer in enumerate(bert.layers):
            for ours, theirs in parts.items():
                for key in ("weight", "bias"):
                    _copy(getattr(getattr(layer, ours), key),
                          state["encoder.layer.{}.{}.{}".format(i, theirs,
                                                                key)])
    return bert.eval().requires_grad_(False)
