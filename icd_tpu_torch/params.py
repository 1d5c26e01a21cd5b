"""The weight bridge: the JAX package's numpy pytrees <-> the port's modules.

The trees are the payload ``icd_tpu/checkpoint.py:98-115`` pickles:
``encoder`` = ``{"resnet": ...}`` (attention) or ``{"resnet", "embed"}``
(baseline), ``decoder`` = the attention or the baseline decoder's tree,
told apart by their keys. Layouts:

- convolution kernels HWIO (JAX) <-> OIHW (here);
- Linear ``w`` (in, out) <-> ``nn.Linear.weight`` (out, in);
- LSTM ``wi`` (in, 4H) / ``wh`` (H, 4H) <-> ``weight_ih`` (4H, in) /
  ``weight_hh`` (4H, H), gate order (i, f, g, o) on both sides;
- BN ``scale``/``bias``/``mean``/``var`` and the embedding table as they are.

Shapes are read off the tree, so any ResNet depth or decoder width
converts. ``*_to_jax`` are the inverses and return float32 numpy trees.
Converted modules live on the CPU; move them with ``.to(device)``.

Adam's state crosses the same bridge: ``adam_state_to_jax`` writes the
port's optimizer state as ``{"count", "mu", "nu"}``, numpy trees keyed
like the JAX trainable tree (``{"decoder": {...}}``, and ``{"encoder":
{"embed": ...}}`` when the baseline's head trains; frozen leaves left
out, JAX layouts), which ``checkpoint.save_checkpoint`` writes as
optax's state; ``adam_moments`` reads either form back to it, and
``adam_state_from_jax`` into ``torch.optim.Adam`` state, for either
model family.

The quantized trees (``quantize_resnet``'s,
``quantize_attention_decoder``'s and ``quantize_baseline_decoder``'s)
are dicts of tensors with the JAX tree's keys and values; ``qresnet_*``
and ``qdecoder_*`` convert them both ways, int8 kept int8. Their int8
weights keep the JAX layout, HWIO and (I, O), stored column-major for
cuBLASLt, and the decoders' have their columns padded to a multiple of
8 (``ops/qlinear.py``), which ``qdecoder_to_jax`` slices off.
"""

import numpy as np
import torch

from .models.attention import AttentionDecoder
from .models.baseline import BaselineDecoder
from .models.bert import BertEncoder, QLinear
from .models.encoder import Encoder, EncoderAttention
from .models.resnet import ResNet
from .ops.quant import gemm_layout, pad_columns


def _tensor(x):
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes arrays: no torch view
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _numpy(t):
    return t.detach().to("cpu", torch.float32).numpy().copy()


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _conv_from(w):
    return _tensor(w).permute(3, 2, 0, 1).contiguous()  # HWIO -> OIHW


def _conv_to(t):
    return _numpy(t).transpose(2, 3, 1, 0).copy()  # OIHW -> HWIO


def _bn_from(bn, tree):
    bn.scale.data = _tensor(tree["scale"])
    bn.bias.data = _tensor(tree["bias"])
    bn.mean = _tensor(tree["mean"])
    bn.var = _tensor(tree["var"])


def _bn_to(bn):
    return {"scale": _numpy(bn.scale), "bias": _numpy(bn.bias),
            "mean": _numpy(bn.mean), "var": _numpy(bn.var)}


def resnet_from_jax(tree):
    """A ``ResNet`` module holding the JAX ResNet tree's values."""
    depths = [len(blocks) for blocks in tree["layers"]]
    widths = [blocks[0]["conv1"].shape[-1] for blocks in tree["layers"]]
    in_channels = tree["stem"]["conv"].shape[2]
    net = ResNet(depths, widths, in_channels)
    net.stem.conv.data = _conv_from(tree["stem"]["conv"])
    _bn_from(net.stem.bn, tree["stem"]["bn"])
    for blocks, tblocks in zip(net.layers, tree["layers"]):
        for block, tb in zip(blocks, tblocks):
            for i in (1, 2, 3):
                getattr(block, "conv{}".format(i)).data = _conv_from(
                    tb["conv{}".format(i)])
                _bn_from(getattr(block, "bn{}".format(i)),
                         tb["bn{}".format(i)])
            if ("downsample" in tb) != (block.downsample is not None):
                raise ValueError("downsample layout differs from the "
                                 "ResNet structure of these widths")
            if block.downsample is not None:
                block.downsample.conv.data = _conv_from(
                    tb["downsample"]["conv"])
                _bn_from(block.downsample.bn, tb["downsample"]["bn"])
    return net


def resnet_to_jax(net):
    tree = {"stem": {"conv": _conv_to(net.stem.conv),
                     "bn": _bn_to(net.stem.bn)},
            "layers": []}
    for blocks in net.layers:
        tblocks = []
        for block in blocks:
            tb = {}
            for i in (1, 2, 3):
                tb["conv{}".format(i)] = _conv_to(
                    getattr(block, "conv{}".format(i)))
                tb["bn{}".format(i)] = _bn_to(getattr(block, "bn{}".format(i)))
            if block.downsample is not None:
                tb["downsample"] = {"conv": _conv_to(block.downsample.conv),
                                    "bn": _bn_to(block.downsample.bn)}
            tblocks.append(tb)
        tree["layers"].append(tblocks)
    return tree


def encoder_from_jax(tree):
    """``Encoder`` from a baseline-encoder tree (it has ``embed``), else
    ``EncoderAttention``."""
    resnet = resnet_from_jax(tree["resnet"])
    if "embed" not in tree:
        return EncoderAttention(resnet)
    embed = torch.nn.Linear(*np.shape(tree["embed"]["w"]), device="meta")
    embed = embed.to_empty(device="cpu")
    _linear_from(embed, tree["embed"])
    return Encoder(resnet, embed)


def encoder_to_jax(encoder):
    tree = {"resnet": resnet_to_jax(encoder.resnet)}
    if isinstance(encoder, Encoder):
        tree["embed"] = _linear_to(encoder.embed)
    return tree


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def _linear_from(lin, tree):
    lin.weight.data = _tensor(tree["w"]).t().contiguous()
    lin.bias.data = _tensor(tree["b"])


def _linear_to(lin):
    return {"w": _numpy(lin.weight).T.copy(), "b": _numpy(lin.bias)}


def _lstm_from(cell, tree):
    cell.weight_ih.data = _tensor(tree["wi"]).t().contiguous()
    cell.weight_hh.data = _tensor(tree["wh"]).t().contiguous()
    cell.bias_ih.data = _tensor(tree["bi"])
    cell.bias_hh.data = _tensor(tree["bh"])


def decoder_from_jax(tree):
    """``AttentionDecoder`` from a JAX attention-decoder tree, or
    ``BaselineDecoder`` from a baseline one (it has ``linear``)."""
    if "linear" in tree:
        return _baseline_decoder_from_jax(tree)
    att = tree["attention"]
    enc_dim, att_dim = np.shape(att["enc_att"]["w"])
    dec_dim = np.shape(att["dec_att"]["w"])[0]
    vocab_size, embed_size = np.shape(tree["embedding"])
    with torch.device("meta"):
        dec = AttentionDecoder(vocab_size, att_dim, dec_dim, embed_size,
                               enc_dim)
    dec = dec.to_empty(device="cpu")
    for name in ("enc_att", "dec_att", "full_att"):
        _linear_from(getattr(dec.attention, name), att[name])
    for name in ("h_lin", "c_lin", "f_beta", "fc"):
        _linear_from(getattr(dec, name), tree[name])
    _lstm_from(dec.lstm, tree["lstm"])
    dec.embedding.weight.data = _tensor(tree["embedding"])
    return dec


def _baseline_decoder_from_jax(tree):
    vocab_size, embed_size = np.shape(tree["embedding"])
    hidden_size = np.shape(tree["lstm"]["wh"])[0]
    with torch.device("meta"):
        dec = BaselineDecoder(vocab_size, embed_size, hidden_size)
    dec = dec.to_empty(device="cpu")
    dec.embedding.weight.data = _tensor(tree["embedding"])
    _lstm_from(dec.lstm, tree["lstm"])
    _linear_from(dec.linear, tree["linear"])
    return dec


def decoder_to_jax(dec):
    tree = {}
    for path, param, transposed in decoder_leaves(dec):
        value = _numpy(param)
        _put(tree, path, value.T.copy() if transposed else value)
    return tree


def attention_leaves(dec):
    """(path in the JAX tree, parameter, stored transposed) for every
    parameter of an ``AttentionDecoder``."""
    leaves = []
    for name in ("enc_att", "dec_att", "full_att"):
        lin = getattr(dec.attention, name)
        leaves += [(("attention", name, "w"), lin.weight, True),
                   (("attention", name, "b"), lin.bias, False)]
    leaves += _lstm_leaves(dec.lstm)
    for name in ("h_lin", "c_lin", "f_beta", "fc"):
        leaves += _linear_leaves((name,), getattr(dec, name))
    leaves.append((("embedding",), dec.embedding.weight, False))
    return leaves


def _lstm_leaves(cell):
    return [(("lstm", "wi"), cell.weight_ih, True),
            (("lstm", "wh"), cell.weight_hh, True),
            (("lstm", "bi"), cell.bias_ih, False),
            (("lstm", "bh"), cell.bias_hh, False)]


def _linear_leaves(path, lin):
    return [(path + ("w",), lin.weight, True),
            (path + ("b",), lin.bias, False)]


def decoder_leaves(dec):
    """``attention_leaves``, or the same for a ``BaselineDecoder``:
    ``embedding``, ``lstm.{wi,wh,bi,bh}``, ``linear.{w,b}``."""
    if not isinstance(dec, BaselineDecoder):
        return attention_leaves(dec)
    return ([(("embedding",), dec.embedding.weight, False)]
            + _lstm_leaves(dec.lstm) + _linear_leaves(("linear",), dec.linear))


def trainable_leaves(dec, encoder=None):
    """The leaves Adam may step, keyed like the JAX trainable tree: the
    decoder's under ``"decoder"`` and, for a baseline ``Encoder``, its
    ``embed`` head's under ``"encoder"``."""
    leaves = [(("decoder",) + path, param, transposed)
              for path, param, transposed in decoder_leaves(dec)]
    if isinstance(encoder, Encoder):
        leaves += _linear_leaves(("encoder", "embed"), encoder.embed)
    return leaves


def _put(tree, path, value):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _get(tree, path):
    for key in path:
        if not isinstance(tree, dict) or key not in tree:
            return None
        tree = tree[key]
    return tree


# ---------------------------------------------------------------------------
# Adam state
# ---------------------------------------------------------------------------

def adam_state_to_jax(optimizer, dec, encoder=None):
    """The port's form of ``optimizer``'s state over the decoder ``dec``
    (and the baseline ``encoder``'s head): ``{"count": int32, "mu": tree,
    "nu": tree}``, the trees keyed like the JAX trainable tree, holding
    every parameter the optimizer steps (zeros before its first step).
    ``checkpoint.save_checkpoint`` writes it as icd_tpu's optax state."""
    stepped = {id(p) for group in optimizer.param_groups
               for p in group["params"]}
    count, mu, nu = 0, {}, {}
    for path, param, transposed in trainable_leaves(dec, encoder):
        if id(param) not in stepped:
            continue
        state = optimizer.state.get(param)
        if state:
            count = int(state["step"])
        for tree, key in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
            value = (_numpy(state[key]) if state
                     else np.zeros(tuple(param.shape), np.float32))
            _put(tree, path, value.T.copy() if transposed else value)
    return {"count": np.int32(count), "mu": mu, "nu": nu}


def _array_leaves(tree):
    """A moment tree with only its arrays: None (frozen) and optax's
    ``MaskedNode`` (the other group's leaves) dropped, empty subtrees
    too."""
    if isinstance(tree, dict):
        out = {k: _array_leaves(v) for k, v in tree.items()}
        return {k: v for k, v in out.items() if v is not None} or None
    if isinstance(tree, list):
        out = [_array_leaves(v) for v in tree]
        return out if any(v is not None for v in out) else None
    if tree is None or isinstance(tree, tuple):
        return None
    return np.asarray(tree)


def _merge(into, tree):
    for key, value in tree.items():
        if isinstance(value, dict) and isinstance(into.get(key), dict):
            _merge(into[key], value)
        else:
            into[key] = value


def _optax_adam_states(node):
    """Every optax ``ScaleByAdamState`` (optax's own class, or the inert
    stand-in of ``checkpoint.py``) in an optimizer state."""
    name = getattr(node, "source", None) or type(node).__name__
    if name.endswith("ScaleByAdamState"):
        yield node
    elif isinstance(node, dict):
        for value in node.values():
            yield from _optax_adam_states(value)
    elif isinstance(node, (tuple, list)):
        for value in node:
            yield from _optax_adam_states(value)


def adam_moments(state):
    """A checkpoint's Adam state in the port's form ({"count", "mu",
    "nu"}, only the trained leaves): the port's form as it is, or
    icd_tpu's optax state (``multi_transform`` -> ``masked`` -> (clip,
    (ScaleByAdamState(count, mu, nu), ...)) per parameter group, each
    group's moment trees holding a ``MaskedNode`` at the other group's
    leaves), its groups merged."""
    if isinstance(state, dict) and "mu" in state:
        return state
    out = {"count": None, "mu": {}, "nu": {}}
    for count, mu, nu in (tuple(s) for s in _optax_adam_states(state)):
        out["count"] = count
        for key, tree in (("mu", mu), ("nu", nu)):
            _merge(out[key], _array_leaves(tree) or {})
    return out


def adam_state_from_jax(state, dec, encoder=None):
    """``torch.optim.Adam`` state, {parameter: {"step", "exp_avg",
    "exp_avg_sq"}}, for the parameters of the decoder ``dec`` (and the
    baseline ``encoder``'s head) that ``state`` holds moments for, on
    their devices. ``state`` is either form ``adam_moments`` reads."""
    adam = adam_moments(state)
    out = {}
    for path, param, transposed in trainable_leaves(dec, encoder):
        m, v = (_get(adam[key], path) for key in ("mu", "nu"))
        if not isinstance(m, np.ndarray):
            continue  # frozen

        def moment(x):
            x = np.asarray(x, np.float32)
            t = torch.from_numpy(x.T.copy() if transposed else x.copy())
            return t.to(device=param.device, dtype=param.dtype)

        out[param] = {"step": torch.tensor(float(adam["count"])),
                      "exp_avg": moment(m), "exp_avg_sq": moment(v)}
    return out


# ---------------------------------------------------------------------------
# Quantized trees
# ---------------------------------------------------------------------------

def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _leaf_to(t):
    return t.detach().cpu().numpy().copy()


def qresnet_from_jax(tree):
    """The port's int8 ResNet tree from ``icd_tpu``'s ``quantize_resnet``
    tree, on the CPU."""
    def leaf(x):
        t = _tensor(x)
        return gemm_layout(t) if t.dtype == torch.int8 else t
    return _map(leaf, tree)


def qresnet_to_jax(tree):
    return _map(_leaf_to, tree)


# The int8 weights of the two quantized decoder trees: the attention
# decoder's vocab projection is "fc", the baseline's "linear".
_QPAIRS = (("lstm", "wiq", "wis"), ("lstm", "whq", "whs"), ("fc", "wq", "ws"),
           ("linear", "wq", "ws"))


def qdecoder_from_jax(tree):
    """The port's int8 decoder tree from ``icd_tpu``'s
    ``quantize_attention_decoder`` or ``quantize_baseline_decoder`` tree,
    on the CPU."""
    out = _map(_tensor, tree)
    for part, wq, _ in _QPAIRS:
        if part in out:
            out[part][wq] = pad_columns(out[part][wq])
    return out


def qdecoder_to_jax(tree):
    out = _map(_leaf_to, tree)
    for part, wq, ws in _QPAIRS:
        if part in out:
            out[part][wq] = out[part][wq][:, :len(out[part][ws])].copy()
    return out


# ---------------------------------------------------------------------------
# BERT
# ---------------------------------------------------------------------------

_BERT_LINEARS = ("q", "k", "v", "o", "ffn_in", "ffn_out")
_BERT_TABLES = (("word", "word"), ("pos", "pos"), ("type", "token_type"))


def _ln_from(ln, tree):
    ln.weight.data = _tensor(tree["scale"])
    ln.bias.data = _tensor(tree["bias"])


def _ln_to(ln):
    return {"scale": _numpy(ln.weight), "bias": _numpy(ln.bias)}


def bert_from_jax(params, config):
    """A ``BertEncoder`` (CPU, eval mode, frozen) from the JAX package's
    BERT tree (``bert_jax.bert_from_torch``: Linear ``w`` (in, out)) and
    its config {"num_heads", "ln_eps"}. A quantized tree
    (``quantize_bert_params``: ``wq``/``ws``/``b`` leaves) gives the W8A8
    form with ``QLinear``s."""
    layers = params["layers"]
    first = layers[0]["ffn_in"]
    intermediate = np.shape(first["w"] if "w" in first else first["wq"])[1]
    vocab_size, hidden = np.shape(params["word"])
    bert = BertEncoder.from_config(dict(
        vocab_size=vocab_size, hidden_size=hidden,
        num_hidden_layers=len(layers),
        num_attention_heads=config["num_heads"],
        intermediate_size=intermediate,
        max_position_embeddings=np.shape(params["pos"])[0],
        type_vocab_size=np.shape(params["type"])[0],
        layer_norm_eps=config["ln_eps"]))
    for name, ours in _BERT_TABLES:
        getattr(bert, ours).weight.data = _tensor(params[name])
    _ln_from(bert.ln_emb, params["ln_emb"])
    for layer, tree in zip(bert.layers, layers):
        for name in _BERT_LINEARS:
            if "wq" in tree[name]:
                setattr(layer, name, QLinear(
                    pad_columns(_tensor(tree[name]["wq"])),
                    _tensor(tree[name]["ws"]), _tensor(tree[name]["b"])))
            else:
                _linear_from(getattr(layer, name), tree[name])
        _ln_from(layer.ln_att, tree["ln_att"])
        _ln_from(layer.ln_out, tree["ln_out"])
    return bert.eval().requires_grad_(False)


def bert_to_jax(bert):
    """(params tree, config) of a ``BertEncoder`` as the JAX package lays
    them out; a ``QLinear`` becomes {"wq", "ws", "b"}, the int8 weight
    without its column padding."""
    def linear(lin):
        if isinstance(lin, QLinear):
            return {"wq": _leaf_to(lin.wq)[:, :len(lin.ws)].copy(),
                    "ws": _leaf_to(lin.ws), "b": _leaf_to(lin.b)}
        return _linear_to(lin)

    params = {name: _numpy(getattr(bert, ours).weight)
              for name, ours in _BERT_TABLES}
    params["ln_emb"] = _ln_to(bert.ln_emb)
    params["layers"] = [
        dict({name: linear(getattr(layer, name)) for name in _BERT_LINEARS},
             ln_att=_ln_to(layer.ln_att), ln_out=_ln_to(layer.ln_out))
        for layer in bert.layers]
    return params, {"num_heads": bert.num_heads,
                    "ln_eps": float(bert.ln_emb.eps)}
