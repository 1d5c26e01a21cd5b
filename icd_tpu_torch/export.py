"""Export a checkpoint to the reference's ``.pth.tar`` format (port of
``icd_tpu/export.py``).

The inverse of ``convert``: takes a checkpoint dict of numpy trees (the
port's or icd_tpu's ``.ckpt``, or a converted ``.pth.tar``, as
``checkpoint.load_checkpoint`` returns it) and writes a whole-module
PyTorch checkpoint as the reference's ``save_checkpoint`` does
(reference: checkpoint.py:39-62): a dict of the pickled ``encoder`` and
``decoder`` modules themselves, the epoch, the metrics and the
optimizers. The unmodified reference code loads it (its ``eval.py``,
``gen_captions.py`` and ``--checkpoint`` resume); the decoder's Adam is
exported FRESH (its moments start empty).

The modules are the reference's own classes, imported from a checkout
of it (``reference_root``) with ``compat``'s stand-ins for torchvision,
pytorch_pretrained_bert and bcolz where those are not installed. A file
exported under a stand-in unpickles where the same stand-in (or, for
torchvision, the real package, whose layout it mirrors) is importable;
the port's own loader needs neither.

Layout inverses: convolution kernels HWIO -> OIHW, linears back to
(out, in), LSTM weights transposed back in PyTorch's (i, f, g, o) gate
order.
"""

import os

import numpy as np
import torch

# The resnet tree's stage names -> the index of torchvision's children in
# the reference encoders' nn.Sequential (encoder.py:36-38, 88-90).
_NAME_TO_SEQ = {"conv1": "0", "bn1": "1", "layer1": "4", "layer2": "5",
                "layer3": "6", "layer4": "7"}


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(_np(x)))


def _lin(tree):
    """{'w': (in, out), 'b': (out,)} -> torch Linear (weight, bias)."""
    return _t(_np(tree["w"]).T), _t(tree["b"])


def resnet_to_torch_state_dict(tree):
    """The backbone tree -> a torchvision-named state dict (the inverse of
    ``convert.resnet_from_torch_state_dict``)."""
    sd = {}

    def conv(name, k):
        sd[name] = _t(_np(k).transpose(3, 2, 0, 1))

    def bn(prefix, p):
        sd[prefix + ".weight"] = _t(p["scale"])
        sd[prefix + ".bias"] = _t(p["bias"])
        sd[prefix + ".running_mean"] = _t(p["mean"])
        sd[prefix + ".running_var"] = _t(p["var"])

    conv("conv1.weight", tree["stem"]["conv"])
    bn("bn1", tree["stem"]["bn"])
    for stage, blocks in enumerate(tree["layers"]):
        for b, block in enumerate(blocks):
            p = "layer{}.{}".format(stage + 1, b)
            for i in (1, 2, 3):
                conv("{}.conv{}.weight".format(p, i),
                     block["conv{}".format(i)])
                bn("{}.bn{}".format(p, i), block["bn{}".format(i)])
            if "downsample" in block:
                conv(p + ".downsample.0.weight", block["downsample"]["conv"])
                bn(p + ".downsample.1", block["downsample"]["bn"])
    return sd


def encoder_to_torch_state_dict(tree):
    """The encoder tree -> the reference Encoder/EncoderAttention state
    dict ('resnet.<sequential index>.' keys and the baseline's 'embed.'
    head)."""
    sd = {}
    for key, val in resnet_to_torch_state_dict(tree["resnet"]).items():
        top, _, rest = key.partition(".")
        sd["resnet.{}{}".format(_NAME_TO_SEQ[top],
                                "." + rest if rest else "")] = val
    if "embed" in tree:
        sd["embed.weight"], sd["embed.bias"] = _lin(tree["embed"])
    return sd


def _lstm_to_torch(tree, prefix):
    return {prefix + "weight_ih": _t(_np(tree["wi"]).T),
            prefix + "weight_hh": _t(_np(tree["wh"]).T),
            prefix + "bias_ih": _t(tree["bi"]),
            prefix + "bias_hh": _t(tree["bh"])}


def baseline_decoder_to_torch_state_dict(tree):
    sd = {"embedding.weight": _t(tree["embedding"])}
    # torch nn.LSTM names its first layer's tensors *_l0.
    sd.update({k + "_l0": v
               for k, v in _lstm_to_torch(tree["lstm"], "lstm.").items()})
    sd["linear.weight"], sd["linear.bias"] = _lin(tree["linear"])
    return sd


def attention_decoder_to_torch_state_dict(tree):
    sd = {"embedding.weight": _t(tree["embedding"])}
    for name in ("enc_att", "dec_att", "full_att"):
        w, b = _lin(tree["attention"][name])
        sd["attention.{}.weight".format(name)] = w
        sd["attention.{}.bias".format(name)] = b
    sd.update(_lstm_to_torch(tree["lstm"], "decode_step."))
    for name in ("h_lin", "c_lin", "f_beta", "fc"):
        sd["{}.weight".format(name)], sd["{}.bias".format(name)] = _lin(
            tree[name])
    return sd


def _reference_vocab():
    """The current ICD_TPU_ROOT vocabulary as an instance of the
    REFERENCE's ``Vocabulary`` (its AttentionDecoder checks the class,
    attention.py:84)."""
    import vocabulary as ref_vocab_mod  # resolved from the reference root

    from .vocabulary import load_vocab

    ours = load_vocab()
    ref = ref_vocab_mod.Vocabulary.__new__(ref_vocab_mod.Vocabulary)
    ref.w2i = dict(ours.w2i)
    ref.i2w = dict(ours.i2w)
    ref.idx = getattr(ours, "idx", len(ours.i2w))
    return ref


def _reference_modules(chkpt, model_type):
    """The reference's encoder and decoder modules for ``chkpt``'s trees,
    built by its constructors (export.py:186-222)."""
    import models.encoder as ref_encoder_mod

    cfg = chkpt.get("config") or {}
    dec_tree = chkpt["decoder"]
    vocab_size, embed_size = np.shape(dec_tree["embedding"])
    decoder_dim = cfg.get("decoder_dim") or int(
        np.shape(dec_tree["lstm"]["wh"])[0])
    # The reference encoders load resnet101 weights from disk or
    # torchvision (encoder.py:9-20) before every parameter is overwritten:
    # construct them from a random backbone instead.
    orig_loader = ref_encoder_mod._load_resnet101_model
    ref_encoder_mod._load_resnet101_model = (
        lambda: __import__("torchvision").models.resnet101(pretrained=False))
    try:
        if model_type == "baseline":
            import models.baseline as ref_baseline

            encoder = ref_encoder_mod.Encoder(int(embed_size))
            params = ref_baseline.BaselineDecoderParams()
            params.vocab_size = int(vocab_size)
            params.embed_size = int(embed_size)
            params.hidden_size = decoder_dim
            return encoder, ref_baseline.BaselineDecoder(params)
        import models.attention as ref_attention

        encoder = ref_encoder_mod.EncoderAttention()
        params = ref_attention.AttentionDecoderParams()
        params.embed_size = int(embed_size)
        params.decoder_dim = decoder_dim
        params.attention_dim = cfg.get("attention_dim") or int(
            np.shape(dec_tree["attention"]["enc_att"]["w"])[1])
        dropout = cfg.get("decoder_dropout")
        params.dropout = 0.5 if dropout is None else dropout
        params.use_bert = bool(cfg.get("use_bert", False))
        params.vocab = _reference_vocab()
        return encoder, ref_attention.AttentionDecoder(torch.device("cpu"),
                                                       params)
    finally:
        ref_encoder_mod._load_resnet101_model = orig_loader


def export_reference_checkpoint(chkpt, out_path, reference_root,
                                decoder_lr=4e-4):
    """Write ``chkpt`` (a checkpoint dict of numpy trees) as a reference
    whole-module ``.pth.tar`` at ``out_path``; ``reference_root`` is a
    checkout of the reference (its module classes), ``decoder_lr`` the
    rate of the exported fresh decoder Adam. The reference's modules are
    imported for this call only (``compat.install_reference_shims``,
    undone before returning). Returns ``out_path``."""
    from .compat import install_reference_shims, uninstall_reference_shims

    cfg = chkpt.get("config") or {}
    model_type = cfg.get("model") or (
        "attention" if "attention" in chkpt["decoder"] else "baseline")
    enc_sd = encoder_to_torch_state_dict(chkpt["encoder"])
    dec_sd = (baseline_decoder_to_torch_state_dict(chkpt["decoder"])
              if model_type == "baseline"
              else attention_decoder_to_torch_state_dict(chkpt["decoder"]))
    state = install_reference_shims(reference_root)
    try:
        encoder, decoder = _reference_modules(chkpt, model_type)
        for module, sd, what in ((encoder, enc_sd, "encoder"),
                                 (decoder, dec_sd, "decoder")):
            missing, unexpected = module.load_state_dict(sd, strict=False)
            if unexpected:
                raise ValueError("{}: unexpected keys {}".format(
                    what, unexpected))
            # Acceptable gaps: BN's num_batches_tracked counters, and the
            # frozen BERT the reference decoder builds itself
            # (attention.py:96-100), whose weights come from
            # from_pretrained, not the checkpoint.
            leftover = [k for k in missing
                        if not k.endswith("num_batches_tracked")
                        and not k.startswith(("bert.", "bert_model."))]
            if leftover:
                raise ValueError("{}: missing keys {}".format(what, leftover))
        encoder.eval()
        decoder.eval()
        dec_params = [p for p in decoder.parameters() if p.requires_grad]
        decoder_optimizer = (torch.optim.Adam(dec_params, lr=decoder_lr)
                             if dec_params else None)
        out_dir = os.path.dirname(os.path.abspath(out_path))
        os.makedirs(out_dir, exist_ok=True)
        torch.save({"epoch": chkpt.get("epoch", 0),
                    "metrics": chkpt.get("metrics", {}),
                    "encoder": encoder, "decoder": decoder,
                    "encoder_optimizer": None,
                    "decoder_optimizer": decoder_optimizer}, out_path)
    finally:
        uninstall_reference_shims(state)
    return out_path
