"""Bahdanau soft-attention LSTM decoder, inference step
(port of ``icd_tpu/models/attention.py:34-141``; reference:
models/attention.py:18-284).

Parameter names follow the JAX tree: ``attention.enc_att``,
``attention.dec_att``, ``attention.full_att``, ``lstm``, ``h_lin``,
``c_lin``, ``f_beta``, ``fc`` and ``embedding``, each an ``nn.Linear``,
``nn.LSTMCell`` or ``nn.Embedding`` (``params.py`` maps the layouts).
``decode_step`` takes its attention and gate from K1
(``ops/fused_attention.py``). The teacher-forced forward comes with the
training slice.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.fused_attention import fused_attention
from .encoder import ENCODER_DIM
from .lstm import init_lstm, lstm_cell


class AttentionDecoderParams:
    """Hyperparameters (reference: models/attention.py:64-70)."""

    attention_dim = 512
    decoder_dim = 512
    embed_size = 512  # Use 300 if glove and 768 if BERT.
    dropout = 0.5
    use_bert = False
    vocab = None  # Must override.


class Attention(nn.Module):
    def __init__(self, encoder_dim, decoder_dim, attention_dim):
        super().__init__()
        self.enc_att = nn.Linear(encoder_dim, attention_dim)
        self.dec_att = nn.Linear(decoder_dim, attention_dim)
        self.full_att = nn.Linear(attention_dim, 1)


class AttentionDecoder(nn.Module):
    def __init__(self, vocab_size, attention_dim=512, decoder_dim=512,
                 embed_size=512, encoder_dim=ENCODER_DIM):
        super().__init__()
        self.attention = Attention(encoder_dim, decoder_dim, attention_dim)
        self.lstm = nn.LSTMCell(embed_size + encoder_dim, decoder_dim)
        self.h_lin = nn.Linear(encoder_dim, decoder_dim)
        self.c_lin = nn.Linear(encoder_dim, decoder_dim)
        self.f_beta = nn.Linear(decoder_dim, encoder_dim)
        self.fc = nn.Linear(decoder_dim, vocab_size)
        self.embedding = nn.Embedding(vocab_size, embed_size)

    @property
    def vocab_size(self):
        return self.fc.out_features


def _uniform(generator, shape, bound):
    return torch.rand(shape, generator=generator) * (2 * bound) - bound


def init_attention_decoder(generator, params, encoder_dim=ENCODER_DIM,
                           dtype=torch.float32, device=None):
    """Random-init the decoder (attention.py:48), from ``generator`` on
    the CPU: Linear layers U(+-1/sqrt(in)), the LSTM U(+-1/sqrt(H)),
    fc weight and embedding U(+-0.1), fc bias zero
    (reference: attention.py:120-121)."""
    assert isinstance(params, AttentionDecoderParams)
    assert params.vocab is not None and hasattr(params.vocab, "__len__")
    device = resolve_device(device)
    with torch.device("meta"):
        dec = AttentionDecoder(len(params.vocab), params.attention_dim,
                               params.decoder_dim, params.embed_size,
                               encoder_dim)
    dec = dec.to_empty(device="cpu")
    with torch.no_grad():
        for lin in (dec.attention.enc_att, dec.attention.dec_att,
                    dec.attention.full_att, dec.h_lin, dec.c_lin,
                    dec.f_beta):
            bound = 1.0 / math.sqrt(lin.in_features)
            lin.weight.copy_(_uniform(generator, lin.weight.shape, bound))
            lin.bias.copy_(_uniform(generator, lin.bias.shape, bound))
        dec.lstm = init_lstm(generator, dec.lstm.input_size,
                             dec.lstm.hidden_size)
        dec.fc.weight.copy_(_uniform(generator, dec.fc.weight.shape, 0.1))
        dec.fc.bias.zero_()
        dec.embedding.weight.copy_(
            _uniform(generator, dec.embedding.weight.shape, 0.1))
    return dec.to(device=device, dtype=dtype)


def soft_attention(attention, encoder_out, h, att_enc=None):
    """Additive attention over pixels (attention.py:84; reference:
    attention.py:43-61): (weighted encoding (B, D), alpha (B, P)).

    The JAX package's plain path: scores are rounded to the activation
    dtype and the softmax is taken there. ``decode_step`` uses K1
    instead, whose softmax is f32; the two agree in f32.
    """
    if att_enc is None:
        att_enc = attention.enc_att(encoder_out)
    att_dec = attention.dec_att(h)
    act = torch.relu(att_enc + att_dec[..., None, :])
    scores = ((act * attention.full_att.weight[0]).sum(-1, dtype=torch.float32)
              + attention.full_att.bias[0]).to(act.dtype)
    alpha = torch.softmax(scores, dim=-1)
    weighted = (encoder_out * alpha[..., None]).sum(-2)
    return weighted, alpha


def init_hidden_state(decoder, encoder_out):
    """h, c from the mean pixel feature (attention.py:113; reference:
    attention.py:151-164)."""
    mean_enc = encoder_out.mean(dim=1)
    return decoder.h_lin(mean_enc), decoder.c_lin(mean_enc)


def decode_step(decoder, encoder_out, att_enc, emb_t, h, c,
                rows_per_image=1):
    """One decode step: attention -> gate -> LSTMCell -> fc
    (attention.py:121; reference: gen_captions.py:64-74), eval mode.

    ``encoder_out`` (B, P, D) and ``att_enc`` (B, P, A) hold one grid per
    image; ``emb_t``, ``h`` and ``c`` hold ``rows_per_image`` rows per
    image (the beams), row r reading image r // rows_per_image.
    Returns (h, c, logits, alpha (rows, P) f32).
    """
    att = decoder.attention
    weighted, alpha = fused_attention(
        encoder_out, att_enc, h,
        att.dec_att.weight, att.dec_att.bias,
        att.full_att.weight[0], att.full_att.bias,
        decoder.f_beta.weight, decoder.f_beta.bias,
        rows_per_image=rows_per_image)
    x = torch.cat([emb_t, weighted], dim=-1)
    h, c = lstm_cell(decoder.lstm, x, h, c)
    preds = F.linear(h, decoder.fc.weight, decoder.fc.bias)
    return h, c, preds, alpha
