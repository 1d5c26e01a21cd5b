"""Bahdanau soft-attention LSTM decoder
(port of ``icd_tpu/models/attention.py:34-243``; reference:
models/attention.py:18-284).

Parameter names follow the JAX tree: ``attention.enc_att``,
``attention.dec_att``, ``attention.full_att``, ``lstm``, ``h_lin``,
``c_lin``, ``f_beta``, ``fc`` and ``embedding``, each an ``nn.Linear``,
``nn.LSTMCell`` or ``nn.Embedding`` (``params.py`` maps the layouts).
``decode_step`` takes its attention and gate from K1
(``ops/fused_attention.py``). The teacher-forced forward that training
and eval differentiate and run, ``attention_decoder_forward``, is plain
PyTorch under autograd: K1 computes no backward, and the JAX scan does
not call it either.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.fused_attention import fused_attention
from .baseline import VocabProjection
from .baseline import load_pretrained_embeddings  # noqa: F401 (attention.py:79)
from .encoder import ENCODER_DIM
from .lstm import gates_to_state, init_lstm, lstm_cell


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
        self.fc = VocabProjection(decoder_dim, vocab_size)
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


def attention_decoder_forward(decoder, encoder_out, captions, decode_lengths,
                              generator=None, dropout_rate=0.0,
                              embeddings=None, mask_rows=None):
    """Teacher-forced forward over the whole batch (attention.py:144).

    Args:
        encoder_out: (B, gh, gw, D) or (B, P, D) encoder grid.
        captions: (B, T) token ids.
        decode_lengths: (B,) int tensor, caption_lengths - 1.
        generator: a ``torch.Generator`` on ``encoder_out``'s device that
            draws the dropout mask (None disables dropout: eval mode).
        embeddings: optional (B, T + 1, E) caption embeddings (the BERT
            path, attention.py:242-247), whose first T - 1 rows replace
            the decoder's table lookup; the table by default.
        mask_rows: (rows, n) when the batch is ``rows`` of a global batch
            of n (a rank's data shard): the dropout mask is drawn for the
            n rows and these rows kept, so that the ranks of a mesh drop
            what one device would (``dropout``).

    Returns (predictions (B, T - 1, V), alphas (B, T - 1, P)), zero at
    the steps past a row's decode length; a row that has retired keeps
    its h and c. As in the JAX scan, the embedding half of the LSTM
    input product (biases folded in) runs once before the loop, the
    three products that read h are one product, and dropout and the fc
    product run once on the stacked states after it.
    """
    if encoder_out.dim() == 4:
        encoder_out = encoder_out.reshape(encoder_out.shape[0], -1,
                                          encoder_out.shape[-1])
    att, lstm = decoder.attention, decoder.lstm
    att_enc = F.linear(encoder_out, att.enc_att.weight) + att.enc_att.bias
    if embeddings is None:
        embeddings = decoder.embedding(captions)
    steps = captions.shape[1] - 1
    h, c = init_hidden_state(decoder, encoder_out)

    e = embeddings.shape[-1]
    emb_x = (F.linear(embeddings[:, :steps], lstm.weight_ih[:, :e])
             + (lstm.bias_ih + lstm.bias_hh))
    w_x_enc = lstm.weight_ih[:, e:]
    sizes = [att.dec_att.out_features, decoder.f_beta.out_features,
             lstm.weight_hh.shape[0]]
    w_h = torch.cat([att.dec_att.weight, decoder.f_beta.weight,
                     lstm.weight_hh])
    b_h = torch.cat([att.dec_att.bias, decoder.f_beta.bias,
                     torch.zeros_like(lstm.bias_hh)])
    w_full, b_full = att.full_att.weight[0], att.full_att.bias[0]
    active = (torch.arange(steps, device=decode_lengths.device)[None, :]
              < decode_lengths[:, None])  # (B, T - 1)

    hs, alphas = [], []
    for t in range(steps):
        att_dec, gate_pre, h_gates = (F.linear(h, w_h) + b_h).split(sizes,
                                                                     -1)
        act = torch.relu(att_enc + att_dec[:, None, :])
        scores = ((act * w_full).sum(-1, dtype=torch.float32)
                  + b_full).to(act.dtype)
        alpha = torch.softmax(scores, dim=-1)
        weighted = torch.bmm(alpha[:, None, :], encoder_out)[:, 0]
        weighted = torch.sigmoid(gate_pre) * weighted
        gates = emb_x[:, t] + F.linear(weighted, w_x_enc) + h_gates
        new_h, new_c = gates_to_state(gates, c)
        on = active[:, t, None]
        h = torch.where(on, new_h, h)
        c = torch.where(on, new_c, c)
        hs.append(h)
        alphas.append(torch.where(on, alpha, 0.0))

    out = torch.stack(hs, dim=1)  # (B, T - 1, H)
    if generator is not None and dropout_rate > 0.0:
        out = dropout(out, dropout_rate, generator, mask_rows)
    preds = decoder.fc(out)
    preds = torch.where(active[..., None], preds, 0.0)
    return preds, torch.stack(alphas, dim=1)


def dropout(x, rate, generator, mask_rows=None):
    """Zero each element with probability ``rate`` and scale the rest by
    1 / (1 - rate) (attention.py:235-237), the mask drawn from
    ``generator``, which must live on ``x``'s device. With ``mask_rows``
    = (rows, n) the mask is drawn for n rows and ``x`` takes ``rows`` of
    it, as JAX draws one mask for the global batch."""
    rows, n = (slice(None), x.shape[0]) if mask_rows is None else mask_rows
    keep = torch.rand((n,) + tuple(x.shape[1:]), generator=generator,
                      device=x.device, dtype=x.dtype)[rows] < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)
