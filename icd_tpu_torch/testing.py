"""Random decoders that finish their captions, for the card tests and
``chip_smoke.py``.

A random decoder never emits ``<end>`` among thousands of near-equal
logits, so every beam search would run to its step limit. ``steer_end``
gives one LSTM unit the job of counting steps and makes it the only
input of the ``<end>`` logit, so captions end after a number of steps
that depends on the image.
"""

import math

import torch

from .models.attention import AttentionDecoderParams, init_attention_decoder


def steer_end(decoder, end_id, rate=0.05, spread=0.1, threshold=20.0,
              unit=0):
    """Steer ``decoder`` in place: LSTM unit ``unit`` counts steps (i, f, o
    gates open, c from 0, g = tanh(atanh(rate) + spread * ctx . w) with w a
    zero-mean unit vector) and is the only input of the <end> logit,
    40 * h_unit - threshold."""
    hd = decoder.lstm.hidden_size
    emb = decoder.embedding.embedding_dim
    i, f, g, o = (gate * hd + unit for gate in range(4))
    lstm = decoder.lstm
    with torch.no_grad():
        lstm.weight_ih[[i, f, o]] = 0.0
        lstm.weight_hh[[i, f, g, o]] = 0.0
        lstm.bias_ih[[i, f, o]] = 10.0
        lstm.bias_hh[[i, f, g, o]] = 0.0
        w = lstm.weight_ih[g, emb:]
        w = w - w.mean()  # blind to the grid's common offset
        lstm.weight_ih[g, emb:] = spread * w / w.norm()
        lstm.weight_ih[g, :emb] = 0.0
        lstm.bias_ih[g] = math.atanh(rate)
        decoder.c_lin.weight[unit] = 0.0
        decoder.c_lin.bias[unit] = 0.0
        decoder.fc.weight[end_id] = 0.0
        decoder.fc.weight[end_id, unit] = 40.0
        decoder.fc.bias[end_id] = -threshold


def steered_decoder(vocab, att, dec, emb, enc, seed, device=None):
    """A small random decoder from ``seed``, steered to finish captions
    (<end> is vocab - 2)."""
    params = AttentionDecoderParams()
    params.attention_dim, params.decoder_dim = att, dec
    params.embed_size, params.vocab = emb, range(vocab)
    decoder = init_attention_decoder(torch.Generator().manual_seed(seed),
                                     params, encoder_dim=enc, device=device)
    steer_end(decoder, vocab - 2, rate=0.1, spread=1.0)
    return decoder
