"""Baseline LSTM decoder (port of ``icd_tpu/models/baseline.py``;
reference: models/baseline.py:19-111).

The image feature vector is timestep 0 of the LSTM's input, followed by
the embedded caption minus its last token; a Linear projects each
output to vocab logits. Parameter names follow the JAX tree:
``embedding`` (``nn.Embedding``), ``lstm`` (``nn.LSTMCell``, stepped by
``lstm.lstm_cell`` in the JAX package's gate and bias order) and
``linear`` (``VocabProjection``, an ``nn.Linear``; ``params.py`` maps
the layouts).
"""

import copy
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device
from .lstm import init_lstm, lstm_scan


class BaselineDecoderParams:
    """Hyperparameters (reference: models/baseline.py:19-22)."""

    hidden_size = 512
    embed_size = 512  # Use 300 if glove.
    vocab_size = None  # Must override.


class VocabProjection(nn.Linear):
    """The decoders' output projection to vocab logits: x W^T + b as two
    operations, as JAX's ``x @ w + b`` (in bf16 ``F.linear`` with a bias
    would add it before the product's one rounding). The teacher-forced
    forwards call it as a module, so that ``parallel/vocab.py`` can put
    a vocab-parallel projection in its place."""

    def forward(self, x):
        return F.linear(x, self.weight) + self.bias


class BaselineDecoder(nn.Module):
    def __init__(self, vocab_size, embed_size=512, hidden_size=512):
        super().__init__()
        self.embedding = nn.Embedding(vocab_size, embed_size)
        self.lstm = nn.LSTMCell(embed_size, hidden_size)
        self.linear = VocabProjection(hidden_size, vocab_size)


def init_baseline_decoder(generator, params, dtype=torch.float32,
                          device=None):
    """Random-init the decoder with torch's defaults (baseline.py:27), from
    ``generator`` on the CPU: embedding N(0, 1), the LSTM and the Linear
    U(+-1/sqrt(H))."""
    assert params.vocab_size is not None
    device = resolve_device(device)
    v, e, h = params.vocab_size, params.embed_size, params.hidden_size
    with torch.device("meta"):
        dec = BaselineDecoder(v, e, h)
    dec = dec.to_empty(device="cpu")
    bound = 1.0 / math.sqrt(h)
    with torch.no_grad():
        dec.embedding.weight.copy_(torch.randn((v, e), generator=generator))
        dec.lstm = init_lstm(generator, e, h)
        for p in (dec.linear.weight, dec.linear.bias):
            p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound)
                    - bound)
    return dec.to(device=device, dtype=dtype)


def load_pretrained_embeddings(decoder, embeddings):
    """A copy of ``decoder`` with a pretrained embedding table (GloVe)
    swapped in (baseline.py:44; reference: baseline.py:59-66), as f32,
    which is what ``jnp.asarray`` makes of a float64 table."""
    out = copy.deepcopy(decoder)
    table = torch.from_numpy(np.array(embeddings, dtype=np.float32))
    out.embedding.weight.data = table.to(out.embedding.weight.device)
    return out


def baseline_decoder_forward(decoder, img_features, captions):
    """Teacher-forced forward (baseline.py:50), eval mode.

    img_features: (B, embed_size); captions: (B, T) token ids.
    Returns (B, T, vocab_size) logits; logits[:, t] predicts captions[:, t]
    (t = 0 from the image feature alone).
    """
    emb = decoder.embedding(captions[:, :-1])
    xs = torch.cat([img_features[:, None, :].to(emb.dtype), emb], dim=1)
    outs, _ = lstm_scan(decoder.lstm, xs)
    return decoder.linear(outs)
